"""Serve-loop throughput benchmark.

Drives `psa --serve` as a real subprocess through OS pipes: writes B query
lines, reads B result lines, reports end-to-end queries/s — the number a
network front-end layered on the serve protocol would see (parse + batched
search + format + pipe transport), as opposed to batch_bench.py's
device-path-only figure.

A sample of replies is verified against the exact host oracle.

Usage: python benchmarks/serve_bench.py [--batch 1000] [--n1 2048]
         [--n2 512] [--backend auto] [--verify 8]
       python benchmarks/serve_bench.py --tcp 8 ...   # N concurrent TCP
         clients against `psa --serve --listen` (cross-client batching)
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1000)
    ap.add_argument("--n1", type=int, default=2048)
    ap.add_argument("--n2", type=int, default=512)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--serve-batch", type=int, default=256)
    ap.add_argument("--verify", type=int, default=8)
    ap.add_argument("--platform", default=None,
                    help="forwarded to psa --platform (e.g. cpu)")
    ap.add_argument("--tcp", type=int, default=0, metavar="NCLIENTS",
                    help="drive the TCP tier (--serve --listen) with this "
                         "many concurrent socket clients instead of one "
                         "stdin pipe")
    ap.add_argument("--closed-loop", action="store_true",
                    help="TCP clients send one query at a time and wait for "
                         "its reply — measures per-query service latency "
                         "(p50/p99) under N concurrent clients instead of "
                         "offered-load throughput")
    ap.add_argument("--cold-inject", type=int, default=0, metavar="N",
                    help="closed-loop only: inject N queries of a fresh "
                         "never-compiled shape bucket (n1+1024 x n2) spread "
                         "through the timed wave — measures cold-bucket tail "
                         "latency under the warmup + host-routing machinery "
                         "(replies must come from the host engine instead of "
                         "waiting out a compile)")
    ap.add_argument("--shared-s1", action="store_true",
                    help="every query uses ONE shared Seq1 (the many-reads-"
                         "vs-one-reference pattern): the serve path then "
                         "ships Seq1 once per microbatch instead of per "
                         "query (models/batch.pack_query_inputs_shared)")
    args = ap.parse_args()

    if args.cold_inject and not (args.tcp and args.closed_loop):
        ap.error("--cold-inject requires --tcp N --closed-loop (throughput "
                 "modes would silently mix host-routed cold replies into "
                 "the q/s number with no breakdown)")

    from psa.utils.generator import random_sequences

    B, n1, n2 = args.batch, args.n1, args.n2
    log(f"[serve_bench] generating {B} query lines ({n1}x{n2})")
    lines = []
    s1_fixed = (random_sequences(n1, n2, seed=999_999)[0]
                if args.shared_s1 else None)
    for s in range(B):
        s1, s2 = random_sequences(n1, n2, seed=s)
        if s1_fixed is not None:
            s1 = s1_fixed
        lines.append(f"1 3 4 2 {s1} {s2} minimum")
    payload = "\n".join(lines) + "\n"

    cmd = [sys.executable, "-m", "psa.utils.cli", "--serve", "--quiet",
           "--serve-batch", str(args.serve_batch),
           "--backend", args.backend]
    if args.platform:
        cmd += ["--platform", args.platform]

    if args.tcp:
        return run_tcp(args, cmd, lines)

    # ONE persistent server process: a warm wave pays process startup and
    # compiles, then the timed wave measures steady-state serving.
    import collections
    import threading

    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, bufsize=1)
    replies: list[str] = []
    got = threading.Event()
    want_n = [0]
    err_tail = collections.deque(maxlen=40)   # keep stderr drained (a full
                                              # 64KB pipe would deadlock the
                                              # server mid-write)

    def reader():
        for ln in proc.stdout:
            replies.append(ln.rstrip("\n"))
            if len(replies) >= want_n[0]:
                got.set()
        got.set()                             # EOF: wake waiters (dead server)

    def err_reader():
        for ln in proc.stderr:
            err_tail.append(ln.rstrip("\n"))

    threading.Thread(target=reader, daemon=True).start()
    threading.Thread(target=err_reader, daemon=True).start()

    def wave(tag, wave_lines, timeout_s=3600.0):
        want_n[0] = len(replies) + len(wave_lines)
        got.clear()
        if len(replies) >= want_n[0]:
            got.set()
        t0 = time.perf_counter()
        proc.stdin.write("\n".join(wave_lines) + "\n")
        proc.stdin.flush()
        deadline = t0 + timeout_s
        while len(replies) < want_n[0]:
            if not got.wait(min(5.0, max(0.1, deadline - time.perf_counter()))):
                if proc.poll() is not None or time.perf_counter() > deadline:
                    break
            got.clear()
        if len(replies) < want_n[0]:
            why = ("server exited rc=%s" % proc.poll()
                   if proc.poll() is not None else "timed out")
            proc.kill()
            log(f"[serve_bench] {tag} wave {why}; server stderr tail:")
            for ln in list(err_tail)[-20:]:
                log("  " + ln)
            sys.exit(1)
        dt = time.perf_counter() - t0
        log(f"[serve_bench] {tag}: {len(wave_lines)} queries in {dt:.2f}s "
            f"({len(wave_lines)/dt:.0f} q/s)")
        return dt

    wave("warm (startup+compile)", lines[: max(1, B // 4)])
    dt = wave("timed", lines)
    nq = len(lines)
    proc.stdin.close()
    proc.wait(timeout=60)
    out = replies[-nq:]

    n_bad = 0
    if args.verify:
        from psa.models.search import AlignmentSearchEngine

        from psa.core.result import NoMutationFound

        eng = AlignmentSearchEngine(np.array([1.0, 3.0, 4.0, 2.0]), False,
                                    backend="native")
        idxs = np.linspace(0, B - 1, min(args.verify, B)).astype(int)
        for i in idxs:
            toks = lines[i].split()
            try:
                res = eng.search(toks[4], toks[5])
                want = "%d %g %s" % (res.offset, res.score,
                                     res.mutant(toks[5]))
            except NoMutationFound:
                want = "-1 %g %s" % (float("inf"), toks[5])
            if out[i] != want:
                n_bad += 1
                log(f"[serve_bench] MISMATCH query {i}:\n got {out[i][:80]}\n"
                    f" want {want[:80]}")
        log(f"[serve_bench] verified {len(idxs)} replies, {n_bad} mismatches")

    print(json.dumps({
        "metric": "serve_queries_per_sec",
        "value": nq / dt,
        "unit": "q/s",
        "detail": {"batch": B, "n1": n1, "n2": n2,
                   "serve_batch": args.serve_batch,
                   "backend": args.backend,
                   "verified": int(args.verify), "mismatches": n_bad},
    }))
    sys.exit(1 if n_bad else 0)


def run_tcp(args, cmd, lines):
    """TCP-tier wave bench: N concurrent clients split the workload; the
    server coalesces their lines into shared device batches.  Reports the
    aggregate q/s a fleet of low-rate clients would see."""
    import collections
    import signal
    import socket
    import subprocess
    import threading

    proc = subprocess.Popen(cmd + ["--listen", "127.0.0.1:0"],
                            stderr=subprocess.PIPE, text=True)
    announce = proc.stderr.readline()
    assert "listening on" in announce, announce
    port = int(announce.rsplit(":", 1)[1])
    err_tail = collections.deque(maxlen=40)
    threading.Thread(
        target=lambda: err_tail.extend(ln.rstrip("\n") for ln in proc.stderr),
        daemon=True).start()
    log(f"[serve_bench] TCP server on port {port}, {args.tcp} clients")

    def client(shard, out, lats):
        s = socket.create_connection(("127.0.0.1", port), timeout=3600)
        if args.closed_loop:
            # one query in flight per client: per-query service latency.
            # shard entries are (line, is_cold) so cold-injected queries'
            # latencies can be reported separately.
            f = s.makefile("rw", newline="\n")
            for q, cold in shard:
                t0 = time.perf_counter()
                f.write(q + "\n")
                f.flush()
                r = f.readline()
                lats.append((time.perf_counter() - t0, cold))
                out.append(r.rstrip("\n"))
            f.close()
            s.close()
            return
        s.sendall(("\n".join(q for q, _ in shard) + "\n").encode())
        s.shutdown(socket.SHUT_WR)
        buf = b""
        while True:
            d = s.recv(1 << 16)
            if not d:
                break
            buf += d
        s.close()
        out.extend(buf.decode().splitlines())

    all_lats: list = []

    def wave(tag, wave_lines):
        # normalize to (line, is_cold) entries
        wave_lines = [q if isinstance(q, tuple) else (q, False)
                      for q in wave_lines]
        shards = [wave_lines[i::args.tcp] for i in range(args.tcp)]
        outs = [[] for _ in shards]
        lats: list = []
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(sh, o, lats))
                   for sh, o in zip(shards, outs) if sh]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0
        all_lats[:] = lats
        n = sum(len(o) for o in outs)
        log(f"[serve_bench] {tag}: {n} replies from {len(threads)} clients "
            f"in {dt:.2f}s ({n/dt:.0f} q/s)")
        if n != len(wave_lines):
            log(f"[serve_bench] reply count mismatch ({n} != "
                f"{len(wave_lines)}); server stderr tail:")
            for ln in list(err_tail)[-20:]:
                log("  " + ln)
            proc.kill()
            sys.exit(1)
        return dt, shards, outs

    B = len(lines)
    timed = [(q, False) for q in lines]
    if args.cold_inject:
        from psa.utils.generator import random_sequences as _rs

        # a fresh (n1+1024, n2) shape = a new padded bucket the server has
        # never compiled; spread the injections through the middle of the
        # timed wave so they land in steady-state traffic
        cold_lines = []
        for s in range(args.cold_inject):
            s1, s2 = _rs(args.n1 + 1024, args.n2, seed=10_000 + s)
            cold_lines.append((f"1 3 4 2 {s1} {s2} minimum", True))
        step = max(1, len(timed) // (len(cold_lines) + 1))
        for j, cl in enumerate(cold_lines):
            timed.insert(min(len(timed), (j + 1) * step + j), cl)
    wave("warm (startup+compile)", lines[: max(1, B // 4)])
    dt, shards, outs = wave("timed", timed)
    B = len(timed)

    n_bad = 0
    if args.verify:
        from psa.core.result import NoMutationFound
        from psa.models.search import AlignmentSearchEngine

        eng = AlignmentSearchEngine(np.array([1.0, 3.0, 4.0, 2.0]), False,
                                    backend="native")
        per = max(1, args.verify // max(1, len(shards)))
        checked = 0
        for sh, o in zip(shards, outs):
            idxs = set(np.linspace(0, len(sh) - 1,
                                   min(per, len(sh))).astype(int).tolist())
            # always verify every cold-injected reply: the host-routed
            # fallback must be bit-identical, not just fast
            idxs |= {i for i, (_, cold) in enumerate(sh) if cold}
            for i in sorted(idxs):
                toks = sh[i][0].split()
                try:
                    res = eng.search(toks[4], toks[5])
                    want = "%d %g %s" % (res.offset, res.score,
                                         res.mutant(toks[5]))
                except NoMutationFound:
                    want = "-1 %g %s" % (float("inf"), toks[5])
                checked += 1
                if o[i] != want:
                    n_bad += 1
                    log(f"[serve_bench] MISMATCH client shard reply {i}:\n"
                        f" got {o[i][:80]}\n want {want[:80]}")
        log(f"[serve_bench] verified {checked} replies, {n_bad} mismatches")

    proc.send_signal(signal.SIGTERM)
    proc.wait(timeout=30)
    detail = {"batch": B, "n1": args.n1, "n2": args.n2,
              "clients": args.tcp, "serve_batch": args.serve_batch,
              "backend": args.backend, "mismatches": n_bad}
    if args.closed_loop and all_lats:
        def _pct(ms):
            return {"p50": round(float(np.percentile(ms, 50)), 2),
                    "p90": round(float(np.percentile(ms, 90)), 2),
                    "p99": round(float(np.percentile(ms, 99)), 2),
                    "mean": round(float(np.mean(ms)), 2),
                    "max": round(float(np.max(ms)), 2),
                    "n": int(len(ms))}

        ms = np.asarray([lt for lt, _ in all_lats]) * 1e3
        detail["latency_ms"] = _pct(ms)
        if args.cold_inject:
            cold_ms = np.asarray([lt for lt, c in all_lats if c]) * 1e3
            if cold_ms.size:
                detail["cold_bucket_latency_ms"] = _pct(cold_ms)
                log(f"[serve_bench] cold-bucket p50/max = "
                    f"{detail['cold_bucket_latency_ms']['p50']}/"
                    f"{detail['cold_bucket_latency_ms']['max']} ms "
                    f"({cold_ms.size} injected)")
        log(f"[serve_bench] closed-loop latency p50/p90/p99 = "
            f"{detail['latency_ms']['p50']}/{detail['latency_ms']['p90']}/"
            f"{detail['latency_ms']['p99']} ms")
    print(json.dumps({
        "metric": ("serve_tcp_closed_loop" if args.closed_loop
                   else "serve_tcp_queries_per_sec"),
        "value": B / dt,
        "unit": "q/s",
        "detail": detail,
    }))
    sys.exit(1 if n_bad else 0)


if __name__ == "__main__":
    main()
