"""Command-line driver.

Replaces the reference's main.c + orchestrator (main.c:13-56,
cpu_funcs.c:25-121): read input, search, write output, print the wall time.
The reference's single runtime flag (argv[1] = cuda_percentage,
main.c:30-42) maps to `--backend` for engine selection, plus
`--device-share PCT` for its literal semantics: a concurrent host+device
split of each query's offset range (cpu_funcs.c:144-150), with -100 =
sequential oracle mode (main.c:33-37).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="psa",
        description="mutant-alignment search "
                    "(best single-substitution alignment of Seq2 under Seq1)",
    )
    from psa.config import CONFIG

    p.add_argument("input", nargs="?", default=CONFIG.default_input,
                   help="input file: 4 weights, Seq1, Seq2, maximum|minimum "
                        "(default ./input.txt, like the reference def.h:20)")
    p.add_argument("-o", "--output", default=CONFIG.default_output,
                   help="output file (default ./output.txt)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "numpy", "xla", "conv", "pallas",
                            "native", "hybrid"],
                   help="compute path (auto = native below the workload "
                        "threshold, else the pallas device kernel on a GPU; "
                        "pallas needs a GPU; hybrid = concurrent host+device "
                        "offset split)")
    p.add_argument("--device-share", type=float, default=None, metavar="PCT",
                   help="the reference's cuda_percentage argv (main.c:30-42): "
                        "the accelerator takes the FIRST PCT%% of offsets, "
                        "the C++/OpenMP host engine the rest IN PARALLEL "
                        "(cpu_funcs.c:144-150); -100 = sequential oracle "
                        "mode (1 thread, host only). Implies "
                        "--backend hybrid.")
    p.add_argument("--sharded", action="store_true",
                   help="shard the offset axis over all local devices")
    p.add_argument("--explain", action="store_true",
                   help="render the winning alignment with signs and the "
                        "mutation highlighted (reference pretty_print)")
    p.add_argument("--lenient", action="store_true",
                   help="accept characters outside A-Z/'-' (treated as "
                        "score-0, non-substitutable, like the reference's "
                        "defined out-of-range behavior)")
    p.add_argument("--print-table", action="store_true",
                   help="print the 27x27 sign matrix (reference print_hash)")
    p.add_argument("--threads", type=int, default=0,
                   help="native-backend thread count (1 = the reference's "
                        "sequential `runseq` oracle mode; 0 = all cores)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process run (the reference's `make run` = "
                        "mpiexec, Makefile:18-22): join the jax.distributed "
                        "pod, process 0 reads/writes files, the query "
                        "broadcasts, the offset axis shards over the global "
                        "mesh. Launch via psa-dist or one process per host.")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="jax.distributed coordinator address (e.g. "
                        "localhost:PORT; psa-dist passes it)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total process count for --distributed")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank for --distributed")
    p.add_argument("--local-device-id", type=int, default=None,
                   help="with --distributed: the one local GPU this rank "
                        "opens (psa-dist passes the rank's card)")
    p.add_argument("--platform", default=None,
                   help="force a JAX platform (e.g. cpu) before any device "
                        "use — needed where jax_platforms is pre-pinned")
    p.add_argument("--case", type=int, default=None, metavar="N",
                   help="run the N-th embedded case record of a scratchpad "
                        "input file (the reference's input.txt embeds extra "
                        "cases as leftover tokens, input.txt:6+; N=0 is the "
                        "record the reference itself would run)")
    p.add_argument("--batch", action="store_true",
                   help="run EVERY embedded case record: queries are bucketed "
                        "by padded shape and streamed through the batched "
                        "device path; -o names a directory receiving "
                        "out_0000.txt, out_0001.txt, ...")
    p.add_argument("--serve", action="store_true",
                   help="streaming serve mode: read one query per stdin line "
                        "(the 7 input-file tokens: 4 weights, Seq1, Seq2, "
                        "mode), write one result line per query to stdout in "
                        "order. Immediately-available lines coalesce into one "
                        "batched device dispatch (up to --serve-batch); a "
                        "malformed line yields an `error ...` line and the "
                        "server keeps going. The input file and -o are "
                        "ignored.")
    p.add_argument("--serve-batch", type=int, default=256, metavar="N",
                   help="max queries coalesced into one dispatch in --serve "
                        "mode (default 256)")
    p.add_argument("--warmup", metavar="FILE", default=None,
                   help="with --serve: pre-compile the device runners for "
                        "the (weights, shape-bucket)s of the query lines in "
                        "FILE before serving starts, so those buckets never "
                        "pay a cold compile inside the reply path (unwarmed "
                        "buckets answer from the host engine while a "
                        "background thread compiles them). By default only "
                        "the "
                        "FULL-chunk batch size is compiled (see "
                        "--warmup-sizes): partial or trickle chunks dispatch "
                        "at smaller power-of-two batch sizes and still pay "
                        "one background compile each on first hit")
    p.add_argument("--warmup-sizes", default="chunk", metavar="SPEC",
                   help="batch sizes to pre-compile per --warmup bucket: "
                        "`chunk` (default: one full --serve-batch chunk — "
                        "cheapest, covers saturated traffic), `ladder` "
                        "(every power of two 1..chunk — covers partial and "
                        "trickle chunks too, at one compile per size), or a "
                        "comma list of sizes (e.g. `64,256`)")
    p.add_argument("--listen", default=None, metavar="HOST:PORT",
                   help="with --serve: answer TCP connections instead of "
                        "stdin — one event loop serves every client, and "
                        "lines from ALL connections coalesce into shared "
                        "device batches (continuous batching); replies "
                        "return per connection in its send order. PORT 0 "
                        "binds an ephemeral port (announced on stderr). "
                        "Same line protocol as stdin serve.")
    p.add_argument("--json", action="store_true",
                   help="print one JSON object per case to stdout (offset, "
                        "char position, substitute, score, mutant, time) "
                        "instead of the reference-style time trailer; output "
                        "files are still written")
    p.add_argument("--trace", metavar="LOGDIR", default=None,
                   help="capture a jax.profiler device trace into LOGDIR")
    p.add_argument("--quiet", action="store_true", help="suppress progress prints")
    return p


def main(argv: list[str] | None = None) -> int:
    from psa.ops.device import DeviceUnavailableError

    try:
        return _main(build_parser().parse_args(argv))
    except DeviceUnavailableError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def _main(args) -> int:

    if args.device_share is not None:
        if args.device_share == -100:
            # main.c:33-37: -100 => sequential mode (1 thread, no device)
            args.backend, args.threads, args.device_share = "native", 1, None
        elif 0 <= args.device_share <= 100:
            if args.backend not in ("auto", "hybrid"):
                print("error: --device-share conflicts with "
                      f"--backend {args.backend}", file=sys.stderr)
                return 2
            if args.batch or args.serve or args.sharded or args.distributed:
                print("error: --device-share applies to single-query "
                      "searches only (the reference splits one query, "
                      "cpu_funcs.c:144-150)", file=sys.stderr)
                return 2
            args.backend = "hybrid"
        else:
            print("error: --device-share must be in [0, 100] or -100",
                  file=sys.stderr)
            return 2
    if args.backend == "hybrid" and (args.batch or args.serve
                                     or args.sharded or args.distributed):
        print("error: the hybrid backend applies to single-query searches "
              "only", file=sys.stderr)
        return 2

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    if args.distributed:
        return _main_distributed(args)
    if args.serve:
        return _main_serve(args)
    if args.batch:
        return _main_batch(args)

    from psa.core.alphabet import encode
    from psa.core.result import NoMutationFound
    from psa.models.search import AlignmentSearchEngine
    from psa.utils.io import read_cases, read_input, write_output

    if args.print_table:
        from psa.utils.pretty import render_sign_table

        print(render_sign_table())

    try:
        if args.case is not None:
            cases = read_cases(args.input)
            if not 0 <= args.case < len(cases):
                print(f"error: --case {args.case} out of range "
                      f"(file has {len(cases)} cases)", file=sys.stderr)
                return 2
            query = cases[args.case]
        else:
            query = read_input(args.input)
    except FileNotFoundError:
        print(f"error: cannot open input file `{args.input}`", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"error: bad input file `{args.input}`: {e}", file=sys.stderr)
        return 2
    engine = AlignmentSearchEngine(query.weights, query.is_max,
                                   backend=args.backend,
                                   strict_alphabet=not args.lenient,
                                   nthreads=args.threads,
                                   device_share=args.device_share)

    import contextlib

    from psa.utils.profiling import trace

    tracer = trace(args.trace) if args.trace else contextlib.nullcontext()
    t0 = time.perf_counter()
    try:
        with tracer:
            if args.sharded:
                from psa.core.alphabet import ensure_valid
                from psa.parallel.mesh import search_sharded_auto

                ensure_valid(query.seq1, query.seq2, args.lenient)
                # mesh shape chosen per workload: offset blocks for long
                # Seq1, a char-reduction axis when noff/N ~ l2p (the
                # strong-scaling regime); PSA_MESH_SHAPE overrides
                res = search_sharded_auto(encode(query.seq1),
                                          encode(query.seq2),
                                          engine.tables,
                                          kernel=_sharded_kernel(args.backend))
            else:
                res = engine.search(query.seq1, query.seq2)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except NoMutationFound:
        elapsed = time.perf_counter() - t0
        # Defined behavior where the reference has UB (SURVEY.md Q3): report
        # explicitly, write the unmodified Seq2 with offset -1.
        print("There are no mutations found", file=sys.stderr)
        write_output(args.output, query.seq2, -1,
                     float("-inf") if query.is_max else float("inf"))
        if args.json:
            print(_result_json(query, None, elapsed))
        elif not args.quiet:
            print("total time: %g" % elapsed)
        return 1
    elapsed = time.perf_counter() - t0

    mutant = res.mutant(query.seq2)
    write_output(args.output, mutant, res.offset, res.score)
    if args.explain:
        from psa.utils.pretty import pretty_print

        pretty_print(query, res)
    if args.json:
        print(_result_json(query, res, elapsed))
    elif not args.quiet:
        # same trailer the reference prints (main.c:46-47)
        print("total time: %g" % elapsed)
    return 0


def _result_json(query, res, elapsed: float | None = None,
                 case: int | None = None) -> str:
    """One machine-readable result object (None result = no mutation)."""
    import json

    obj: dict = {}
    if case is not None:
        obj["case"] = case
    obj["mutation_found"] = res is not None
    if res is not None:
        obj.update(offset=res.offset, char_offset=res.char_offset,
                   substitute=res.sub_char, score=res.score,
                   mutant=res.mutant(query.seq2))
    else:
        obj.update(offset=-1, score=(float("-inf") if query.is_max
                                     else float("inf")),
                   mutant=query.seq2)
    if elapsed is not None:
        obj["time_s"] = elapsed
    # json can't carry inf: mirror C printf's 'inf' string for the UB-path
    # score (the %g writer prints 'inf' there too)
    if not np.isfinite(obj["score"]):
        obj["score"] = "%g" % obj["score"]
    return json.dumps(obj)


def _main_batch(args) -> int:
    """Batch mode: run every embedded case record, one output file each."""
    import os

    from psa.models.batch import search_batch
    from psa.utils.io import format_output, read_cases

    try:
        cases = read_cases(args.input)
    except FileNotFoundError:
        print(f"error: cannot open input file `{args.input}`", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"error: bad input file `{args.input}`: {e}", file=sys.stderr)
        return 2

    outdir = args.output
    if outdir.endswith(".txt"):
        outdir = outdir[: -len(".txt")]
    os.makedirs(outdir, exist_ok=True)

    import contextlib

    from psa.utils.profiling import trace

    tracer = trace(args.trace) if args.trace else contextlib.nullcontext()
    t0 = time.perf_counter()
    try:
        with tracer:
            results = search_batch(cases, backend=args.backend,
                                   strict_alphabet=not args.lenient,
                                   mesh=_batch_mesh(args))
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    elapsed = time.perf_counter() - t0

    n_missing = 0
    for i, (q, res) in enumerate(zip(cases, results)):
        path = os.path.join(outdir, f"out_{i:04d}.txt")
        with open(path, "w") as f:
            if res is None:
                n_missing += 1
                bad = float("-inf") if q.is_max else float("inf")
                f.write(format_output(q.seq2, -1, bad))
            else:
                f.write(format_output(res.mutant(q.seq2), res.offset,
                                      res.score))
        if args.json:
            print(_result_json(q, res, case=i))
        if args.explain and res is not None:
            from psa.utils.pretty import pretty_print

            print(f"--- case {i} ---", file=sys.stderr)
            pretty_print(q, res, file=sys.stderr)
    if not args.quiet:
        print(f"{len(cases)} cases -> {outdir}/ "
              f"({n_missing} without mutation)", file=sys.stderr)
        if not args.json:
            print("total time: %g" % elapsed)
    # same contract as single-case mode: no-mutation cases signal exit 1
    return 1 if n_missing else 0


class _ServeLineReader:
    """Blocking-first, drain-the-rest line reader over a raw fd.

    `next_chunk(max_lines)` blocks until at least one COMPLETE line exists,
    then coalesces every further complete line already available on the fd
    (zero-timeout select + os.read) up to max_lines.  Reading at the fd
    level fixes two protocol hazards of a naive readline/select loop:
    a partial line on the fd can never block the dispatch of complete
    lines already collected (os.read after select-ready cannot block), and
    lines sitting in a stdio readahead buffer are never invisible to the
    coalescing check.  Streams without a usable fileno (e.g. StringIO in
    tests) fall back to one blocking readline per chunk.
    """

    def __init__(self, stream):
        self._stream = stream
        self._pending = bytearray()
        self._eof = False
        try:
            self._fd = stream.fileno()
        except Exception:  # noqa: BLE001 - io.UnsupportedOperation etc.
            self._fd = None

    def _take_lines(self, out: list, max_lines: int) -> None:
        while len(out) < max_lines:
            nl = self._pending.find(b"\n")
            if nl < 0:
                break
            out.append(self._pending[: nl + 1].decode("utf-8", "replace"))
            del self._pending[: nl + 1]

    def next_chunk(self, max_lines: int):
        """Returns (lines, eof)."""
        import os
        import select as _select

        if self._fd is None:
            if self._eof:
                return [], True
            line = self._stream.readline()
            if line == "":
                self._eof = True
            return ([line] if line else []), self._eof

        lines: list = []
        # blocking phase: at least one complete line (or EOF)
        while not lines:
            self._take_lines(lines, max_lines)
            if lines:
                break
            if self._eof:
                break
            data = os.read(self._fd, 1 << 16)
            if not data:
                self._eof = True
            else:
                self._pending += data
        # drain phase: whatever is already on the fd, without blocking
        return self._drain(lines, max_lines)

    def poll_chunk(self, max_lines: int, timeout: float = 0.0):
        """Non-blocking next_chunk: complete lines already on the fd,
        waiting at most `timeout` seconds for new bytes.  Used while a
        dispatched batch computes on the device, so arriving queries join
        the NEXT batch instead of waiting out a device round trip.
        Streams without a fileno can't be polled -> ([], eof)."""
        if self._fd is None:
            time.sleep(timeout)     # unpollable stream: honor the wait so
            return [], self._eof    # device-poll loops don't busy-spin
        return self._drain([], max_lines, first_timeout=timeout)

    def _drain(self, lines: list, max_lines: int,
               first_timeout: float = 0.0):
        """Shared drain + EOF-tail rule for next_chunk/poll_chunk: pull
        complete lines already on the fd into `lines`, waiting at most
        `first_timeout` seconds for the FIRST new bytes (0 = pure drain);
        a final unterminated line at EOF is still a query.  Returns
        (lines, eof-and-fully-consumed)."""
        import os
        import select as _select

        first = True
        while not self._eof and len(lines) < max_lines:
            if b"\n" in self._pending:
                self._take_lines(lines, max_lines)
                continue
            ready, _, _ = _select.select([self._fd], [], [],
                                         first_timeout if first else 0)
            first = False
            if not ready:
                break
            data = os.read(self._fd, 1 << 16)
            if not data:
                self._eof = True
            else:
                self._pending += data
        self._take_lines(lines, max_lines)
        if (self._eof and self._pending and b"\n" not in self._pending
                and len(lines) < max_lines):
            lines.append(self._pending.decode("utf-8", "replace"))
            self._pending.clear()
        return lines, self._eof and not self._pending


def _main_serve(args) -> int:
    """Streaming serve loop: stdin query lines -> stdout result lines.

    The serving analog of the reference's one-shot orchestrator
    (cpu_funcs.c:25-121): same 7-token query grammar (cpu_funcs.c:353-368),
    same result fields, but long-lived — results stream back in input order
    and compiled device programs stay warm across chunks (models/batch.py
    caches jitted runners by bucket shape).

    Result line grammar (stable, machine-parseable by first token):
      `<offset> <score%g> <mutant>`   mutation found
      `-1 <inf|-inf> <seq2>`          no legal mutation (defined Q3 behavior)
      `error <message>`               malformed query line (server keeps going)
    Blank lines are ignored.  --json swaps result lines for JSON objects.
    """
    import contextlib

    from psa.models.batch import mark_serve_process
    from psa.utils.profiling import trace

    mark_serve_process()   # long at-exit bound for in-flight bucket compiles
    mesh = _batch_mesh(args)
    if args.warmup:
        rc = _serve_warmup(args, mesh)
        if rc:
            return rc
    t_start = time.perf_counter()
    tracer = trace(args.trace) if args.trace else contextlib.nullcontext()
    with tracer:
        if args.listen is not None:
            from psa.utils.server import serve_tcp

            rc = serve_tcp(args.listen, backend=args.backend,
                           lenient=args.lenient, json_out=args.json,
                           mesh=mesh, max_batch=args.serve_batch,
                           quiet=args.quiet)
        else:
            rc = _serve_loop(args, _ServeLineReader(sys.stdin), mesh)
    if not args.quiet:
        from psa.models.batch import cold_routed_queries

        print(f"[serve] cold buckets answered by the host engine: "
              f"{cold_routed_queries()} queries", file=sys.stderr)
        print("total time: %g" % (time.perf_counter() - t_start),
              file=sys.stderr)
    return rc


def _serve_warmup(args, mesh) -> int:
    """--warmup FILE: synchronously pre-compile the device runners a full
    serve chunk of each declared (weights, mode, shape-bucket) would
    dispatch through (models/batch.warm_fused_runner).  Returns nonzero on
    a bad warmup file; a compile failure raises."""
    from psa.core.tables import build_tables_cached
    from psa.models.batch import (planned_runner_keys, runner_key_batch,
                                      warm_fused_runner)
    from psa.ops.common import plan_shapes
    from psa.utils.io import parse_query_lines

    try:
        with open(args.warmup) as f:
            lines = f.read().splitlines()
    except OSError as e:
        print(f"error: cannot read --warmup file `{args.warmup}`: {e}",
              file=sys.stderr)
        return 2
    buckets: dict = {}
    for j, ent in enumerate(parse_query_lines(lines,
                                              check_alphabet=not args.lenient)):
        if ent is None:
            continue
        if isinstance(ent, str):
            print(f"warning: --warmup line {j + 1} skipped: {ent}",
                  file=sys.stderr)
            continue
        _, _, l2p, l1k = plan_shapes(len(ent.seq1), len(ent.seq2))
        buckets.setdefault(
            (tuple(float(x) for x in ent.weights), ent.is_max, l1k, l2p),
            []).append(ent.seq1)
    chunk = max(1, args.serve_batch)
    spec = getattr(args, "warmup_sizes", "chunk") or "chunk"
    if spec == "chunk":
        sizes = [chunk]
    elif spec == "ladder":
        sizes, s = [], 1
        while s < chunk:
            sizes.append(s)
            s *= 2
        sizes.append(chunk)
    else:
        try:
            sizes = sorted({max(1, min(int(x), chunk))
                            for x in spec.split(",") if x.strip()})
        except ValueError:
            print(f"error: bad --warmup-sizes `{spec}` (use `chunk`, "
                  "`ladder`, or a comma list of ints)", file=sys.stderr)
            return 2
    done: set = set()
    for (w, is_max, l1k, l2p), s1s in buckets.items():
        tables = build_tables_cached(np.asarray(w), is_max)
        # warm the wire variant the declared traffic will use: a bucket
        # whose file queries all share Seq1 dispatches through the dedup
        # 's1' runners — warm those AND the plain variant (mixed/straggler
        # chunks still use it)
        shared = len(s1s) > 1 and all(s == s1s[0] for s in s1s[1:])
        keys: set = set()
        for bsz in sizes:
            keys |= planned_runner_keys(tables, bsz, l1k, l2p, mesh=mesh)
            if shared:
                keys |= planned_runner_keys(tables, bsz, l1k, l2p, mesh=mesh,
                                            shared_s1=True)
        for key in sorted(keys, key=runner_key_batch):
            if key in done:
                # runners are weights-generic: a second weight vector on
                # the same (mode, shape) bucket shares the compiled
                # program — re-warming would only burn a dummy device
                # batch per extra weights for zero benefit
                continue
            done.add(key)
            bsz = runner_key_batch(key)
            t0 = time.perf_counter()
            warm_fused_runner(tables, bsz, l1k, l2p, mesh=mesh,
                              shared_s1=key[0].endswith("s1"))
            if not args.quiet:
                print(f"[warmup] bucket B={bsz} l1k={l1k} l2p={l2p} "
                      f"{'max' if is_max else 'min'} compiled in "
                      f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
    return 0


def _serve_loop(args, reader, mesh) -> int:
    """The chunk loop of `_main_serve`; returns the process exit code.

    Pipelined: up to two batches may be dispatched-but-unfinished, and
    while the oldest computes on the device the loop keeps draining stdin
    (reader.poll_chunk) so arriving queries join the NEXT batch instead of
    waiting out a device round trip.  Replies print strictly in input order
    (batches finish FIFO).  Partial batches dispatch only once the device
    pipeline is empty — while the device is busy, a trickle accumulates
    into a fuller batch (the quiescence rule's pipelined analog)."""
    from psa.config import CONFIG
    from psa.utils.server import Finisher, dispatch_query_lines

    max_b = max(1, args.serve_batch)
    depth = max(1, CONFIG.serve_inflight)
    served = 0
    queued: list = []
    eof = False
    fin = Finisher()               # fetches complete FIFO off-loop

    def flush(payload) -> int:
        nonlocal served
        outputs, nq, dt = payload
        try:
            for o in outputs:
                if o is not None:
                    print(o)
            sys.stdout.flush()
        except BrokenPipeError:
            # client went away: a server exits quietly (128+SIGPIPE),
            # it doesn't traceback
            if not args.quiet:
                print("[serve] client closed the reply pipe; exiting",
                      file=sys.stderr)
            try:
                # park stdout on /dev/null so interpreter shutdown's
                # buffer flush can't raise a second EPIPE
                import os

                os.dup2(os.open(os.devnull, os.O_WRONLY),
                        sys.stdout.fileno())
            except Exception:  # noqa: BLE001 - non-fd stdout (tests)
                pass
            return 141
        served += nq
        if not args.quiet and nq:
            print(f"[serve] {nq} queries in {dt*1e3:.1f} ms "
                  f"({served} total)", file=sys.stderr)
        return 0

    abandon = False
    try:
        while True:
            # dispatch: a full batch whenever pipeline space exists; a
            # partial one only once the device pipeline is empty
            while (fin.inflight < depth
                   and (len(queued) >= max_b
                        or (queued and not fin.inflight))):
                take = queued[:max_b]
                del queued[:max_b]
                fin.submit(dispatch_query_lines(
                    take, backend=args.backend, lenient=args.lenient,
                    json_out=args.json, mesh=mesh))
            if not fin.inflight:
                if eof:
                    break
                lines, eof = reader.next_chunk(max_b)  # idle: block
                queued.extend(lines)
                continue
            # print whatever the finisher thread completed; block outright
            # only when nothing else can progress (pipeline full, or EOF
            # endgame with no full batch left to form)
            block = (fin.inflight >= depth
                     or (eof and len(queued) < max_b))
            got = fin.collect(timeout=None if block else 0)
            if got is not None:
                rc = flush(got[1])
                if rc:
                    # broken pipe: nobody reads further replies — exit
                    # without waiting for in-flight fetches
                    abandon = True
                    return rc
                continue
            # oldest batch still in flight and pipeline has room: drain
            # stdin while the finisher blocks on the fetch in background
            lines, got_eof = reader.poll_chunk(max_b - len(queued),
                                               timeout=0.002)
            eof = eof or got_eof
            queued.extend(lines)
    finally:
        fin.close(wait=not abandon)
    return 0


def _batch_mesh(args):
    """--sharded in batch/serve mode: a 1-D 'dp' mesh over all local
    devices — device buckets shard their batch axis across it
    (models/batch.batched_search_exact_sharded)."""
    if not getattr(args, "sharded", False):
        return None
    import jax

    from psa.parallel.mesh import make_mesh

    return make_mesh(jax.devices(), axis="dp")


def _sharded_kernel(backend: str) -> str:
    """Backends with a sharded/distributed path; others coerce to xla."""
    if backend in ("auto", "pallas", "xla"):
        return backend
    print(f"warning: backend {backend!r} has no sharded path; "
          "using the xla kernel", file=sys.stderr)
    return "xla"


def _main_distributed(args) -> int:
    """Multi-process flow: join the process group, run the distributed
    search.

    Mirrors the reference's ranked path (main.c:20-22 -> cpu_funcs.c:25-121):
    every process executes the same program; process 0 owns file I/O and the
    time trailer."""
    from psa.parallel import multihost

    try:
        multihost.initialize(args.coordinator, args.num_processes,
                             args.process_id, args.local_device_id)
    except Exception as e:  # noqa: BLE001 - bad or missing cluster arguments
        print(f"error: cannot join the process group ({type(e).__name__}: "
              f"{e}); pass --coordinator/--num-processes/--process-id "
              "explicitly or launch via psa-dist", file=sys.stderr)
        return 2

    if args.batch:
        outdir = args.output
        if outdir.endswith(".txt"):
            outdir = outdir[: -len(".txt")]
        t0 = time.perf_counter()
        try:
            code = multihost.run_distributed_batch(args.input, outdir,
                                                   backend=args.backend,
                                                   lenient=args.lenient,
                                                   quiet=args.quiet,
                                                   json_out=args.json,
                                                   shard_local=args.sharded)
        except FileNotFoundError:
            print(f"error: cannot open input file `{args.input}`",
                  file=sys.stderr)
            return 2
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if multihost.is_primary() and not args.quiet and not args.json:
            print("total time: %g" % (time.perf_counter() - t0))
        return code

    kernel = _sharded_kernel(args.backend)
    t0 = time.perf_counter()
    try:
        code = multihost.run_distributed_search(args.input, args.output,
                                                backend_kernel=kernel,
                                                lenient=args.lenient)
    except FileNotFoundError:
        print(f"error: cannot open input file `{args.input}`", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    elapsed = time.perf_counter() - t0
    if multihost.is_primary() and not args.quiet:
        print("total time: %g" % elapsed)
    return code


if __name__ == "__main__":
    sys.exit(main())
