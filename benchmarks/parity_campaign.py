"""Large randomized bit-parity campaign (CPU, engines vs the numpy oracle).

A scaled-up version of tests/test_fuzz.py for pre-release confidence runs:
hundreds of random cases across modes, weight regimes (quarter-integer,
irrational, adversarially tied), hyphen densities, and shape regimes
(sub-tile, multi-tile, multi-chunk), exercising:

  - end-to-end winners: native C++ and pallas-interpret vs the numpy oracle
  - stats-level parity on multi-tile shapes (pallas interpret)
  - the exact batched path (fused kernel + host selection) vs per-query
  - the mesh-sharded exact batch path (random 2/4/8-shard virtual meshes)
  - the serve protocol end-to-end (real psa --serve subprocess over pipes)

Emits one JSON line; nonzero exit on any mismatch.

Usage: python benchmarks/parity_campaign.py [--cases 200] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import os

    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from psa.core.alphabet import OTHER_CODE
    from psa.core.oracle import offset_stats_numpy
    from psa.core.tables import build_tables
    from psa.models.search import AlignmentSearchEngine
    from psa.ops.pallas_sweep import offset_stats_pallas

    rng = np.random.default_rng(args.seed)

    def random_codes(n, hyphen_p=0.0, other_p=0.0):
        c = rng.integers(0, 26, n, dtype=np.int32)
        if hyphen_p:
            c[rng.random(n) < hyphen_p] = 26
        if other_p:
            c[rng.random(n) < other_p] = OTHER_CODE
        return c

    def random_weights():
        kind = rng.integers(0, 3)
        if kind == 0:      # quarter-integers (exactly representable)
            return np.round(rng.uniform(-4, 6, size=4) * 4) / 4
        if kind == 1:      # irrational-ish (sequential-FP ordering matters)
            return rng.uniform(-2, 4, size=4) * np.pi / 3
        # tie-heavy: few distinct magnitudes
        return rng.choice([0.5, 1.0, 2.0], size=4) * rng.choice([-1, 1], 4)

    t0 = time.perf_counter()
    mismatches = []
    n_e2e = n_stats = n_batch = 0

    # --- regime 1: end-to-end winners, small/medium shapes -----------------
    n_r1 = args.cases * 7 // 10
    for case in range(n_r1):
        n2 = int(rng.integers(1, 500))
        n1 = n2 + int(rng.integers(0, 2500))
        w = random_weights()
        is_max = bool(rng.integers(0, 2))
        hp = float(rng.choice([0.0, 0.05, 0.3]))
        op = float(rng.choice([0.0, 0.0, 0.08]))   # lenient-mode OTHER chars
        c1, c2 = random_codes(n1, hp, op), random_codes(n2, hp, op)
        ref_eng = AlignmentSearchEngine(w, is_max, backend="numpy")
        outs = {}
        for eng in ("native", "pallas"):
            e = AlignmentSearchEngine(w, is_max, backend=eng)
            try:
                r = e.search_codes(c1, c2)
                outs[eng] = (r.offset, r.char_offset, r.sub_code, r.score)
            except Exception as ex:  # noqa: BLE001
                outs[eng] = type(ex).__name__
        try:
            r = ref_eng.search_codes(c1, c2)
            ref = (r.offset, r.char_offset, r.sub_code, r.score)
        except Exception as ex:  # noqa: BLE001
            ref = type(ex).__name__
        for eng, got in outs.items():
            n_e2e += 1
            if got != ref:
                mismatches.append({"regime": "e2e", "case": case,
                                   "engine": eng, "got": str(got),
                                   "want": str(ref),
                                   "w": w.tolist(), "is_max": is_max})
        if case % 20 == 0:
            log(f"[campaign] e2e {case}/{n_r1} "
                f"({time.perf_counter()-t0:.0f}s)")
        if case % 50 == 49:
            # every random shape leaves a compiled executable in the
            # in-process cache; long campaigns OOM LLVM without this
            jax.clear_caches()

    # --- regime 2: multi-tile stats parity ---------------------------------
    n_r2 = max(args.cases // 10, 3)
    for case in range(n_r2):
        n2 = int(rng.integers(300, 800))
        n1 = n2 + int(rng.integers(5000, 12000))
        w = random_weights()
        is_max = bool(rng.integers(0, 2))
        c1 = random_codes(n1, 0.05)
        c2 = random_codes(n2, 0.05)
        t = build_tables(w, is_max)
        counts, maxrank = offset_stats_pallas(c1, c2, t, interpret=True)
        rc, rm = offset_stats_numpy(c1, c2, t)
        n_stats += 1
        if not (np.array_equal(counts, rc) and np.array_equal(maxrank, rm)):
            mismatches.append({"regime": "stats", "case": case,
                               "w": w.tolist(), "is_max": is_max})
        log(f"[campaign] stats {case+1}/{n_r2} "
            f"({time.perf_counter()-t0:.0f}s)")
        if case % 10 == 9:
            jax.clear_caches()

    # --- regime 3: batched exact path vs per-query -------------------------
    from psa.core.alphabet import pad_codes
    from psa.models.batch import batched_search_exact

    n_r3 = max(args.cases // 10, 2)
    for case in range(n_r3):
        n2 = int(rng.integers(50, 300))
        n1 = n2 + int(rng.integers(200, 1400))
        w = random_weights()
        is_max = bool(rng.integers(0, 2))
        t = build_tables(w, is_max)
        B = int(rng.integers(2, 9))
        noff = n1 - n2 + 1
        from psa.ops.common import plan_shapes

        _, noff_pad, l2p, l1k = plan_shapes(n1, n2)
        if rng.random() < 0.3:
            # shared-Seq1 pattern: exercises the dedup wire variant
            # (auto-detected by row equality)
            c1b = np.broadcast_to(pad_codes(random_codes(n1, 0.05), l1k),
                                  (B, l1k)).copy()
        else:
            c1b = np.stack([pad_codes(random_codes(n1, 0.05), l1k)
                            for _ in range(B)])
        c2b = np.stack([pad_codes(random_codes(n2, 0.05), l2p)
                        for _ in range(B)])
        noffs = np.full(B, noff, np.int32)
        n2s = np.full(B, n2, np.int32)
        rs = batched_search_exact(c1b, c2b, noffs, n2s, t, interpret=True,
                                  micro_b=int(rng.choice([4, 1024])))
        ref_eng = AlignmentSearchEngine(w, is_max, backend="numpy")
        from psa.core.result import NoMutationFound

        for q in range(B):
            n_batch += 1
            try:
                r = ref_eng.search_codes(c1b[q][:n1], c2b[q][:n2])
                want = (r.offset, r.char_offset, r.sub_code, r.score)
            except NoMutationFound:
                want = None          # the batch path's legitimate None
            except Exception as ex:  # noqa: BLE001
                # any other oracle failure must surface as a mismatch, not
                # collapse into the no-mutation None
                want = type(ex).__name__
            got = rs[q]
            got = (None if got is None else
                   (got.offset, got.char_offset, got.sub_code, got.score))
            if got != want:
                mismatches.append({"regime": "batch", "case": case, "q": q,
                                   "got": str(got), "want": str(want),
                                   "w": w.tolist(), "is_max": is_max})
        log(f"[campaign] batch {case+1}/{n_r3} "
            f"({time.perf_counter()-t0:.0f}s)")
        if case % 10 == 9:
            from psa.models import batch as _bm

            _bm.reset_runner_caches()   # runners + warm flags together
            jax.clear_caches()

    # --- regime 4: mesh-sharded exact batch path ---------------------------
    from psa.models.batch import batched_search_exact_sharded
    from psa.parallel.mesh import make_mesh

    n_r4 = max(args.cases // 20, 2)
    n_sharded = 0
    for case in range(n_r4):
        n2 = int(rng.integers(50, 200))
        n1 = n2 + int(rng.integers(200, 1400))
        w = random_weights()
        is_max = bool(rng.integers(0, 2))
        t = build_tables(w, is_max)
        B = int(rng.integers(2, 10))
        ndev = int(rng.choice([2, 4, 8]))
        from psa.ops.common import plan_shapes

        _, noff_pad, l2p, l1k = plan_shapes(n1, n2)
        c1b = np.stack([pad_codes(random_codes(n1, 0.05), l1k)
                        for _ in range(B)])
        c2b = np.stack([pad_codes(random_codes(n2, 0.05), l2p)
                        for _ in range(B)])
        noffs = np.full(B, n1 - n2 + 1, np.int32)
        n2s = np.full(B, n2, np.int32)
        mesh = make_mesh(jax.devices()[:ndev], axis="dp")
        rs = batched_search_exact_sharded(c1b, c2b, noffs, n2s, t, mesh,
                                          interpret=True)
        ref_eng = AlignmentSearchEngine(w, is_max, backend="numpy")
        for q in range(B):
            n_sharded += 1
            try:
                r = ref_eng.search_codes(c1b[q][:n1], c2b[q][:n2])
                want = (r.offset, r.char_offset, r.sub_code, r.score)
            except NoMutationFound:
                want = None
            except Exception as ex:  # noqa: BLE001
                want = type(ex).__name__
            got = rs[q]
            got = (None if got is None else
                   (got.offset, got.char_offset, got.sub_code, got.score))
            if got != want:
                mismatches.append({"regime": "sharded", "case": case,
                                   "q": q, "ndev": ndev, "got": str(got),
                                   "want": str(want), "w": w.tolist(),
                                   "is_max": is_max})
        log(f"[campaign] sharded {case+1}/{n_r4} (ndev={ndev}, "
            f"{time.perf_counter()-t0:.0f}s)")
        from psa.models import batch as _bm

        _bm.reset_runner_caches()
        jax.clear_caches()

    # --- regime 5: serve protocol end-to-end -------------------------------
    import subprocess

    from psa.core.alphabet import decode

    n_r5 = max(args.cases // 10, 10)
    n_serve = 0
    lines, wants = [], []
    for case in range(n_r5):
        n2 = int(rng.integers(5, 150))
        n1 = n2 + int(rng.integers(0, 600))
        w = np.round(rng.uniform(-2, 4, size=4) * 4) / 4
        is_max = bool(rng.integers(0, 2))
        s1 = decode(random_codes(n1, 0.05))
        s2 = decode(random_codes(n2, 0.05))
        lines.append(" ".join("%g" % x for x in w)
                     + f" {s1} {s2} " + ("maximum" if is_max else "minimum"))
        ref_eng = AlignmentSearchEngine(w, is_max, backend="numpy")
        try:
            r = ref_eng.search(s1, s2)
            wants.append("%d %g %s" % (r.offset, r.score, r.mutant(s2)))
        except NoMutationFound:
            bad = float("-inf") if is_max else float("inf")
            wants.append("-1 %g %s" % (bad, s2))
    proc = subprocess.run(
        [sys.executable, "-m", "psa.utils.cli", "--serve", "--quiet",
         "--platform", "cpu", "--backend", "native"],
        input="\n".join(lines) + "\n", capture_output=True, text=True,
        timeout=600)
    got_lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or len(got_lines) != n_r5:
        mismatches.append({"regime": "serve", "rc": proc.returncode,
                           "n_out": len(got_lines),
                           "stderr": proc.stderr[-500:]})
    else:
        for q, (got, want) in enumerate(zip(got_lines, wants)):
            n_serve += 1
            if got != want:
                mismatches.append({"regime": "serve", "q": q,
                                   "got": got[:80], "want": want[:80]})
    log(f"[campaign] serve {n_serve} queries "
        f"({time.perf_counter()-t0:.0f}s)")

    # --- regime 6: hybrid host+device split vs the oracle -------------------
    from psa.models.search import native_available

    n_r6 = max(args.cases // 10, 4) if native_available() else 0
    n_hybrid = 0
    for case in range(n_r6):
        n2 = int(rng.integers(20, 300))
        n1 = n2 + int(rng.integers(100, 1400))
        w = random_weights()
        is_max = bool(rng.integers(0, 2))
        share = float(rng.choice([0, 10, 33, 50, 77, 100]))
        c1, c2 = random_codes(n1, 0.05), random_codes(n2, 0.05)
        ref_eng = AlignmentSearchEngine(w, is_max, backend="numpy")
        hyb = AlignmentSearchEngine(w, is_max, backend="hybrid",
                                    device_share=share)
        try:
            r = ref_eng.search_codes(c1, c2)
            want = (r.offset, r.char_offset, r.sub_code, r.score)
        except Exception as ex:  # noqa: BLE001
            want = type(ex).__name__
        try:
            r = hyb.search_codes(c1, c2)
            got = (r.offset, r.char_offset, r.sub_code, r.score)
        except Exception as ex:  # noqa: BLE001
            got = type(ex).__name__
        n_hybrid += 1
        if got != want:
            mismatches.append({"regime": "hybrid", "case": case,
                               "share": share, "got": str(got),
                               "want": str(want), "w": w.tolist(),
                               "is_max": is_max})
        if case % 10 == 9:
            jax.clear_caches()
    log(f"[campaign] hybrid {n_hybrid} cases "
        f"({time.perf_counter()-t0:.0f}s)")

    # --- regime 8: 2-D (op x ch) mesh search vs the oracle ------------------
    from psa.parallel.mesh import make_mesh_2d, search_sharded_2d

    n_r8 = max(args.cases // 20, 3)
    n_2d = 0
    for case in range(n_r8):
        n2 = int(rng.integers(150, 700))
        n1 = n2 + int(rng.integers(300, 3000))
        w = random_weights()
        is_max = bool(rng.integers(0, 2))
        t = build_tables(w, is_max)
        n_op, n_ch = [(1, 2), (2, 2), (1, 4), (2, 4), (4, 2), (1, 8)][
            int(rng.integers(0, 6))]
        c1, c2 = random_codes(n1, 0.05), random_codes(n2, 0.05)
        mesh2 = make_mesh_2d(jax.devices(), n_op, n_ch)
        ref_eng = AlignmentSearchEngine(w, is_max, backend="numpy")
        try:
            r = ref_eng.search_codes(c1, c2)
            want = (r.offset, r.char_offset, r.sub_code, r.score)
        except Exception as ex:  # noqa: BLE001
            want = type(ex).__name__
        try:
            r = search_sharded_2d(c1, c2, t, mesh2)
            got = (r.offset, r.char_offset, r.sub_code, r.score)
        except Exception as ex:  # noqa: BLE001
            got = type(ex).__name__
        n_2d += 1
        if got != want:
            mismatches.append({"regime": "mesh2d", "case": case,
                               "mesh": [n_op, n_ch], "got": str(got),
                               "want": str(want), "w": w.tolist(),
                               "is_max": is_max})
        if case % 5 == 4:
            jax.clear_caches()
    log(f"[campaign] mesh2d {n_2d} cases "
        f"({time.perf_counter()-t0:.0f}s)")

    out = {
        "metric": "parity_campaign",
        "seed": args.seed,
        "checks": {"e2e": n_e2e, "multitile_stats": n_stats,
                   "batch_queries": n_batch, "sharded_queries": n_sharded,
                   "serve_queries": n_serve, "hybrid": n_hybrid,
                   "mesh2d": n_2d},
        "mismatches": mismatches,
        "ok": not mismatches,
        "seconds": round(time.perf_counter() - t0, 1),
    }
    print(json.dumps(out))
    return 1 if mismatches else 0


if __name__ == "__main__":
    sys.exit(main())
