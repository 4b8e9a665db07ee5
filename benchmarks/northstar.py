"""North-star workload harness (BASELINE.md): 100k-char Seq1, 10k-char Seq2.

This exceeds the reference's hard caps (def.h:35-38: 10,000 / 5,000) by 10x —
shapes here are bucketed, not bounded.  The run goes through the full
production path: offset-axis sharding over every available device
(parallel/mesh.search_sharded, the sweep kernel on a GPU), exact host
selection, and a parity check of the complete winner tuple against the
native reference-semantics engine.

Emits one JSON line.

Usage: python benchmarks/northstar.py [--n1 100000] [--n2 10000] [--iters 4]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n1", type=int, default=100_000)
    ap.add_argument("--n2", type=int, default=10_000)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--skip-verify", action="store_true")
    args = ap.parse_args()

    import jax

    from psa.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from psa.core.alphabet import encode
    from psa.core.tables import build_tables
    from psa.parallel.mesh import (make_mesh, make_sharded_stats_fn,
                                       pad_for_mesh, search_sharded)
    from psa.utils.generator import random_sequences

    n1, n2 = args.n1, args.n2
    platform = jax.devices()[0].platform
    ndev = jax.device_count()
    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    seq1, seq2 = random_sequences(n1, n2, seed=0)
    c1, c2 = encode(seq1), encode(seq2)
    pair_evals = float(n1 - n2 + 1) * n2
    log(f"[northstar] platform={platform} devices={ndev} {n1}x{n2} "
        f"({pair_evals:.3g} pair-evals)")

    # end-to-end sharded search (includes host selection) + parity
    mesh = make_mesh()
    t0 = time.perf_counter()
    res = search_sharded(c1, c2, tables, mesh)
    e2e_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = search_sharded(c1, c2, tables, mesh)
    e2e = time.perf_counter() - t0
    log(f"[northstar] e2e sharded search: {e2e*1e3:.0f} ms "
        f"(first {e2e_first:.1f}s) -> offset={res.offset} score={res.score}")

    parity = None
    if not args.skip_verify:
        from psa.native import search_native

        ref = search_native(c1, c2, tables)
        parity = (res.offset, res.char_offset, res.sub_code, res.score) == (
            ref.offset, ref.char_offset, ref.sub_code, ref.score)
        log(f"[northstar] native-engine parity: {'OK' if parity else 'FAIL'}")

    # device-only sweep time: median of warm calls, each block_until_ready
    c1p, c2p, _ = pad_for_mesh(c1, c2, ndev)
    stats_fn = make_sharded_stats_fn(tables, mesh, c1p.shape[0], c2p.shape[0])
    jax.block_until_ready(stats_fn(c1p, c2p))
    ts = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        jax.block_until_ready(stats_fn(c1p, c2p))
        ts.append(time.perf_counter() - t0)
    dt = float(np.median(ts))
    log(f"[northstar] device sweep: {dt*1e3:.1f} ms, {pair_evals/dt:.3g} evals/s")

    print(json.dumps({
        "metric": "northstar_100kx10k",
        "platform": platform,
        "devices": ndev,
        "workload": {"n1": n1, "n2": n2},
        "e2e_seconds": e2e,
        "sweep_seconds": dt,
        "pair_evals_per_sec": pair_evals / dt,
        "winner": {"offset": res.offset, "char_offset": res.char_offset,
                   "sub_code": res.sub_code, "score": res.score},
        "native_parity": parity,
    }))
    return 0 if parity in (True, None) else 1


if __name__ == "__main__":
    sys.exit(main())
