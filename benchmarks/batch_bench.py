"""Batch-mode throughput benchmark (BASELINE.json config 5).

Streams B independent (Seq1, Seq2) queries through the exact batched device
path (one sweep-kernel grid per microbatch + in-graph top-k epilogue + exact
host selection) and reports queries/s and aggregate pair-evals/s.  A sample
of winners is verified against the exact host oracle.

Usage: python benchmarks/batch_bench.py [--batch 1000] [--n1 2048] [--n2 512]
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
    ap.add_argument("--batch", type=int, default=1000)
    ap.add_argument("--n1", type=int, default=2048)
    ap.add_argument("--n2", type=int, default=512)
    ap.add_argument("--verify", default="8",
                    help="'all' or a count: verify this many winners of the "
                         "EXACT path against the per-query host oracle")
    args = ap.parse_args()
    n_verify = None
    if args.verify != "all":
        n_verify = int(args.verify)

    import jax

    from psa.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from psa.core.alphabet import pad_codes
    from psa.core.tables import build_tables
    from psa.ops.common import plan_shapes
    from psa.utils.generator import random_sequences
    from psa.core.alphabet import encode

    B, n1, n2 = args.batch, args.n1, args.n2
    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)

    # same shape policy as production (search_batch / offset_stats_pallas)
    _, noff_pad, l2p, l1k = plan_shapes(n1, n2)

    rng_seqs = [random_sequences(n1, n2, seed=s) for s in range(B)]
    c1b = np.stack([pad_codes(encode(a), l1k) for a, _ in rng_seqs])
    c2b = np.stack([pad_codes(encode(b), l2p) for _, b in rng_seqs])
    noffs = np.full(B, n1 - n2 + 1, np.int32)
    log(f"[batch] B={B} n1={n1} n2={n2} (noff_pad={noff_pad}, l2p={l2p})")

    # bit-exact batched path: one kernel grid per microbatch, packed
    # single-upload/single-fetch, pipelined microbatches, host sequential
    # re-score (models/batch.batched_search_exact)
    from psa.models.batch import batched_search_exact

    n2s = np.full(B, n2, np.int32)
    t0 = time.perf_counter()
    exact = batched_search_exact(c1b, c2b, noffs, n2s, tables)  # compile
    log(f"[batch] exact first call (compile+run): {time.perf_counter()-t0:.1f}s")
    dt_exact = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        exact = batched_search_exact(c1b, c2b, noffs, n2s, tables)
        dt_exact = min(dt_exact, time.perf_counter() - t0)
    log(f"[batch] exact fused path: {B} queries in {dt_exact:.3f}s -> "
        f"{B/dt_exact:.1f} q/s")

    # verify exact-path winners (full tuple) against the per-query oracle
    from psa.core.oracle import offset_stats_numpy
    from psa.ops.select import select_best

    bad = 0
    idxs = (np.arange(B) if n_verify is None
            else np.linspace(0, B - 1, min(n_verify, B)).astype(int))
    for q in idxs:
        counts, maxrank = offset_stats_numpy(c1b[q][: n1], c2b[q][: n2], tables)
        ref = select_best(counts, maxrank, tables, c1b[q][: n1], c2b[q][: n2])
        r = exact[q]
        got = (None if r is None
               else (r.offset, r.char_offset, r.sub_code, r.score))
        if got != (ref.offset, ref.char_offset, ref.sub_code, ref.score):
            bad += 1
            log(f"[batch] EXACT MISMATCH q={q}: got {r} want {ref}")
    pair_evals = float(B) * (n1 - n2 + 1) * n2
    out = {
        "metric": "batch_queries_per_sec",
        "value": B / dt_exact,
        "unit": "queries/s",
        "detail": {
            "batch": B, "n1": n1, "n2": n2,
            "seconds": dt_exact,
            "pair_evals_per_sec": pair_evals / dt_exact,
            "verified": int(len(idxs) - bad), "mismatches": int(bad),
        },
    }
    log(f"[batch] exact {B/dt_exact:.1f} q/s ({pair_evals/dt_exact:.3g} "
        f"pair-evals/s); verified {len(idxs)-bad}/{len(idxs)}")
    print(json.dumps(out))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
