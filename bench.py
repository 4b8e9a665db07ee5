"""Kernel benchmark on the GPU.

Prints ONE JSON line: the sweep kernel's pair evaluations per second at one
shape, the plain-XLA gather sweep at the same shape, golden-case parity
through the device backend, and the device they ran on.  `vs_baseline`
divides by an estimated ceiling for the reference CUDA kernel
(cuda_funcs.cu:149-199) of 5e8 pair-evals/s (the reference publishes no
measured numbers; see BASELINE.md).

Without a GPU it exits with code 2 and prints no result.

Usage:  python bench.py [--quick]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REF_BASELINE_PAIR_EVALS_PER_S = 5.0e8
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def median_ms(fn, reps: int = 20) -> float:
    """Median warm wall time (each call ends in block_until_ready)."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def bench_sweep(n1: int, n2: int, seed: int = 0):
    """(kernel ms, xla gather ms, pair-evals) of one warm sweep."""
    import jax
    import jax.numpy as jnp

    from psa.core.alphabet import encode, pad_codes
    from psa.core.tables import build_tables
    from psa.ops.common import plan_shapes
    from psa.ops.device import sweep_kernel
    from psa.ops.engine_xla import local_stats_xla
    from psa.ops.pallas_sweep import code_table_t
    from psa.utils.generator import random_sequences

    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    seq1, seq2 = random_sequences(n1, n2, seed=seed)
    noff, noff_pad, l2p, l1k = plan_shapes(n1, n2)
    s1 = jnp.asarray(pad_codes(encode(seq1), l1k))[None]
    s2 = jnp.asarray(pad_codes(encode(seq2), l2p))[None]
    code_t = code_table_t(tables.code)
    code_flat = jnp.asarray(tables.code.reshape(-1).astype(np.int32))
    sweep = sweep_kernel()
    xla = jax.jit(lambda a, b: local_stats_xla(a, b, code_flat, noff_pad,
                                               min(noff_pad, 4096)))
    got = np.asarray(sweep(s1, s2, code_t))[0]
    if not np.array_equal(got, np.asarray(xla(s1[0], s2[0]))):
        raise RuntimeError("kernel and xla statistics differ")
    return (median_ms(lambda: sweep(s1, s2, code_t)),
            median_ms(lambda: xla(s1[0], s2[0]), 5), float(noff) * n2)


def bench_golden() -> bool:
    """Golden case through the device backend, byte-compared."""
    from psa.models.search import AlignmentSearchEngine
    from psa.utils.io import format_output, read_input

    data = os.path.join(ROOT, "tests", "data")
    q = read_input(os.path.join(data, "golden_input.txt"))
    res = AlignmentSearchEngine(q.weights, q.is_max,
                                backend="pallas").search(q.seq1, q.seq2)
    with open(os.path.join(data, "golden_output.txt")) as f:
        return format_output(res.mutant(q.seq2), res.offset,
                             res.score) == f.read()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()

    import jax

    from psa.ops.device import accelerator_present
    from psa.utils.cache import enable_compilation_cache

    if not accelerator_present():
        log(f"[bench] error: no GPU (JAX backend {jax.default_backend()!r})")
        return 2
    enable_compilation_cache()
    n1, n2 = (16384, 2048) if args.quick else (131072 + 8191, 8192)
    t_kernel, t_xla, pairs = bench_sweep(n1, n2)
    rate = pairs / (t_kernel * 1e-3)
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "pair_evals_per_sec", "value": rate, "unit": "evals/s",
        "vs_baseline": rate / REF_BASELINE_PAIR_EVALS_PER_S,
        "detail": {"workload": {"n1": n1, "n2": n2},
                   "kernel_ms": t_kernel, "xla_gather_ms": t_xla,
                   "golden_parity": bench_golden()},
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
