"""Offset-sharding scaling harness (BASELINE.json configs 3-4).

Measures the sharded sweep across mesh sizes.  On several GPUs this reports
scaling efficiency; on a single host it can still run the virtual-CPU-mesh
ladder to validate the sharded program at every mesh size (numbers then
reflect core contention, not card scaling — flagged in the output).

Timing: the median of warm calls, each ending in `block_until_ready`.

`--mode serve` ladders the mesh-sharded exact batch SERVING path instead
(models/batch.batched_search_exact_sharded's device program): fixed global
batch, query axis sharded over 1..N devices, reported as queries/s.

Usage: python benchmarks/scaling.py [--n1 100000] [--n2 10000]
       [--devices 1,2,4,8] [--platform cpu] [--mode sweep|serve]
       [--batch 64] [--bn1 512] [--bn2 128]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

_VIRTUAL_NOTE = (
    "VIRTUAL MESH: N XLA host devices share this machine's CPU cores, so "
    "the efficiency column measures core contention, NOT real multi-card "
    "scaling. It validates that the sharded program compiles and produces "
    "identical results at every mesh size; throughput/efficiency claims "
    "require real cards (shards are independent; the merge is O(k) ints).")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _median_ms(fn, reps: int) -> float:
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n1", type=int, default=100_000)
    ap.add_argument("--n2", type=int, default=10_000)
    ap.add_argument("--devices", default=None,
                    help="comma list of mesh sizes (default: 1..device_count)")
    ap.add_argument("--platform", default=None, choices=[None, "cpu"],
                    help="cpu = force an 8-device virtual host mesh; "
                         "default = whatever JAX resolves")
    ap.add_argument("--iters", type=int, default=8,
                    help="timed warm calls per mesh size")
    ap.add_argument("--mode", default="sweep", choices=["sweep", "serve"])
    ap.add_argument("--batch", type=int, default=64,
                    help="serve mode: global batch (must divide every mesh "
                         "size)")
    ap.add_argument("--bn1", type=int, default=512)
    ap.add_argument("--bn2", type=int, default=128)
    args = ap.parse_args()

    if args.platform == "cpu":
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")

    from psa.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from psa.core.alphabet import encode
    from psa.core.tables import build_tables
    from psa.parallel.mesh import make_mesh, make_sharded_stats_fn, pad_for_mesh
    from psa.utils.generator import random_sequences

    ndev = jax.device_count()
    sizes = ([int(x) for x in args.devices.split(",")] if args.devices
             else [d for d in (1, 2, 4, 8, 16, 32) if d <= ndev])
    for d in sizes:
        if d > ndev:
            log(f"[scaling] error: mesh size {d} > available devices {ndev}")
            return 2
    if args.mode == "serve":
        return serve_ladder(args, sizes)

    n1, n2 = args.n1, args.n2
    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    seq1, seq2 = random_sequences(n1, n2, seed=0)
    c1, c2 = encode(seq1), encode(seq2)
    pair_evals = float(n1 - n2 + 1) * n2
    platform = jax.devices()[0].platform
    log(f"[scaling] platform={platform} devices={ndev} workload {n1}x{n2} "
        f"({pair_evals:.3g} pair-evals)")

    results = []
    base_rate = None
    for d in sizes:
        mesh = make_mesh(jax.devices()[:d])
        c1p, c2p, noff = pad_for_mesh(c1, c2, d)
        stats_fn = make_sharded_stats_fn(tables, mesh, c1p.shape[0],
                                         c2p.shape[0])
        dt = _median_ms(lambda: stats_fn(c1p, c2p), args.iters) * 1e-3
        rate = pair_evals / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * d / sizes[0])
        results.append({"devices": d, "seconds": dt, "pair_evals_per_sec": rate,
                        "scaling_efficiency": eff})
        log(f"[scaling] {d} dev: {dt*1e3:8.1f} ms/sweep  {rate:.3g} evals/s  "
            f"eff={eff:.2f}")

    print(json.dumps({
        "metric": "offset_sharding_scaling",
        "platform": platform,
        "virtual_mesh": platform == "cpu",
        **({"note": _VIRTUAL_NOTE} if platform == "cpu" else {}),
        "workload": {"n1": n1, "n2": n2},
        "results": results,
    }))
    return 0


def serve_ladder(args, sizes) -> int:
    """Queries/s of the mesh-sharded exact-batch device program vs mesh
    size (fixed global batch = strong scaling)."""
    import jax
    import jax.numpy as jnp

    from psa.core.alphabet import encode, pad_codes
    from psa.core.tables import build_tables
    from psa.models.batch import (make_batched_fused_sharded_runner,
                                  pack_query_inputs)
    from psa.ops.common import plan_shapes
    from psa.ops.device import resolve_interpret
    from psa.parallel.mesh import make_mesh
    from psa.utils.generator import random_sequences

    B, n1, n2 = args.batch, args.bn1, args.bn2
    for d in sizes:
        if B % d:
            log(f"[scaling] error: --batch {B} not divisible by mesh {d}")
            return 2
    platform = jax.devices()[0].platform
    interpret = resolve_interpret()
    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    _, noff_pad, l2p, l1k = plan_shapes(n1, n2)
    seqs = [random_sequences(n1, n2, seed=s) for s in range(B)]
    c1b = np.stack([pad_codes(encode(a), l1k) for a, _ in seqs])
    c2b = np.stack([pad_codes(encode(b), l2p) for _, b in seqs])
    noffs = np.full(B, n1 - n2 + 1, np.int32)
    inbuf = jnp.asarray(pack_query_inputs(c1b, c2b, noffs))
    log(f"[scaling] serve mode: platform={platform} B={B} {n1}x{n2} "
        f"(l1k={l1k}, l2p={l2p})")

    results = []
    base_rate = None
    for d in sizes:
        mesh = make_mesh(jax.devices()[:d], axis="dp")
        run = make_batched_fused_sharded_runner(tables, B, l1k, l2p, mesh,
                                                interpret)
        dt = _median_ms(lambda: run(inbuf), args.iters) * 1e-3
        rate = B / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * d / sizes[0])
        results.append({"devices": d, "seconds": dt,
                        "queries_per_sec": rate,
                        "scaling_efficiency": eff})
        log(f"[scaling] {d} dev: {dt*1e3:8.1f} ms/batch  {rate:.0f} q/s  "
            f"eff={eff:.2f}")

    print(json.dumps({
        "metric": "serve_sharding_scaling",
        "platform": platform,
        "virtual_mesh": platform == "cpu",
        **({"note": _VIRTUAL_NOTE} if platform == "cpu" else {}),
        "workload": {"batch": B, "n1": n1, "n2": n2},
        "results": results,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
