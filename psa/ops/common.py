"""Shared helpers for device engines: padding, bucketing, table transfer.

XLA traces static shapes, so sequences are padded with the inert PAD_CODE to
bucketed lengths (SURVEY.md §7.2 "dynamic lengths vs XLA static shapes").
Buckets grow geometrically (x1.5) from a 512 floor to bound the number of
compiled variants while wasting <= 50% padding work.
"""

from __future__ import annotations

import functools

import numpy as np

LANE = 128

# The sweep kernel's block (ops/pallas_sweep.py): offsets per program and
# Seq2 chars per step.  Powers of two (the Triton route's block rule); every
# device path pads the offset axis to TILE_O and Seq2 to CHUNK.
TILE_O = 256
CHUNK = 16


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def bucket_len(n: int, floor: int = 512, multiple: int = LANE) -> int:
    """Smallest bucket >= n from {floor, 1.5*floor, ...}, lane-aligned."""
    b = floor
    while b < n:
        b = round_up(int(b * 3 // 2), multiple)
    return b


def keyed_f32_totals(counts, maxrank, tables, noff, counts_axis: int = -1):
    """f32 in-graph ranking totals (jittable; shared by every device path).

    counts: the 4 class counts along `counts_axis` (default -1: shape
    (..., N, 4); pass -2 for the kernel's rows layout (..., 4, N) where
    the offset axis stays minor);
    maxrank: (..., N) int; noff: scalar or (...,) true offset counts.
    Returns (keyed, total): `total` is the f32 post-substitution score per
    offset and `keyed` is sign-folded (argmax = mode-best) with invalid
    offsets (no substitution / padding) at -inf.  Ranking in f32 is
    approximate by design — exactness-critical callers pair this with
    integer stats + host re-scoring (ops/select.py,
    models/batch.exact_topk_epilogue_rows' near-tie band).
    """
    w32 = tables.w_signed.astype(np.float32)
    diff32 = np.concatenate([tables.diff_vals.astype(np.float32),
                             [np.float32(0.0)]])
    return keyed_f32_totals_ops(counts, maxrank, w32, diff32,
                                tables.is_max, noff, counts_axis)


def keyed_f32_totals_ops(counts, maxrank, w32, diff32, is_max: bool, noff,
                         counts_axis: int = -1):
    """`keyed_f32_totals` with the weight-dependent tables as VALUES
    (traced operands or constants) instead of a ScoringTables: w32 (4,)
    f32 signed class weights, diff32 (>= num_ranks + 1,) f32 rank->diff
    (zero-padded tail; index num_ranks is read only when diff_vals is
    empty, and padding past it is never read since maxrank < num_ranks).
    Passing these as jit operands makes one compiled program serve ANY
    weights for a shape (models/batch's weights-generic runners); passing
    numpy gives the old constant-folding behavior.  Only `is_max` stays
    trace-static (it flips the argmax direction)."""
    import jax.numpy as jnp

    diff32 = jnp.asarray(diff32)
    w32 = jnp.asarray(w32)
    c = jnp.moveaxis(counts.astype(jnp.float32), counts_axis, 0)
    # elementwise, never a matrix product: a float32 product may run in
    # TF32 on a GPU, which would break f32_band_epsilon's bound
    total = w32[0] * c[0] + w32[1] * c[1] + w32[2] * c[2] + w32[3] * c[3]
    total = total + diff32[jnp.clip(maxrank, 0, None)]
    offs = jnp.arange(maxrank.shape[-1], dtype=jnp.int32)
    noff_arr = jnp.asarray(noff, dtype=jnp.int32)
    valid = (maxrank >= 0) & (offs < noff_arr[..., None])
    sign = 1.0 if is_max else -1.0
    keyed = jnp.where(valid, sign * total, -jnp.inf)
    return keyed, total


def pad_query(codes1: np.ndarray, codes2: np.ndarray,
              floor: int | None = None) -> tuple[np.ndarray, np.ndarray, int]:
    """Pad both sequences to bucketed lengths; returns (c1p, c2p, noff)."""
    from psa.config import CONFIG
    from psa.core.alphabet import pad_codes

    if floor is None:
        floor = CONFIG.bucket_floor

    n1, n2 = codes1.shape[0], codes2.shape[0]
    noff = n1 - n2 + 1
    l2p = bucket_len(n2, floor)
    # seq1 must cover every window [o, o + l2p) for o < noff.
    l1p = bucket_len(max(n1, noff + l2p - 1), floor)
    return pad_codes(codes1, l1p), pad_codes(codes2, l2p), noff


@functools.lru_cache(maxsize=65536)
def plan_shapes(n1: int, n2: int):
    """Static padded shapes (noff, noff_pad, l2p, l1k) of a (n1, n2)
    problem for the sweep kernel.  Pure int math, memoized: the serve path
    calls it per query while bucketing (models/batch.py)."""
    noff = n1 - n2 + 1
    l2p = round_up(max(n2, CHUNK), CHUNK)
    noff_pad = round_up(noff, TILE_O)
    return noff, noff_pad, l2p, noff_pad + l2p
