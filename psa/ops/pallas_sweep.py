"""The device sweep kernel: table-lookup statistics in one Pallas program.

Per grid program (query q, offset tile t) the kernel owns TILE_O offsets
[o0, o0 + TILE_O) of query q and walks Seq2 in CHUNK-char steps.  Each step
builds the (CHUNK, TILE_O) block of fused pair codes directly:

    code[i, o] = CODE[seq1[o0 + o + c*CHUNK + i], seq2[c*CHUNK + i]]

with one integer-array gather of Seq1 (a sliding window: row i is the window
shifted by i, so a warp's loads along the offset axis are contiguous) and one
gather from the 32x32 code table, stored Seq2-char-major (`code_t[b*32 + a]
= CODE[a, b]`) so that a row of the block, which shares one Seq2 char, reads
one 128-byte line of the 4 KB table.  There is no one-hot, no matmul and no
shear.

Statistics accumulate elementwise in registers and are reduced over the chunk
axis once per program:

* class counts: two int32 words per element hold four 16-bit counters
  (cls3 | cls0 << 16 and cls1 | cls2 << 16).  An element gains at most one
  count per step, so a field holds at most the number of steps, which is
  kept below 2**16 by flushing every SEGMENT steps;
* max fused code: an elementwise max, monotone in the substitution rank.

Output: (B, 5, noff_pad) int32 — rows 0-3 the sign-class counts, row 4 the
max substitution rank (-1 = none), the offset axis minor.  All arithmetic is
integer, so the result is bit-identical in any execution order, and the
canonical tie-break is applied on the host (ops/select.py).

Shared Seq1 is an index choice: with a (1, l1k) Seq1 operand every query
reads row 0.  No state is carried between programs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from psa.ops.common import CHUNK, TILE_O

# Steps between flushes of the 16-bit counter fields (< 2**16).
SEGMENT = 32768
# Launch shape, chosen on an H100 (PERF.md, Findings).
NUM_WARPS = 4
NUM_STAGES = 1


def code_table_t(code) -> jnp.ndarray:
    """(32, 32) fused code table -> flat int32 Seq2-char-major lookup
    table (`[b*32 + a] = code[a, b]`), the kernel's table operand."""
    return jnp.asarray(code).astype(jnp.int32).T.reshape(-1)


def maxrank_from_maxcode(maxcode):
    """rank = ((code-1) >> 2) - 1, clamped to -1 for 'no substitution'."""
    if isinstance(maxcode, np.ndarray):
        return np.maximum(((maxcode - 1) >> 2) - 1, -1)
    return jnp.maximum(((maxcode - 1) >> 2) - 1, -1)


def _sweep_kernel(s1_ref, s2_ref, tab_ref, out_ref, *, tile_o: int,
                  chunk: int, nchunks: int, shared: bool):
    q = pl.program_id(0)
    o0 = pl.program_id(1) * tile_o
    row = 0 if shared else q
    shape = (chunk, tile_o)
    win = (o0 + jax.lax.broadcasted_iota(jnp.int32, shape, 0)
           + jax.lax.broadcasted_iota(jnp.int32, shape, 1))

    def step(c, acc):
        w03, w12, mx = acc
        base = c * chunk
        a = s1_ref[row, win + base]                      # (C, TO) Seq1 codes
        b = s2_ref[q, pl.ds(base, chunk)]                # (C,) Seq2 codes
        code = tab_ref[b[:, None] * 32 + a]              # (C, TO) pair codes
        slot = code & 3        # 1 = cls0, 2 = cls1, 3 = cls2, 0 = cls3/inert
        inc = jax.lax.shift_left(1, (slot & 1) * 16)
        w03 = w03 + jnp.where((slot < 2) & (code > 0), inc, 0)
        w12 = w12 + jnp.where(slot >= 2, inc, 0)
        return w03, w12, jnp.maximum(mx, code)

    zeros = jnp.zeros(shape, jnp.int32)
    mx = zeros
    tot = [jnp.zeros((tile_o,), jnp.int32) for _ in range(4)]
    for s in range(0, nchunks, SEGMENT):
        w03, w12, mx = jax.lax.fori_loop(
            s, min(s + SEGMENT, nchunks), step, (zeros, zeros, mx))
        lo = 0xFFFF
        tot[3] += jnp.sum(w03 & lo, axis=0)
        tot[0] += jnp.sum(jax.lax.shift_right_logical(w03, 16), axis=0)
        tot[1] += jnp.sum(w12 & lo, axis=0)
        tot[2] += jnp.sum(jax.lax.shift_right_logical(w12, 16), axis=0)
    cols = pl.ds(o0, tile_o)
    for k in range(4):
        out_ref[q, k, cols] = tot[k]
    out_ref[q, 4, cols] = maxrank_from_maxcode(jnp.max(mx, axis=0))


@functools.partial(jax.jit, static_argnames=("interpret",))
def sweep_stats5(s1, s2, code_t, *, interpret: bool = False):
    """Batched sweep -> (B, 5, noff_pad) int32 statistics.

    s1: (B, l1k) or (1, l1k) int32 Seq1 codes (one row = shared by every
    query); s2: (B, l2p) int32 Seq2 codes; code_t: `code_table_t(code)`.
    noff_pad = l1k - l2p must be a multiple of TILE_O and l2p of CHUNK
    (ops/common.plan_shapes); padding positions hold PAD_CODE, which is
    inert against every code.
    """
    b, l2p = s2.shape
    b1, l1k = s1.shape
    noff_pad = l1k - l2p
    if b1 not in (1, b):
        raise ValueError(f"Seq1 rows {b1} must be 1 or the batch size {b}")
    if noff_pad <= 0 or noff_pad % TILE_O or l2p % CHUNK:
        raise ValueError(f"shapes ({l1k}, {l2p}) not padded to tile "
                         f"{TILE_O} x chunk {CHUNK}")
    kernel = functools.partial(_sweep_kernel, tile_o=TILE_O, chunk=CHUNK,
                               nchunks=l2p // CHUNK, shared=b1 == 1)
    return pl.pallas_call(
        kernel,
        grid=(b, noff_pad // TILE_O),
        out_shape=jax.ShapeDtypeStruct((b, 5, noff_pad), jnp.int32),
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=NUM_STAGES),
        interpret=interpret,
        name="psa_sweep",
    )(s1.astype(jnp.int32), s2.astype(jnp.int32), code_t)


def offset_stats_pallas(codes1: np.ndarray, codes2: np.ndarray, tables,
                        interpret: bool | None = None):
    """Per-offset (counts (noff, 4), maxrank (noff,)) of one query through
    the device kernel (see ops/device.sweep_kernel for `interpret`)."""
    from psa.core.alphabet import pad_codes
    from psa.ops.common import plan_shapes
    from psa.ops.device import sweep_kernel

    noff, _, l2p, l1k = plan_shapes(len(codes1), len(codes2))
    out = np.asarray(sweep_kernel(interpret)(
        jnp.asarray(pad_codes(codes1, l1k))[None],
        jnp.asarray(pad_codes(codes2, l2p))[None],
        code_table_t(tables.code)))[0]
    return out[:4, :noff].T.copy(), out[4, :noff]
