"""One-hot convolution engine — matrix units do the table lookups.

Convolution form of the sweep (SURVEY.md §7.1): the per-offset
statistics are cross-correlations of indicator sequences, so the whole search
collapses into ONE `lax.conv_general_dilated`:

    input   X[j, a]    = onehot(seq1[j])            (L1, 32)  bf16
    kernel  K[i, a, f] = indicator_f(a, seq2[i])    (L2, 32, F) bf16
    output  C[o, f]    = sum_i K[i, seq1[o+i], f]   (noff, F)

with features f = 4 sign-class counters + R substitution-rank counters.
All values are 0/1 and accumulation is f32, so every output is an EXACT
integer (< 2^24): the matrix units perform the brute-force search with zero
float ambiguity.  This replaces the reference's CUDA grid kernel + tree reductions
(cuda_funcs.cu:149-264) with a single compiler-scheduled contraction.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from psa.core.alphabet import NCODES_PAD
from psa.core.tables import ScoringTables
from psa.ops.common import pad_query


@partial(jax.jit, static_argnames=("num_ranks",))
def _sweep_conv(codes1p, codes2p, code_tab, num_ranks: int):
    nfeat = 4 + num_ranks
    x = jax.nn.one_hot(codes1p, NCODES_PAD, dtype=jnp.bfloat16)[None]  # (1, L1, 32)

    # Build the indicator kernel from the fused code table: (L2, 32, F).
    col = code_tab[:, codes2p].astype(jnp.int32)      # (32, L2)
    valid = col > 0
    v = col - 1
    cls = jnp.where(valid, v & 3, -1)                  # (32, L2)
    rank = jnp.where(valid, (v >> 2) - 1, -1)
    feats = [cls == k for k in range(4)]
    feats += [rank == r for r in range(num_ranks)]
    kern = jnp.stack(feats, axis=-1).astype(jnp.bfloat16)  # (32, L2, F)
    kern = kern.transpose(1, 0, 2)                          # (L2, 32, F) = WIO

    out = jax.lax.conv_general_dilated(
        x, kern,
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NWC", "WIO", "NWC"),
        preferred_element_type=jnp.float32,
    )[0]                                                   # (noff_pad, F)
    out = out.astype(jnp.int32)
    counts = out[:, :4]
    rank_counts = out[:, 4:]
    r_iota = jnp.arange(num_ranks, dtype=jnp.int32)[None, :]
    maxrank = jnp.where(rank_counts > 0, r_iota, -1).max(axis=1)
    return counts, maxrank


def offset_stats_conv(codes1: np.ndarray, codes2: np.ndarray, tables: ScoringTables):
    if tables.num_ranks == 0:  # degenerate: no pair admits any substitution
        from psa.core.oracle import offset_stats_numpy

        return offset_stats_numpy(codes1, codes2, tables)
    c1p, c2p, noff = pad_query(codes1, codes2)
    counts, maxrank = _sweep_conv(
        jnp.asarray(c1p), jnp.asarray(c2p), jnp.asarray(tables.code),
        tables.num_ranks,
    )
    return np.asarray(counts)[:noff], np.asarray(maxrank)[:noff]
