"""Chunked gather engine — plain jnp under jit.

The straightforward XLA formulation of the sweep: per offset block, gather the
Seq1 windows and look pair codes up in the fused 32x32 table.  It is the
portable differential reference of the sweep kernel (ops/pallas_sweep.py):
same (5, noff_pad) statistics rows, exact integer outputs, any platform.

Replaces the reference CPU engine's per-offset loops (cpu_funcs.c:222-300) —
the substitution scan is gone entirely, folded into the code table.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from psa.core.tables import ScoringTables
from psa.ops.common import TILE_O, plan_shapes


def stats_from_codevals(codeval: jnp.ndarray):
    """Decode fused code values -> (counts (..., 4) i32, maxrank (...,) i32).

    codeval: int32 array (..., n2-axis last); 0 = inert.
    """
    valid = codeval > 0
    v = codeval - 1
    cls = jnp.where(valid, v & 3, -1)
    counts = jnp.stack(
        [(cls == k).sum(axis=-1, dtype=jnp.int32) for k in range(4)], axis=-1
    )
    rank = jnp.where(valid, (v >> 2) - 1, -1)
    maxrank = rank.max(axis=-1)
    return counts, maxrank


def local_stats_xla(c1, c2p, code_flat, noff_pad: int, block: int = TILE_O):
    """(5, noff_pad) int32 statistics rows of offsets [0, noff_pad): rows
    0-3 class counts, row 4 maxrank — the sweep kernel's contract.

    c1: (>= noff_pad + l2p - 1,) int32 codes; c2p: (l2p,) int32 codes;
    code_flat: (1024,) int32 fused table, row-major (Seq1 code major)."""
    l2p = c2p.shape[0]

    def body(b):
        offs = b * block + jnp.arange(block)
        win = c1[offs[:, None] + jnp.arange(l2p)[None, :]]
        codeval = code_flat[win * 32 + c2p[None, :]].astype(jnp.int32)
        counts, maxrank = stats_from_codevals(codeval)
        return jnp.concatenate([counts.T, maxrank[None]], axis=0)

    out = jax.lax.map(body, jnp.arange(noff_pad // block))   # (nb, 5, block)
    return out.transpose(1, 0, 2).reshape(5, noff_pad)


@partial(jax.jit, static_argnames=("noff_pad",))
def _sweep(codes1p, codes2p, code_flat, noff_pad: int):
    return local_stats_xla(codes1p, codes2p, code_flat, noff_pad)


def offset_stats_xla(codes1: np.ndarray, codes2: np.ndarray, tables: ScoringTables):
    from psa.core.alphabet import pad_codes

    noff, noff_pad, l2p, l1k = plan_shapes(codes1.shape[0], codes2.shape[0])
    code_flat = jnp.asarray(tables.code.reshape(-1).astype(np.int32))
    stats = np.asarray(_sweep(jnp.asarray(pad_codes(codes1, l1k)),
                              jnp.asarray(pad_codes(codes2, l2p)), code_flat,
                              noff_pad))
    return stats[:4, :noff].T, stats[4, :noff]
