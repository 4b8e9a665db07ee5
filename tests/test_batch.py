"""Batched multi-query search over the 2-D (dp x op) mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from psa.core.alphabet import pad_codes
from psa.core.oracle import offset_stats_numpy
from psa.core.tables import build_tables
from psa.models.batch import (
    batched_device_winners,
    batched_sharded_stats,
    batched_search_step,
    make_mesh_2d,
)
from psa.ops.select import select_best

from conftest import random_codes


@pytest.fixture(scope="module")
def tables():
    return build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)


def _make_batch(rng, B, l1p, l2p, n1, n2):
    c1b = np.stack([pad_codes(random_codes(rng, n1), l1p) for _ in range(B)])
    c2b = np.stack([pad_codes(random_codes(rng, n2), l2p) for _ in range(B)])
    noffs = np.full(B, n1 - n2 + 1, np.int32)
    return c1b, c2b, noffs


def _need_devices(n: int) -> None:
    """2-D mesh cases need the virtual 8-device CPU mesh; on real hardware
    (1 chip) they skip instead of failing an environment assumption."""
    import jax

    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices, have {len(jax.devices())} "
                    "(CPU runs force an 8-device virtual mesh)")


@pytest.mark.parametrize("dp,op", [(2, 4), (4, 2), (1, 8), (8, 1)])
def test_batched_winners_match_oracle(dp, op, tables):
    _need_devices(dp * op)
    rng = np.random.default_rng(21)
    mesh = make_mesh_2d(dp, op)
    block = 64
    l2p, n1, n2 = 128, 1100, 120
    noff_pad = op * block * ((1100 - 120 + 1 + op * block - 1) // (op * block))
    l1p = noff_pad + l2p
    B = 2 * dp
    c1b, c2b, noffs = _make_batch(rng, B, l1p, l2p, n1, n2)

    with mesh:
        step = jax.jit(batched_search_step(tables, mesh, block=block))
        offsets, maxranks, totals = step(
            jnp.asarray(c1b), jnp.asarray(c2b), jnp.asarray(noffs)
        )

    for q in range(B):
        counts, maxrank = offset_stats_numpy(c1b[q][: n1], c2b[q][: n2], tables)
        ref = select_best(counts, maxrank, tables, c1b[q][: n1], c2b[q][: n2])
        assert int(offsets[q]) == ref.offset, q
        assert int(maxranks[q]) == int(maxrank[ref.offset]), q


def test_batched_stats_exact(tables):
    _need_devices(8)
    rng = np.random.default_rng(33)
    mesh = make_mesh_2d(2, 4)
    block = 64
    l2p, n1, n2 = 128, 600, 90
    noff_pad = 4 * block * 2
    l1p = noff_pad + l2p
    c1b, c2b, noffs = _make_batch(rng, 2, l1p, l2p, n1, n2)
    with mesh:
        stats = np.asarray(
            batched_sharded_stats(jnp.asarray(c1b), jnp.asarray(c2b), tables,
                                  mesh, block=block)
        )
    for q in range(2):
        counts, maxrank = offset_stats_numpy(c1b[q][: n1], c2b[q][: n2], tables)
        noff = n1 - n2 + 1
        np.testing.assert_array_equal(stats[q, :noff, :4], counts)
        np.testing.assert_array_equal(stats[q, :noff, 4], maxrank)
