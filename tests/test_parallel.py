"""Multi-chip sharding tests on the virtual 8-device CPU mesh
(SURVEY.md §4 implication (3): shard-merge must equal the single-chip result,
independent of device count)."""

import jax
import numpy as np
import pytest

from psa.core.tables import build_tables
from psa.models.search import AlignmentSearchEngine
from psa.parallel.mesh import (
    device_reduce_winner,
    make_mesh,
    pad_for_mesh,
    search_sharded,
    sharded_offset_stats,
)

from conftest import random_codes


@pytest.fixture(scope="module")
def tables_min():
    return build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)


def _need_devices(n: int) -> None:
    """Multi-device cases need the virtual 8-device CPU mesh; on a card
    (`-m gpu` runs) they skip with the reason instead of failing an
    environment assumption."""
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices, have {len(jax.devices())} "
                    "(CPU runs force an 8-device virtual mesh)")


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_sharded_matches_single_chip(n_dev, tables_min):
    _need_devices(n_dev)
    rng = np.random.default_rng(7)
    c1 = random_codes(rng, 4200)
    c2 = random_codes(rng, 150)
    mesh = make_mesh(jax.devices()[:n_dev])
    got = search_sharded(c1, c2, tables_min, mesh)
    ref = AlignmentSearchEngine([1.0, 3.0, 4.0, 2.0], False, backend="numpy").search_codes(c1, c2)
    assert got == ref


@pytest.mark.parametrize("is_max", [True, False])
def test_sharded_stats_match_oracle(is_max):
    from psa.core.oracle import offset_stats_numpy

    rng = np.random.default_rng(13 + is_max)
    tables = build_tables(np.array([2.0, 1.0, 3.0, 0.5]), is_max)
    c1 = random_codes(rng, 2500)
    c2 = random_codes(rng, 300)
    mesh = make_mesh()
    import jax.numpy as jnp

    c1p, c2p, noff = pad_for_mesh(c1, c2, 8)
    stats = np.asarray(sharded_offset_stats(jnp.asarray(c1p), jnp.asarray(c2p), tables, mesh))
    counts_ref, maxrank_ref = offset_stats_numpy(c1, c2, tables)
    np.testing.assert_array_equal(stats[:noff, :4], counts_ref)
    np.testing.assert_array_equal(stats[:noff, 4], maxrank_ref)


def test_device_reduce_matches_host_select(tables_min):
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    c1 = random_codes(rng, 2000)
    c2 = random_codes(rng, 400)
    mesh = make_mesh()
    c1p, c2p, noff = pad_for_mesh(c1, c2, 8)
    stats = sharded_offset_stats(jnp.asarray(c1p), jnp.asarray(c2p), tables_min, mesh)
    best, maxrank, total = device_reduce_winner(jnp.asarray(stats), tables_min, noff)
    ref = AlignmentSearchEngine([1.0, 3.0, 4.0, 2.0], False, backend="numpy").search_codes(c1, c2)
    assert int(best) == ref.offset


def test_sharded_pallas_kernel(tables_min):
    """Force the pallas shard-local kernel (interpret mode on CPU)."""
    rng = np.random.default_rng(11)
    c1 = random_codes(rng, 6000)
    c2 = random_codes(rng, 150)
    mesh = make_mesh()
    got = search_sharded(c1, c2, tables_min, mesh, kernel="pallas")
    ref = AlignmentSearchEngine([1.0, 3.0, 4.0, 2.0], False, backend="numpy").search_codes(c1, c2)
    assert got == ref


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_massive_tie_falls_back_exactly(n_dev, tables_min):
    """>k offsets tie exactly in every shard: the in-graph top-k epilogue
    cannot certify the winner, so search_sharded must take the full-stats
    fallback and still return the canonical lowest-offset winner."""
    _need_devices(n_dev)
    c1 = np.zeros(4200, np.int32)   # all 'A': every offset ties exactly
    c2 = np.zeros(150, np.int32)    # shapes shared with the ladder test
    mesh = make_mesh(jax.devices()[:n_dev])
    got = search_sharded(c1, c2, tables_min, mesh)
    ref = AlignmentSearchEngine([1.0, 3.0, 4.0, 2.0], False,
                                backend="numpy").search_codes(c1, c2)
    assert got == ref
    assert got.offset == 0          # is_swapable: lowest offset on ties


@pytest.mark.parametrize("n_op,n_ch",
                         [(1, 1), (1, 2), (2, 2), (1, 4), (4, 2), (2, 4),
                          (1, 8)])
def test_sharded_2d_full_winner_parity(n_op, n_ch, tables_min):
    """Full winner-tuple parity for the 2-D (offset x char) mesh at every
    shape covering 1/2/4/8 devices: class counts psum_scatter over the
    char axis, ranks pmax — exact by construction, so the winner must
    bit-match the oracle at any mesh shape (VERDICT r4 #2)."""
    from psa.parallel.mesh import make_mesh_2d, search_sharded_2d

    _need_devices(n_op * n_ch)
    rng = np.random.default_rng(29)
    c1 = random_codes(rng, 3000)
    c2 = random_codes(rng, 700)
    mesh = make_mesh_2d(jax.devices(), n_op, n_ch)
    # kernel="xla": the reduction/merge logic under test is orthogonal to
    # the sweep kernel; the pallas 2-D path is covered once below
    got = search_sharded_2d(c1, c2, tables_min, mesh, kernel="xla")
    ref = AlignmentSearchEngine([1.0, 3.0, 4.0, 2.0], False,
                                backend="numpy").search_codes(c1, c2)
    assert got == ref


def test_sharded_2d_pallas_kernel_and_max_mode():
    from psa.parallel.mesh import make_mesh_2d, search_sharded_2d

    _need_devices(8)
    rng = np.random.default_rng(31)
    t = build_tables(np.array([2.0, 1.0, 3.0, 0.5]), True)
    # (4000, 400) on a (4, 2) mesh: per-shard sweep (per_op 1024, lc 256)
    # lands in the suite's canonical (1024, l2p 256) compile family
    c1 = random_codes(rng, 4000)
    c2 = random_codes(rng, 400)
    got = search_sharded_2d(c1, c2, t, make_mesh_2d(jax.devices(), 4, 2),
                            kernel="pallas")
    ref = AlignmentSearchEngine([2.0, 1.0, 3.0, 0.5], True,
                                backend="numpy").search_codes(c1, c2)
    assert got == ref


def test_sharded_2d_two_weight_vectors_no_cache_collision():
    """Two different weight vectors on the same (mode, shapes, mesh) must
    NOT share a compiled 2-D program (the epilogue bakes the tables as
    constants; regression: the cache key once omitted the weights)."""
    from psa.parallel.mesh import make_mesh_2d, search_sharded_2d

    _need_devices(4)
    rng = np.random.default_rng(41)
    c1 = random_codes(rng, 2000)
    c2 = random_codes(rng, 400)
    mesh = make_mesh_2d(jax.devices()[:4], 2, 2)
    for w in ([1.0, 3.0, 4.0, 2.0], [5.0, 0.5, 2.0, 9.0]):
        got = search_sharded_2d(c1, c2, build_tables(np.array(w), False),
                                mesh)
        ref = AlignmentSearchEngine(w, False,
                                    backend="numpy").search_codes(c1, c2)
        assert got == ref, w


def test_sharded_2d_massive_tie_falls_back_exactly(tables_min):
    """All-'A' input: every offset ties exactly, the per-shard top-k cannot
    certify, and the 2-D path must fall back and still return the
    canonical lowest-offset winner."""
    from psa.parallel.mesh import make_mesh_2d, search_sharded_2d

    _need_devices(8)
    c1 = np.zeros(4000, np.int32)
    c2 = np.zeros(600, np.int32)
    got = search_sharded_2d(c1, c2, tables_min,
                            make_mesh_2d(jax.devices(), 2, 4))
    ref = AlignmentSearchEngine([1.0, 3.0, 4.0, 2.0], False,
                                backend="numpy").search_codes(c1, c2)
    assert got == ref
    assert got.offset == 0


def test_choose_mesh_shape_regimes():
    """Long-Seq1 stays offset-sharded (no collectives); the north-star
    small-noff regime gets a char axis; short Seq2 cannot split below
    256-char chunks."""
    from psa.ops.common import CHUNK, round_up
    from psa.parallel.mesh import choose_mesh_shape

    assert choose_mesh_shape(8, 90001, 500) == (8, 1)
    n_op, n_ch = choose_mesh_shape(8, 90001, 10000)
    assert n_ch > 1
    assert choose_mesh_shape(1, 90001, 10000) == (1, 1)
    for ndev in (1, 2, 4, 8):
        n_op, n_ch = choose_mesh_shape(ndev, 7581, 2131)
        assert n_op * n_ch == ndev
        lc = round_up(max(2131, CHUNK * n_ch), CHUNK * n_ch) // n_ch
        assert n_ch == 1 or lc >= 256


def test_search_sharded_auto_env_override(monkeypatch, tables_min):
    from psa.parallel.mesh import search_sharded_auto

    _need_devices(8)
    rng = np.random.default_rng(37)
    c1 = random_codes(rng, 2000)
    c2 = random_codes(rng, 400)
    ref = AlignmentSearchEngine([1.0, 3.0, 4.0, 2.0], False,
                                backend="numpy").search_codes(c1, c2)
    monkeypatch.setenv("PSA_MESH_SHAPE", "2,4")
    assert search_sharded_auto(c1, c2, tables_min) == ref
    monkeypatch.setenv("PSA_MESH_SHAPE", "3,2")
    with pytest.raises(ValueError):
        search_sharded_auto(c1, c2, tables_min)


def test_sharded_no_mutation_raises():
    """Out-of-range chars everywhere (lenient input): no shard finds a
    legal substitution -> NoMutationFound through the top-k merge."""
    from psa.core.result import NoMutationFound

    t = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), True)
    c1 = np.full(3000, 27, np.int32)
    c2 = np.full(300, 27, np.int32)
    with pytest.raises(NoMutationFound):
        search_sharded(c1, c2, t, make_mesh())
