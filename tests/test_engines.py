"""Differential tests: every device engine must reproduce the numpy oracle's
integer statistics and the end-to-end winner on randomized inputs
(SURVEY.md §4 implication (2))."""

import numpy as np
import pytest

from psa.core.alphabet import decode
from psa.core.oracle import offset_stats_numpy
from psa.core.tables import build_tables
from psa.models.search import AlignmentSearchEngine

from conftest import random_codes

ENGINES = ["xla", "conv", "pallas"]

WEIGHT_SETS = [
    (1.0, 3.0, 4.0, 2.0),   # golden weights
    (5.0, 1.0, 1.0, 1.0),   # ties between dot/space diffs
    (2.0, 2.0, 2.0, 2.0),   # everything ties
    (1.5, 0.25, 3.75, 0.5), # exact binary fractions
    (-1.0, 2.0, -3.0, 4.0), # negative weights (legal per fscanf %lf)
]


def stats_fn(name, tables):
    if name == "xla":
        from psa.ops.engine_xla import offset_stats_xla

        return lambda c1, c2: offset_stats_xla(c1, c2, tables)
    if name == "conv":
        from psa.ops.engine_conv import offset_stats_conv

        return lambda c1, c2: offset_stats_conv(c1, c2, tables)
    if name == "pallas":
        from psa.ops.pallas_sweep import offset_stats_pallas

        return lambda c1, c2: offset_stats_pallas(c1, c2, tables)
    raise AssertionError(name)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("is_max", [True, False])
def test_stats_match_oracle_random(engine, is_max):
    rng = np.random.default_rng(42 + is_max)
    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), is_max)
    fn = stats_fn(engine, tables)
    for n1, n2 in [(300, 40), (845, 400), (513, 512)]:
        c1 = random_codes(rng, n1)
        c2 = random_codes(rng, n2)
        counts, maxrank = fn(c1, c2)
        counts_ref, maxrank_ref = offset_stats_numpy(c1, c2, tables)
        np.testing.assert_array_equal(counts, counts_ref)
        np.testing.assert_array_equal(maxrank, maxrank_ref)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("weights", WEIGHT_SETS)
def test_end_to_end_matches_oracle(engine, weights):
    rng = np.random.default_rng(hash(weights) % 2**32)
    for is_max in (True, False):
        c1 = random_codes(rng, 700)
        c2 = random_codes(rng, 150)
        ref = AlignmentSearchEngine(weights, is_max, backend="numpy").search_codes(c1, c2)
        got = AlignmentSearchEngine(weights, is_max, backend=engine).search_codes(c1, c2)
        assert got == ref


@pytest.mark.parametrize("engine", ENGINES)
def test_degenerate_shapes(engine):
    """len1 == len2, single-char seq2, all-identical chars, hyphen runs."""
    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    fn = stats_fn(engine, tables)
    cases = [
        (np.zeros(64, np.int32), np.zeros(64, np.int32)),          # identical, len1==len2
        (np.arange(26, dtype=np.int32).repeat(3), np.array([0], np.int32)),  # 1-char seq2
        (np.full(100, 26, np.int32), np.full(30, 26, np.int32)),   # all hyphens
    ]
    for c1, c2 in cases:
        counts, maxrank = fn(c1, c2)
        counts_ref, maxrank_ref = offset_stats_numpy(c1, c2, tables)
        np.testing.assert_array_equal(counts, counts_ref)
        np.testing.assert_array_equal(maxrank, maxrank_ref)


@pytest.mark.parametrize("engine", ENGINES)
def test_lenient_other_chars(engine):
    """Out-of-alphabet codes (OTHER_CODE) must weigh 0 and never substitute,
    in every engine — the reference's defined out-of-range behavior
    (cuda_funcs.cu:428-429, 451)."""
    from psa.core.alphabet import OTHER_CODE

    rng = np.random.default_rng(77)
    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    fn = stats_fn(engine, tables)
    c1 = random_codes(rng, 500)
    c2 = random_codes(rng, 120)
    c1[::7] = OTHER_CODE
    c2[::11] = OTHER_CODE
    counts, maxrank = fn(c1, c2)
    counts_ref, maxrank_ref = offset_stats_numpy(c1, c2, tables)
    np.testing.assert_array_equal(counts, counts_ref)
    np.testing.assert_array_equal(maxrank, maxrank_ref)


@pytest.mark.parametrize("engine", ENGINES)
def test_golden_through_engine(engine, golden_query, golden_expected):
    from psa.utils.io import format_output

    eng = AlignmentSearchEngine(golden_query.weights, golden_query.is_max, backend=engine)
    res = eng.search(golden_query.seq1, golden_query.seq2)
    got = format_output(res.mutant(golden_query.seq2), res.offset, res.score)
    assert got == golden_expected


def test_pallas_decode_matches_oracle_multi_tile():
    """The packed 16-bit class counters must decode bit-identically to the
    oracle across several chunks and tiles (interpret mode)."""
    import jax.numpy as jnp

    from psa.core.alphabet import pad_codes
    from psa.ops.common import CHUNK, TILE_O, plan_shapes
    from psa.ops.pallas_sweep import code_table_t, sweep_stats5

    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    rng = np.random.default_rng(37)
    c1 = random_codes(rng, 3000)
    c2 = random_codes(rng, 500)
    noff, noff_pad, l2p, l1k = plan_shapes(3000, 500)
    assert noff_pad // TILE_O > 1 and l2p // CHUNK > 1
    out = np.asarray(sweep_stats5(
        jnp.asarray(pad_codes(c1, l1k))[None],
        jnp.asarray(pad_codes(c2, l2p))[None],
        code_table_t(tables.code), interpret=True))[0]
    rc, rm = offset_stats_numpy(c1, c2, tables)
    np.testing.assert_array_equal(out[:4, :noff].T, rc)
    np.testing.assert_array_equal(out[4, :noff], rm)
