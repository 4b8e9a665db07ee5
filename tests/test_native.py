"""Native C++ engine: bit-parity with the Python oracle and golden output."""

import numpy as np
import pytest

from psa.core.alphabet import encode
from psa.core.oracle import offset_stats_numpy, score_offset_sequential
from psa.core.tables import build_tables
from psa.models.search import AlignmentSearchEngine

from conftest import random_codes


@pytest.fixture(scope="module", autouse=True)
def lib():
    try:
        from psa.native import get_lib

        return get_lib()
    except Exception as e:  # toolchain missing -> skip module
        pytest.skip(f"native build unavailable: {e}")


def test_native_golden(golden_query, golden_expected):
    from psa.utils.io import format_output

    eng = AlignmentSearchEngine(golden_query.weights, golden_query.is_max,
                                backend="native")
    res = eng.search(golden_query.seq1, golden_query.seq2)
    got = format_output(res.mutant(golden_query.seq2), res.offset, res.score)
    assert got == golden_expected


@pytest.mark.parametrize("is_max", [True, False])
@pytest.mark.parametrize("nthreads", [1, 4])
def test_native_matches_oracle_random(is_max, nthreads):
    from psa.native import search_native

    rng = np.random.default_rng(5 + is_max)
    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), is_max)
    for trial in range(5):
        c1 = random_codes(rng, 800)
        c2 = random_codes(rng, 200)
        got = search_native(c1, c2, tables, nthreads=nthreads)
        ref = AlignmentSearchEngine([1.0, 3.0, 4.0, 2.0], is_max,
                                    backend="numpy").search_codes(c1, c2)
        assert got == ref


def test_native_stats_contract():
    from psa.native import offset_stats_native

    rng = np.random.default_rng(9)
    tables = build_tables(np.array([2.0, 0.5, 1.5, 3.0]), True)
    c1 = random_codes(rng, 1500)
    c2 = random_codes(rng, 400)
    cn, mn = offset_stats_native(c1, c2, tables)
    cr, mr = offset_stats_numpy(c1, c2, tables)
    np.testing.assert_array_equal(cn, cr)
    np.testing.assert_array_equal(mn, mr)


def test_native_score_offset_matches_python():
    from psa.native import score_offset_native

    rng = np.random.default_rng(17)
    tables = build_tables(np.array([1.25, 3.5, 4.75, 2.125]), False)
    c1 = random_codes(rng, 600)
    c2 = random_codes(rng, 100)
    for o in [0, 17, 250, 500]:
        tn = score_offset_native(c1, c2, tables, o)
        tp = score_offset_sequential(c1, c2, tables, o)
        assert tn[0] == tp[0] and tn[1] == tp[1] and tn[2] == tp[2]
