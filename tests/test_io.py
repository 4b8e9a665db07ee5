"""I/O contract tests (tokenizer + %g writer, cpu_funcs.c:353-378)."""

import numpy as np
import pytest

from psa.utils.io import format_output, parse_input


def test_parse_basic():
    q = parse_input("1 3 4 2\nABC\nAB\nmaximum\n")
    assert list(q.weights) == [1, 3, 4, 2]
    assert q.seq1 == "ABC" and q.seq2 == "AB"
    assert q.is_max


def test_parse_extra_tokens_ignored():
    q = parse_input("1 3 4 2 ABC AB minimum 5 6 GARBAGE maximum")
    assert not q.is_max
    assert q.seq2 == "AB"


def test_parse_mode_fallback_to_min():
    # anything that isn't exactly "maximum" is minimum (cpu_funcs.c:365)
    assert not parse_input("1 2 3 4 AA A Maximum").is_max
    assert not parse_input("1 2 3 4 AA A banana").is_max


def test_parse_scientific_weights():
    q = parse_input("1e2 0.5 -3 +4. AA A maximum")
    assert list(q.weights) == [100.0, 0.5, -3.0, 4.0]


def test_parse_rejects_seq2_longer():
    with pytest.raises(ValueError):
        parse_input("1 2 3 4 AA AAA maximum")


@pytest.mark.parametrize("bad", ["inf", "-inf", "nan", "NAN", "1e999"])
def test_parse_rejects_non_finite_weights(bad):
    # C fscanf %lf accepts these too, but downstream they'd corrupt the
    # rank tables silently — defined behavior is rejection at parse time
    with pytest.raises(ValueError, match="finite"):
        parse_input(f"{bad} 2 3 4 AA A maximum")


def test_parse_cases_rejects_non_finite_weights():
    from psa.utils.io import parse_cases

    with pytest.raises(ValueError, match="finite"):
        parse_cases("1 2 3 4 AAA AA minimum  1 nan 3 4 BBB BB maximum")


def test_build_tables_rejects_non_finite_weights():
    from psa.core.tables import build_tables

    with pytest.raises(ValueError, match="finite"):
        build_tables(np.array([1.0, np.inf, 3.0, 4.0]), is_max=False)
    with pytest.raises(ValueError, match="finite"):
        build_tables(np.array([1.0, 2.0, np.nan, 4.0]), is_max=True)


def test_search_batch_rejects_non_finite_weights():
    from psa.models.batch import search_batch
    from psa.utils.io import Query

    q = Query(weights=np.array([1.0, np.nan, 3.0, 4.0]),
              seq1="ABCD", seq2="AB", is_max=False)
    with pytest.raises(ValueError, match="finite"):
        search_batch([q], backend="numpy")


@pytest.mark.parametrize(
    "score,expect",
    [
        (-4879.0, "-4879"),
        (0.0, "0"),
        (1234567.0, "1.23457e+06"),  # %g switches to scientific at 6 sig digits
        (0.0001, "0.0001"),
        (123456.0, "123456"),
        (-0.5, "-0.5"),
    ],
)
def test_g_formatting_matches_c(score, expect):
    assert format_output("X", 1, score) == "X\n1 " + expect


def test_no_trailing_newline():
    assert not format_output("AB", 3, 7.0).endswith("\n")
