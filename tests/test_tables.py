"""Unit tests for the scoring/substitution tables against the reference rules."""

import numpy as np
import pytest

from psa.core import tables as T
from psa.core.alphabet import HYPHEN_CODE, NUM_LETTERS, OTHER_CODE, PAD_CODE, encode


def code(ch: str) -> int:
    return int(encode(ch)[0])


def test_sign_table_basic_rules():
    s = T._SIGN
    # symmetry (the reference mirrors the lower triangle, cuda_funcs.cu:431-438)
    assert (s == s.T).all()
    # identity
    for a in range(NUM_LETTERS):
        assert s[a, a] == T.SIGN_AST
    # hyphen rules (cuda_funcs.cu:426-427)
    assert s[HYPHEN_CODE, HYPHEN_CODE] == T.SIGN_AST
    for a in range(NUM_LETTERS):
        assert s[HYPHEN_CODE, a] == T.SIGN_SPACE
    # hyphen beats the range check: '-' vs out-of-range is SPACE
    assert s[HYPHEN_CODE, OTHER_CODE] == T.SIGN_SPACE
    # out-of-range chars weigh nothing (cuda_funcs.cu:428-429)
    assert s[OTHER_CODE, 0] == T.SIGN_NONE
    assert s[OTHER_CODE, OTHER_CODE] == T.SIGN_NONE
    # padding is inert against everything
    assert (s[PAD_CODE, :] == T.SIGN_NONE).all()
    assert (s[:, PAD_CODE] == T.SIGN_NONE).all()


def test_sign_table_group_examples():
    s = T._SIGN
    # conservative: N and D share NDEQ
    assert s[code("N"), code("D")] == T.SIGN_COLON
    # the coded (not README) semi-conservative group SGND (SURVEY.md Q1)
    assert s[code("G"), code("D")] == T.SIGN_DOT
    # M and S share no group in the code (README's MSGNDILV would say DOT)
    assert s[code("M"), code("S")] == T.SIGN_SPACE
    # semi-conservative example: F and V share FVLIM
    assert s[code("F"), code("V")] == T.SIGN_DOT


@pytest.mark.parametrize("is_max", [True, False])
def test_substitution_legality(is_max):
    """No substitution may be conservative with the original character
    (cuda_funcs.cu:417), except the documented identity fallbacks."""
    w = np.array([1.0, 3.0, 4.0, 2.0])
    t = T.build_tables(w, is_max)
    for c1 in range(T.NCODES):
        for c2 in range(T.NCODES):
            sc = t.sub[c1, c2]
            if sc < 0:
                continue
            # identity fallbacks return c1, legal because sign(c1,c2) != COLON
            # in those paths
            assert t.sign[c2, sc] != T.SIGN_COLON


def test_max_mode_dot_space_take_identity():
    w = np.array([1.0, 3.0, 4.0, 2.0])
    t = T.build_tables(w, True)
    for c1 in range(NUM_LETTERS):
        for c2 in range(NUM_LETTERS):
            sg = t.sign[c1, c2]
            if sg in (T.SIGN_DOT, T.SIGN_SPACE):
                assert t.sub[c1, c2] == c1
                # delta = +w1 - (old negative weight)
                old = -w[2] if sg == T.SIGN_DOT else -w[3]
                assert t.diff[c1, c2] == w[0] - old


def test_min_mode_fallback_raises_score():
    """MIN-mode '.'/'_' fallback to identity raises the score
    (cuda_funcs.cu:385-392) — the diff must still be representable/ranked."""
    # weights that force missing colon/dot candidates for some pairs
    w = np.array([1.0, 3.0, 4.0, 2.0])
    t = T.build_tables(w, False)
    # Hyphen vs letter: sign SPACE; colon/dot subs against '-' never exist,
    # space subs exist (any letter not conservative with c2) -> chosen by diff.
    c1 = HYPHEN_CODE
    for c2 in range(NUM_LETTERS):
        assert t.sub[c1, c2] >= 0


def test_rank_orders_strictly_better():
    for is_max in (True, False):
        t = T.build_tables(np.array([1.0, 3.0, 4.0, 2.0]), is_max)
        vals = t.diff_vals
        assert len(np.unique(vals)) == len(vals)
        if is_max:
            assert (np.diff(vals) > 0).all()  # higher rank = larger diff
        else:
            assert (np.diff(vals) < 0).all()  # higher rank = smaller diff


def test_code_table_roundtrip():
    for is_max in (True, False):
        t = T.build_tables(np.array([2.0, 1.5, 0.5, 3.0]), is_max)
        for c1 in range(T.NCODES):
            for c2 in range(T.NCODES):
                v = int(t.code[c1, c2])
                if t.sign[c1, c2] == T.SIGN_NONE:
                    assert v == 0
                    continue
                assert v >= 1
                assert (v - 1) & 3 == t.sign[c1, c2]
                assert ((v - 1) >> 2) - 1 == t.rank[c1, c2]


def test_weight_sign_mapping():
    w = np.array([1.0, 3.0, 4.0, 2.0])
    t = T.build_tables(w, True)
    a, b = code("A"), code("A")
    assert t.pair_w[a, b] == 1.0            # '*' -> +w1
    assert t.pair_w[code("N"), code("D")] == -3.0   # ':' -> -w2
    assert t.pair_w[code("G"), code("D")] == -4.0   # '.' -> -w3
    assert t.pair_w[code("W"), code("C")] == -2.0   # '_' -> -w4
