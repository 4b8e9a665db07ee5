"""Native wire-path fast paths vs their Python reference implementations.

The serving front-end's per-chunk host work (line parse + alphabet
validation, padded encode, 5-bit wire pack) has native C fast paths; the
Python implementations define the semantics.  These tests pin the two
bit-identical on adversarial and randomized chunks, including every line
class the C scanner must hand back to the Python fallback.
"""

from __future__ import annotations

import numpy as np
import pytest

from psa.utils.generator import random_sequences
from psa.utils.io import (Query, _parse_query_lines_native,
                              _parse_query_lines_py, parse_query_lines)

native = pytest.importorskip("psa.native")
if not native.available():
    pytest.skip("native library unavailable (no g++?)", allow_module_level=True)


ADVERSARIAL_LINES = [
    "1 3 4 2 ABCDEF ABC minimum",              # plain valid
    "",                                         # empty -> no reply
    "   \t  ",                                  # whitespace-only -> no reply
    "1 2 3",                                    # too few tokens
    "1 2 3 4 AB ABC maximum",                   # seq2 longer than seq1
    "1 2 3 4 ABmC AB minimum",                  # lowercase -> alphabet error
    "x 2 3 4 AB AB minimum",                    # bad weight -> float error
    "1_0 2 3 4 ABCD AB maximum",                # Python-only float literal
    "0x10 2 3 4 ABCD AB maximum",               # C-only float literal (hex)
    "inf -2.5 1e3 NAN ABCD AB minimum",         # words C hands to Python
    "1e999 2 3 4 ABCD AB minimum",              # overflow -> finite-weights
                                                #   error both ways
    "1e999 2 3 4 AB ABC minimum",               # finite error precedes the
                                                #   seq-order error
    "1e999 2 3 4 AB@ AB minimum",               # ...and the alphabet error
    "1 2 3 4 AB-C A- maximum",                  # hyphens are in-alphabet
    "1 2 3 4 SéQ AB minimum",              # non-ASCII seq
    "1 2 3 4 ABCD AB minimum",             # non-ASCII whitespace
    "1\x1c2 3 4 ABCD AB minimum",               # \x1c IS Python whitespace
    "1 2 3 4 ABCD AB maximum extra junk 9 9",   # trailing tokens ignored
    "1 2 3 4 ABCD AB Maximum",                  # mode is case-sensitive
    "  1  2\t3  4  ABCD  AB  minimum  ",        # run-together whitespace
    "1 2 3 4 AB\x00CD AB minimum",              # NUL inside a sequence
    "+.5 -0. 5. .25 ABCD AB maximum",           # edge float spellings
    "9" * 80 + " 2 3 4 ABCD AB minimum",        # weight token > C buffer
]


def _canon(entries):
    out = []
    for e in entries:
        if isinstance(e, Query):
            # repr-normalize weights so nan == nan compares equal
            out.append(("q", tuple(repr(float(w)) for w in e.weights),
                        e.seq1, e.seq2, e.is_max))
        else:
            out.append(e)
    return out


@pytest.mark.parametrize("check_alphabet", [True, False])
def test_parse_adversarial_matches_python(check_alphabet):
    got = _parse_query_lines_native(ADVERSARIAL_LINES, check_alphabet, native)
    want = _parse_query_lines_py(ADVERSARIAL_LINES, check_alphabet)
    assert _canon(got) == _canon(want)


def test_parse_randomized_matches_python():
    rng = np.random.default_rng(7)
    lines = []
    for i in range(300):
        n1 = int(rng.integers(2, 60))
        n2 = int(rng.integers(1, min(n1, 30) + 1))
        s1, s2 = random_sequences(n1, n2, seed=i)
        w = rng.integers(-5, 6, 4)
        mode = ["maximum", "minimum", "banana"][int(rng.integers(3))]
        lines.append(f"{w[0]} {w[1]} {w[2]}.5 {w[3]}e1 {s1} {s2} {mode}")
    # sprinkle error/blank lines between valid ones
    lines[::17] = [""] * len(lines[::17])
    lines[3::23] = ["1 2 3"] * len(lines[3::23])
    got = _parse_query_lines_native(lines, True, native)
    want = _parse_query_lines_py(lines, True)
    assert _canon(got) == _canon(want)


def test_parse_query_lines_entry_point():
    entries = parse_query_lines(["1 2 3 4 ABCD AB minimum", "", "1 2"])
    assert isinstance(entries[0], Query)
    assert entries[1] is None
    assert entries[2] == "input needs >= 7 whitespace-delimited tokens, got 2"


def test_encode_padded_native_matches_numpy():
    from psa.core.alphabet import _ENC8, PAD_CODE, encode_batch_padded

    rng = np.random.default_rng(3)
    seqs = []
    for i in range(50):
        s1, _ = random_sequences(int(rng.integers(1, 40)), 1, seed=100 + i)
        seqs.append(s1)
    seqs[7] = "AB-Z" * 5
    seqs[9] = "a?\x00~" * 3          # out-of-alphabet bytes still encode
    length = max(len(s) for s in seqs)
    got = encode_batch_padded(seqs, length)   # native path (available())
    # reference: the pure-numpy body
    want = np.full((len(seqs), length), PAD_CODE, np.int8)
    joined = "".join(seqs).encode("ascii", errors="replace")
    codes = _ENC8[np.frombuffer(joined, np.uint8)]
    o = 0
    for i, s in enumerate(seqs):
        want[i, : len(s)] = codes[o: o + len(s)]
        o += len(s)
    assert np.array_equal(got, want)


def test_encode_padded_overlong_raises():
    from psa.core.alphabet import encode_batch_padded

    with pytest.raises(ValueError, match="exceeds padded length"):
        encode_batch_padded(["ABCDE"], 4)


@pytest.mark.parametrize("n", [6, 12, 5, 7, 31])
def test_pack5_native_matches_numpy(n):
    from psa.core.alphabet import PAD_CODE
    from psa.models.batch import _PACK, _packed_words, pack_code_rows

    rng = np.random.default_rng(n)
    codes = rng.integers(0, 29, (9, n)).astype(np.int8)
    got = pack_code_rows(codes)               # native path
    # reference: the numpy shift/OR ladder
    ref_in = codes
    w = _packed_words(n)
    if w * _PACK != n:
        ref_in = np.pad(codes, ((0, 0), (0, w * _PACK - n)),
                        constant_values=PAD_CODE)
    want = ref_in[:, 0::_PACK].astype(np.int32)
    for j in range(1, _PACK):
        want |= ref_in[:, j::_PACK].astype(np.int32) << (5 * j)
    assert np.array_equal(got, want)
