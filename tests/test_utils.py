"""Tests for rendering, generation, profiling, and config utilities."""

import numpy as np
import pytest

from psa.core.alphabet import encode
from psa.core.tables import build_tables
from psa.models.search import AlignmentSearchEngine
from psa.utils.generator import random_sequences, write_input_file
from psa.utils.io import parse_input
from psa.utils.pretty import render, render_sign_table, score_and_signs
from psa.utils.profiling import Timer, pair_evals, throughput


def test_sign_table_render_shape_and_rules():
    out = render_sign_table()
    lines = out.splitlines()
    assert len(lines) == 2 + 27          # header, rule, 27 rows
    rows = lines[2:]
    assert rows[0].startswith("A |*")    # A vs A = '*'
    assert rows[-1].startswith("- |")
    # hyphen row: SPACE against all letters, '*' against itself
    hyphen = rows[-1][3:].split(" ")
    assert hyphen[:26] == ["_"] * 26 and hyphen[26] == "*"
    # symmetric
    mat = [r[3:].split(" ") for r in rows]
    for i in range(27):
        for j in range(27):
            assert mat[i][j] == mat[j][i]


def test_score_and_signs_consistent_with_result():
    s1, s2 = random_sequences(400, 90, seed=8)
    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    c1, c2 = encode(s1), encode(s2)
    score, signs = score_and_signs(c1, c2, tables, 10)
    assert len(signs) == 90
    # score equals the sum implied by the sign string
    w = {"*": 1.0, ":": -3.0, ".": -4.0, "_": -2.0}
    assert score == sum(w[ch] for ch in signs)


def test_render_explanation_scores_match_search():
    s1, s2 = random_sequences(300, 60, seed=5)
    q = parse_input("1 3 4 2 %s %s minimum" % (s1, s2))
    res = AlignmentSearchEngine(q.weights, q.is_max, backend="numpy").search(s1, s2)
    text = render(q, res, color=False)
    assert ("Mutation Score: %g" % res.score) in text
    assert "Minimum problem" in text


def test_generator_reproducible_and_valid():
    a1, a2 = random_sequences(100, 30, seed=7, hyphen_p=0.2)
    b1, b2 = random_sequences(100, 30, seed=7, hyphen_p=0.2)
    assert a1 == b1 and a2 == b2
    assert "-" in a1 + a2
    from psa.core.alphabet import validate

    assert validate(a1) and validate(a2)


def test_write_input_roundtrip(tmp_path):
    s1, s2 = random_sequences(50, 20, seed=1)
    p = tmp_path / "in.txt"
    write_input_file(str(p), [1.5, 2, 3, 4], s1, s2, True)
    q = parse_input(p.read_text())
    assert q.seq1 == s1 and q.seq2 == s2 and q.is_max
    assert list(q.weights) == [1.5, 2, 3, 4]


def test_profiling_timer_and_metrics():
    t = Timer()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    assert t.phases["a"].calls == 2
    assert "a" in t.report()
    assert pair_evals(100, 30) == 71 * 30
    assert throughput(100, 30, 0.5, chips=2) == 71 * 30 / 0.5 / 2


def test_config_env_override(monkeypatch):
    import importlib

    monkeypatch.setenv("PSA_MAX_CANDIDATES", "7")
    import psa.config as cfg

    importlib.reload(cfg)
    assert cfg.EngineConfig().max_candidates == 7
    monkeypatch.delenv("PSA_MAX_CANDIDATES")
    importlib.reload(cfg)


def test_psa_gen_cli(tmp_path):
    """psa-gen writes parseable reference-format files, incl. multi-case."""
    from psa.utils.generator import main as gen_main
    from psa.utils.io import read_cases, read_input

    out = tmp_path / "in.txt"
    assert gen_main(["300", "50", "-o", str(out), "--cases", "3",
                     "--seed", "5", "--mode", "maximum",
                     "--weights", "2,1,1,5"]) == 0
    cases = read_cases(str(out))
    assert len(cases) == 3
    assert all(q.is_max and len(q.seq1) == 300 and len(q.seq2) == 50
               for q in cases)
    assert list(cases[0].weights) == [2.0, 1.0, 1.0, 5.0]
    assert cases[0].seq1 != cases[1].seq1          # per-case seeds differ
    assert read_input(str(out)).seq1 == cases[0].seq1
    assert gen_main(["300", "50", "-o", str(out), "--weights", "1 2 3"]) == 2
    assert gen_main(["50", "300", "-o", str(out)]) == 2   # n2 > n1


def test_encode_batch_padded_matches_per_query():
    """Batch encode (int8 wire format) == per-sequence encode + pad."""
    import numpy as np

    from psa.core.alphabet import encode, encode_batch_padded, pad_codes

    seqs = ["ABC-Z", "", "QWERTY", "A" * 64, "-" * 3]
    out = encode_batch_padded(seqs, 64)
    assert out.dtype == np.int8
    for i, s in enumerate(seqs):
        np.testing.assert_array_equal(out[i], pad_codes(encode(s), 64))


def test_validate_batch_matches_per_query():
    import numpy as np

    from psa.core.alphabet import validate, validate_batch

    seqs = ["ABC", "", "A?C", "abc", "----", "Z" * 100, "Z" * 99 + "?"]
    got = validate_batch(seqs)
    want = np.array([validate(s) for s in seqs])
    np.testing.assert_array_equal(got, want)
    # all-valid fast path and empty-list edge
    assert validate_batch(["AB", "CD"]).all()
    assert validate_batch([]).shape == (0,)


def test_build_tables_cached_identity_and_equality():
    import numpy as np

    from psa.core.tables import build_tables, build_tables_cached

    w = np.array([1.0, 3.0, 4.0, 2.0])
    a = build_tables_cached(w, False)
    assert build_tables_cached(list(w), False) is a       # memoized
    assert build_tables_cached(w, True) is not a          # keyed by mode
    b = build_tables(w, False)
    np.testing.assert_array_equal(a.code, b.code)
    np.testing.assert_array_equal(a.pair_w, b.pair_w)
