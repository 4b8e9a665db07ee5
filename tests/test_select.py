"""Exact-selection hardening tests.

Covers the VERDICT round-1 findings: the candidate set must never be
silently truncated (massive exact ties + non-representable weights must
still reproduce the reference's sequential-semantics winner), and the
`auto` backend must be workload-aware (cpu_funcs.c:135-142 analog).
"""

import numpy as np
import pytest

from psa.core.oracle import (offset_stats_numpy, rescore_candidates,
                                 score_offset_sequential)
from psa.core.tables import build_tables
from psa.models.search import AlignmentSearchEngine, resolve_auto
from psa.ops.select import candidate_epsilon, select_best

IRRATIONAL_WEIGHTS = [np.pi / 4, np.e / 7, np.sqrt(2) / 3, 1.0 / 3.0]


def test_rescore_candidates_matches_sequential():
    rng = np.random.default_rng(7)
    c1 = rng.integers(0, 27, 600).astype(np.int32)
    c2 = rng.integers(0, 27, 150).astype(np.int32)
    for is_max in (False, True):
        t = build_tables(np.asarray(IRRATIONAL_WEIGHTS), is_max)
        cand = np.arange(c1.shape[0] - c2.shape[0] + 1)
        totals, coffs, subs = rescore_candidates(c1, c2, t, cand)
        for o in cand[:: 37].tolist() + [int(cand[-1])]:
            tot, coff, sub, _ = score_offset_sequential(c1, c2, t, o)
            assert totals[o] == tot  # bit-identical f64
            assert coffs[o] == coff and subs[o] == sub


@pytest.mark.parametrize("is_max", [False, True])
def test_massive_tie_irrational_weights(is_max):
    # Periodic seq1 -> every aligned window with the same phase is identical,
    # so > 8192 offsets score exactly alike; with irrational weights the
    # grouped-count totals and sequential totals differ in the last ulps.
    # The winner must still be the reference's: best score, lowest offset.
    reps = 9000
    c1 = np.tile(np.array([0, 1], np.int32), reps + 4)      # ABAB...
    c2 = np.array([0, 1, 0, 1, 0, 1], np.int32)             # ABABAB
    t = build_tables(np.asarray(IRRATIONAL_WEIGHTS), is_max)

    counts, maxrank = offset_stats_numpy(c1, c2, t)
    assert maxrank.shape[0] > 8192
    res = select_best(counts, maxrank, t, c1, c2)

    from psa.native import search_native

    ref = search_native(c1, c2, t)   # full reference sequential semantics
    assert (res.offset, res.char_offset, res.sub_code) == (
        ref.offset, ref.char_offset, ref.sub_code)
    assert res.score == ref.score    # bit-identical


def test_massive_tie_engine_differential():
    # Same adversarial shape through the public engine API on two backends.
    rng = np.random.default_rng(3)
    base = rng.integers(0, 26, 4).astype(np.int32)
    c1 = np.tile(base, 5000)
    c2 = np.tile(base, 3)
    t_w = IRRATIONAL_WEIGHTS
    for is_max in (False, True):
        eng_np = AlignmentSearchEngine(t_w, is_max, backend="numpy")
        eng_nat = AlignmentSearchEngine(t_w, is_max, backend="native")
        a = eng_np.search_codes(c1, c2)
        b = eng_nat.search_codes(c1, c2)
        assert (a.offset, a.char_offset, a.sub_code, a.score) == (
            b.offset, b.char_offset, b.sub_code, b.score)


def test_candidate_epsilon_scales():
    t = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    e_small = candidate_epsilon(t, 100)
    e_big = candidate_epsilon(t, 10000)
    assert 0 < e_small < e_big < 1e-3
    # exactly-representable weights: grouped == sequential, eps must not
    # exclude the true winner but also must stay tiny vs the score scale
    assert e_big < 0.25  # well under the smallest weight delta


def test_auto_backend_is_workload_aware():
    # small workload -> native host engine (no XLA dispatch at all)
    assert resolve_auto(9711, 2131) == "native"
    assert resolve_auto(100, 10) == "native"
    # large workload -> accelerator path when one exists; otherwise the
    # native host engine beats CPU conv at every size
    assert resolve_auto(2_000_000, 10_000, accelerator=True) == "pallas"
    from psa.models.search import native_available
    want_cpu = "native" if native_available() else "conv"
    assert resolve_auto(2_000_000, 10_000, accelerator=False) == want_cpu
    # no shape information -> platform default
    assert resolve_auto(accelerator=True) == "pallas"


def test_auto_threshold_env(monkeypatch):
    import importlib

    import psa.config as cfg

    monkeypatch.setenv("PSA_AUTO_THRESHOLD", "1")
    try:
        assert importlib.reload(cfg).EngineConfig().auto_threshold == 1
    finally:
        monkeypatch.undo()
        importlib.reload(cfg)


def test_engine_auto_golden_uses_native(golden_query):
    eng = AlignmentSearchEngine(golden_query.weights, golden_query.is_max,
                                backend="auto")
    from psa.core.alphabet import encode

    c1, c2 = encode(golden_query.seq1), encode(golden_query.seq2)
    assert eng._resolve_backend(c1, c2) == "native"
    res = eng.search_codes(c1, c2)
    assert res.offset == 6132 and res.score == -4688.0
