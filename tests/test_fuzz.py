"""Randomized differential fuzz: conv/pallas/xla engines and the native C++
engine must produce identical SearchResults to the numpy oracle across random
shapes, modes, weights, and hyphen densities (SURVEY.md §4 implication (2),
widened)."""

import numpy as np
import pytest

from psa.models.search import AlignmentSearchEngine

from conftest import random_codes

N_CASES = 12


def _random_weights(rng):
    """Three regimes: quarter-integers (exactly f64-representable),
    irrational (sequential-vs-grouped f64 rounding diverges, so the
    candidate_epsilon band and sequential re-score actually fire), and
    tie-heavy (few distinct magnitudes -> massed exact ties)."""
    kind = int(rng.integers(0, 3))
    if kind == 0:
        return np.round(rng.uniform(-4, 6, size=4) * 4) / 4
    if kind == 1:
        return rng.uniform(-2, 4, size=4) * np.pi / 3
    return rng.choice([0.5, 1.0, 2.0], size=4) * rng.choice([-1, 1], 4)


def _case(rng):
    from psa.core.alphabet import OTHER_CODE

    n2 = int(rng.integers(1, 400))
    n1 = n2 + int(rng.integers(0, 1200))
    weights = _random_weights(rng)
    is_max = bool(rng.integers(0, 2))
    hyphen_p = float(rng.choice([0.0, 0.05, 0.3]))
    c1 = random_codes(rng, n1, hyphen_p)
    c2 = random_codes(rng, n2, hyphen_p)
    if rng.random() < 0.25:     # lenient-mode input: OTHER_CODE characters
        c1[rng.random(n1) < 0.08] = OTHER_CODE
        c2[rng.random(n2) < 0.08] = OTHER_CODE
    return c1, c2, weights, is_max


@pytest.mark.parametrize("engine", ["conv", "pallas", "native"])
def test_fuzz_engine_vs_oracle(engine):
    rng = np.random.default_rng(987)
    for case in range(N_CASES):
        c1, c2, weights, is_max = _case(rng)
        ref_eng = AlignmentSearchEngine(weights, is_max, backend="numpy")
        got_eng = AlignmentSearchEngine(weights, is_max, backend=engine)
        try:
            ref = ref_eng.search_codes(c1, c2)
            ref_exc = None
        except Exception as e:
            ref, ref_exc = None, type(e)
        try:
            got = got_eng.search_codes(c1, c2)
            got_exc = None
        except Exception as e:
            got, got_exc = None, type(e)
        assert got_exc == ref_exc, (case, weights, is_max, got_exc, ref_exc)
        assert got == ref, (case, weights.tolist(), is_max, got, ref)


@pytest.mark.slow
@pytest.mark.parametrize("seed,is_max", [(1, False), (2, True), (3, False)])
def test_fuzz_pallas_multitile_stats(seed, is_max):
    """Pallas interpret path across many offset tiles and Seq2 chunks:
    stats-only differential vs the numpy oracle."""
    from psa.core.oracle import offset_stats_numpy
    from psa.core.tables import build_tables
    from psa.ops.pallas_sweep import offset_stats_pallas

    rng = np.random.default_rng(seed)
    n2 = int(rng.integers(300, 700))                  # many chunks
    n1 = n2 + int(rng.integers(5000, 9000))           # many tiles
    weights = np.round(rng.uniform(-4, 6, size=4) * 4) / 4
    hyphen_p = float(rng.choice([0.0, 0.05]))
    c1 = random_codes(rng, n1, hyphen_p)
    c2 = random_codes(rng, n2, hyphen_p)
    t = build_tables(weights, is_max)
    counts, maxrank = offset_stats_pallas(c1, c2, t, interpret=True)
    rc, rm = offset_stats_numpy(c1, c2, t)
    np.testing.assert_array_equal(counts, rc)
    np.testing.assert_array_equal(maxrank, rm)


@pytest.mark.slow
def test_oversized_query_exact_topk_route(monkeypatch):
    """An engine search on a long Seq1 (pallas backend) routes through the
    batch runner (a batch of one) + exact top-k epilogue — only (k, 5) ints
    leave the device — and must return the reference-exact winner."""
    from psa.models import batch as batch_mod

    rng = np.random.default_rng(17)
    c1 = random_codes(rng, 9000, 0.05)
    c2 = random_codes(rng, 700, 0.05)
    w = np.array([1.0, 3.0, 4.0, 2.0])
    ref = AlignmentSearchEngine(w, False, backend="numpy").search_codes(c1, c2)

    calls = []
    real = batch_mod.batched_search_exact

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(batch_mod, "batched_search_exact", spy)
    got = AlignmentSearchEngine(w, False,
                                backend="pallas").search_codes(c1, c2)
    assert calls == [1]
    assert (got.offset, got.char_offset, got.sub_code, got.score) == (
        ref.offset, ref.char_offset, ref.sub_code, ref.score)


def test_more_than_topk_near_ties_falls_back_exactly():
    """>k offsets inside the f32 band: near > TOPK trips the batched path's
    full-host fallback (models/batch._host_select), which must return the
    reference winner, not a truncated-top-k one.  A constant Seq1 makes
    EVERY offset an exact tie (noff >> 32)."""
    from psa.core.alphabet import pad_codes
    from psa.core.tables import build_tables
    from psa.models.batch import TOPK, batched_search_exact
    from psa.ops.common import plan_shapes

    n1, n2 = 700, 64
    c1 = np.zeros(n1, np.int32)                 # 'AAAA...'
    c2 = np.zeros(n2, np.int32)
    c2[5] = 2                                   # one mismatch per window
    w = np.array([1.0, 3.0, 4.0, 2.0])
    noff = n1 - n2 + 1
    assert noff > TOPK
    t = build_tables(w, False)
    _, noff_pad, l2p, l1k = plan_shapes(n1, n2)
    rs = batched_search_exact(pad_codes(c1, l1k)[None], pad_codes(c2, l2p)[None],
                              np.array([noff], np.int32),
                              np.array([n2], np.int32), t, interpret=True)
    ref = AlignmentSearchEngine(w, False, backend="numpy").search_codes(c1, c2)
    got = rs[0]
    assert (got.offset, got.char_offset, got.sub_code, got.score) == (
        ref.offset, ref.char_offset, ref.sub_code, ref.score)


@pytest.mark.slow
def test_fuzz_max_mode_season():
    """MAX-mode-heavy season: round-1 WEIGHT_SETS and fuzz skewed MIN."""
    rng = np.random.default_rng(55)
    for _ in range(8):
        n2 = int(rng.integers(1, 250))
        n1 = n2 + int(rng.integers(0, 900))
        weights = rng.uniform(-3, 5, size=4)          # arbitrary f64 weights
        c1 = random_codes(rng, n1, 0.1)
        c2 = random_codes(rng, n2, 0.1)
        a = AlignmentSearchEngine(weights, True, backend="numpy")
        b = AlignmentSearchEngine(weights, True, backend="native")
        try:
            ra, ea = a.search_codes(c1, c2), None
        except Exception as e:
            ra, ea = None, type(e)
        try:
            rb, eb = b.search_codes(c1, c2), None
        except Exception as e:
            rb, eb = None, type(e)
        assert ea == eb and ra == rb, (weights.tolist(), ra, rb)
