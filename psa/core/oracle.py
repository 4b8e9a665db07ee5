"""Exact host-side oracles.

Two layers:

* ``score_offset_sequential`` — bit-exact transcription of the reference's
  per-offset scan (cpu_funcs.c:257-300): left-to-right f64 accumulation and
  strict-improvement substitution tracking.  Used to re-score final candidate
  offsets so the reported score/winner matches the reference's sequential
  float semantics bit-for-bit.
* ``offset_stats_numpy`` — vectorized NumPy engine producing the same
  per-offset integer statistics (sign-class counts + best substitution rank)
  as the device engines.  Serves as the differential-test oracle for the
  XLA/Pallas paths and as a fast CPU backend.
"""

from __future__ import annotations

import numpy as np

from psa.core.tables import ScoringTables


def score_offset_sequential(codes1: np.ndarray, codes2: np.ndarray,
                            tables: ScoringTables, offset: int):
    """Reference-order scan of one offset (cpu_funcs.c:257-300).

    Returns (total, char_offset, sub_code, best_diff): `total` is the
    post-substitution score (or +-inf when no position admits a substitution,
    matching the reference's infinity return at cpu_funcs.c:297-298).
    """
    n2 = int(codes2.shape[0])
    is_max = tables.is_max
    pair_w = tables.pair_w
    diff = tables.diff
    sub = tables.sub

    total = 0.0
    best_diff = -np.inf if is_max else np.inf
    best_i = -1
    best_sub = -1
    win = codes1[offset: offset + n2]
    for i in range(n2):
        c1 = win[i]
        c2 = codes2[i]
        total += pair_w[c1, c2]
        d = diff[c1, c2]
        if np.isnan(d):
            continue
        if (is_max and d > best_diff) or (not is_max and d < best_diff):
            best_diff = float(d)
            best_i = i
            best_sub = int(sub[c1, c2])
    if best_i < 0:
        return best_diff, -1, -1, best_diff
    return total + best_diff, best_i, best_sub, best_diff


def rescore_candidates(codes1: np.ndarray, codes2: np.ndarray,
                       tables: ScoringTables, cand: np.ndarray):
    """`score_offset_sequential` vectorized over a candidate-offset axis.

    Each candidate's f64 accumulation runs in the reference's left-to-right
    order (the i-loop is sequential; vectorization is across candidates), so
    the returned totals are bit-identical to per-offset sequential scans.
    Returns (totals (k,) f64, char_offsets (k,) i64, sub_codes (k,) i64).
    """
    cand = np.asarray(cand, dtype=np.int64)
    codes1 = np.asarray(codes1, dtype=np.int32)
    codes2 = np.asarray(codes2, dtype=np.int32)
    k = cand.shape[0]
    n2 = int(codes2.shape[0])
    is_max = tables.is_max
    pair_w = tables.pair_w
    diff = tables.diff
    sub = tables.sub

    totals = np.zeros(k, dtype=np.float64)
    best_diff = np.full(k, -np.inf if is_max else np.inf)
    best_i = np.full(k, -1, dtype=np.int64)
    best_sub = np.full(k, -1, dtype=np.int64)
    for i in range(n2):
        c1 = codes1[cand + i]
        c2 = codes2[i]
        totals += pair_w[c1, c2]
        d = diff[c1, c2]
        # strict improvement only (cpu_funcs.c:287-288); NaN compares False,
        # which is exactly the reference's "no substitution -> skip"
        better = (d > best_diff) if is_max else (d < best_diff)
        best_diff = np.where(better, d, best_diff)
        best_i = np.where(better, i, best_i)
        best_sub = np.where(better, sub[c1, c2], best_sub)
    totals = np.where(best_i >= 0, totals + best_diff, best_diff)
    return totals, best_i, best_sub


def offset_stats_numpy(codes1: np.ndarray, codes2: np.ndarray,
                       tables: ScoringTables, chunk: int = 2048):
    """Per-offset integer stats: counts (noff, 4) int32, maxrank (noff,) int32.

    counts[o, k] = number of positions whose pair sign class is k;
    maxrank[o]  = best substitution rank at offset o (-1 when none).
    Same contract as the device engines; exact by construction.
    """
    codes1 = np.asarray(codes1, dtype=np.int32)
    codes2 = np.asarray(codes2, dtype=np.int32)
    n1, n2 = codes1.shape[0], codes2.shape[0]
    noff = n1 - n2 + 1
    if noff <= 0:
        raise ValueError("seq2 longer than seq1")

    sign = tables.sign.astype(np.int32)
    rank = tables.rank.astype(np.int32)

    counts = np.zeros((noff, 4), dtype=np.int32)
    maxrank = np.full(noff, -1, dtype=np.int32)

    idx2 = codes2[None, :]
    for o0 in range(0, noff, chunk):
        o1 = min(o0 + chunk, noff)
        offs = np.arange(o0, o1)[:, None]
        c1 = codes1[offs + np.arange(n2)[None, :]]  # (chunk, n2)
        s = sign[c1, idx2]
        for k in range(4):
            counts[o0:o1, k] = (s == k).sum(axis=1)
        maxrank[o0:o1] = rank[c1, idx2].max(axis=1)
    return counts, maxrank
