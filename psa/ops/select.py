"""Exact winner selection from per-offset integer statistics.

Device engines return, per offset, exact integer sign-class counts and the
best substitution rank.  This module reconstructs exact f64 totals on the
host and applies the reference's canonical tie-break
(cuda_funcs.cu:290-307 / SURVEY.md §0.3):

    best score -> lowest offset -> lowest char position -> alphabetically
    first substitute (the last two are baked into rank construction and the
    winner-offset rescan).

The reference accumulates its per-offset f64 score *sequentially*
(cpu_funcs.c:278), while our totals come from grouped integer counts; the two
f64 roundings of the same exact sum can differ by at most a bound
proportional to n2*ulp (see `candidate_epsilon`).  Every offset within that
bound of the grouped best is re-scored in the reference's sequential order
(`rescore_candidates` — vectorized over candidates, so even hundreds of
thousands of exact ties stay cheap), making the final winner and the printed
score bit-identical to the reference with NO truncation of the candidate
set.
"""

from __future__ import annotations

import sys

import numpy as np

from psa.core.oracle import rescore_candidates
from psa.core.result import NoMutationFound, SearchResult
from psa.core.tables import ScoringTables

from psa.config import CONFIG

_batch_rescorer = None


def _get_rescorer():
    """Native C++ batch re-scorer when buildable (one ctypes call for the
    whole candidate list — the numpy fallback loops n2 Python-side, which
    costs ~20us/char of pure call overhead); bit-identical either way."""
    global _batch_rescorer
    if _batch_rescorer is None:
        try:
            from psa.native import get_lib, rescore_batch_native

            get_lib()
            _batch_rescorer = rescore_batch_native
        except Exception:  # no toolchain / build failure: numpy path
            _batch_rescorer = rescore_candidates
    return _batch_rescorer


def candidate_epsilon(tables: ScoringTables, n2):
    """Sound bound on |sequential f64 total - grouped f64 total|.

    Both totals round the same exact rational value; a sequential sum of n2
    terms each bounded by max|w| (plus one substitution delta bounded by
    max|diff|) carries error <= n2 * eps_m * S where S bounds the running
    absolute sum; the grouped side adds a handful of ulps.  The factor 4 is
    headroom.  An offset outside this band of the grouped best cannot win
    under sequential semantics, so the candidate set is provably complete.
    """
    max_w = float(np.max(np.abs(tables.w_signed))) if np.any(n2) else 0.0
    max_d = float(np.max(np.abs(tables.diff_vals))) if tables.diff_vals.size else 0.0
    n2 = np.asarray(n2, np.float64)
    s_bound = n2 * max_w + max_d
    # accepts a scalar OR an (R,) array of n2s (the vectorized batch path)
    return 4.0 * (n2 + 8) * np.finfo(np.float64).eps * np.maximum(s_bound, 1.0)


def totals_from_stats(counts: np.ndarray, maxrank: np.ndarray,
                      tables: ScoringTables) -> np.ndarray:
    """Exact f64 post-substitution totals per offset (+-inf where no sub)."""
    score = tables.score_from_counts(counts)
    bad = -np.inf if tables.is_max else np.inf
    diffv = np.where(maxrank >= 0, tables.diff_vals[np.clip(maxrank, 0, None)], bad)
    return score + diffv


def select_best(counts: np.ndarray, maxrank: np.ndarray, tables: ScoringTables,
                codes1: np.ndarray, codes2: np.ndarray,
                noff: int | None = None) -> SearchResult:
    """Pick the winning (offset, char_offset, substitute) triple.

    `counts`/`maxrank` may be padded beyond the true offset count; pass `noff`
    to mask the padding.
    """
    counts = np.asarray(counts)
    maxrank = np.asarray(maxrank)
    n_rows = maxrank.shape[0]
    if noff is None:
        noff = n_rows
    valid = np.zeros(n_rows, dtype=bool)
    valid[:noff] = maxrank[:noff] >= 0
    if not valid.any():
        raise NoMutationFound("no offset admits a legal substitution")

    totals = totals_from_stats(counts, maxrank, tables)
    totals = np.where(valid, totals, -np.inf if tables.is_max else np.inf)

    best = totals.max() if tables.is_max else totals.min()
    eps = candidate_epsilon(tables, int(codes2.shape[0]))
    cand = np.nonzero(np.abs(totals - best) <= eps)[0]
    if cand.shape[0] > CONFIG.max_candidates:
        print(f"psa: note: {cand.shape[0]} near-tied offsets re-scored "
              "sequentially for exact tie-breaking", file=sys.stderr)

    return pick_from_candidates(codes1, codes2, tables, cand)


def pick_from_candidates(codes1: np.ndarray, codes2: np.ndarray,
                         tables: ScoringTables,
                         cand: np.ndarray) -> SearchResult:
    """Exact winner among candidate offsets (ascending order required).

    Re-scores every candidate with the reference's sequential f64 semantics
    (cpu_funcs.c:257-300); the first bit-equal best total is the is_swapable
    winner (cuda_funcs.cu:290-307: strictly better, else lowest offset).
    """
    seq_totals, coffs, subs = _get_rescorer()(codes1, codes2, tables, cand)
    ok = coffs >= 0
    seq_totals = np.where(ok, seq_totals, -np.inf if tables.is_max else np.inf)
    if not ok.any():
        raise NoMutationFound("no offset admits a legal substitution")
    best_total = seq_totals.max() if tables.is_max else seq_totals.min()
    w = int(np.nonzero(seq_totals == best_total)[0][0])
    return SearchResult(offset=int(cand[w]), char_offset=int(coffs[w]),
                        sub_code=int(subs[w]), score=float(best_total))
