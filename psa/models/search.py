"""The single-query alignment search engine.

Replaces the reference's orchestration stack (main.c:13-56 ->
cpu_funcs.c:25-218): pick a backend, compute per-offset integer statistics on
the device, select the exact winner on the host.

Backends (all share the same output contract — see ops/select.py):

* ``numpy``  — vectorized host oracle (core/oracle.py); exact, runs anywhere.
* ``xla``    — chunked jnp gather engine under jit (ops/engine_xla.py).
* ``conv``   — one-hot `lax.conv` formulation; matrix units do the lookups
               (ops/engine_conv.py).
* ``pallas`` — the device sweep kernel (ops/pallas_sweep.py, Pallas through
               Triton on an NVIDIA GPU); the hot path.
* ``native`` — C++/OpenMP host engine (native/), the reference-semantics
               oracle at native speed.
* ``hybrid`` — concurrent host+device split of ONE query: the accelerator
               takes the first ``device_share``% of offsets, the C++/OpenMP
               engine the rest in parallel, winners merged under the
               canonical tie-break — the literal analog of the reference's
               cuda_percentage split (cpu_funcs.c:144-150).
* ``auto``   — workload-aware: small sweeps run on the native host engine
               (never touching XLA), large ones on the device kernel when a
               GPU is present — the reference's CPU/GPU crossover heuristic
               (cpu_funcs.c:135-142).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from psa.core.alphabet import encode, validate
from psa.core.oracle import offset_stats_numpy
from psa.core.result import SearchResult
from psa.core.tables import ScoringTables, build_tables_cached
from psa.ops.select import select_best

_BACKENDS = ("auto", "numpy", "xla", "conv", "pallas", "native", "hybrid")

_native_ok: bool | None = None


def native_available() -> bool:
    """True when the C++ engine builds (g++ present) and self-tests."""
    global _native_ok
    if _native_ok is None:
        try:
            from psa.native import get_lib

            get_lib()
            _native_ok = True
        except Exception:
            _native_ok = False
    return _native_ok


def resolve_auto(n1: int | None = None, n2: int | None = None,
                 accelerator: bool | None = None) -> str:
    """Pick a backend for one workload.

    The reference auto-routes by workload size: >=20% of its max pair-eval
    count goes to the GPU, the rest stays on CPU (cpu_funcs.c:135-142).
    Here the crossover is calibrated against accelerator start-up and
    compile cost: below ``CONFIG.auto_threshold`` pair-evals the native host
    engine wins outright, and crucially it never initializes XLA.  Above
    it, the device kernel amortizes when a GPU is present.
    """
    from psa.config import CONFIG

    if n1 is not None and n2 is not None:
        pair_evals = max(n1 - n2 + 1, 0) * n2
        if pair_evals < CONFIG.auto_threshold and native_available():
            return "native"
    if accelerator is None:
        from psa.ops.device import accelerator_present

        accelerator = accelerator_present()
    if accelerator:
        return "pallas"
    # no accelerator: the native host engine beats the XLA paths on a CPU
    return "native" if native_available() else "conv"


class AlignmentSearchEngine:
    """Searches every (offset, position, substitution) triple for the best
    single-character mutation of seq2 aligned under seq1."""

    def __init__(self, weights: Sequence[float], is_max: bool,
                 backend: str | None = None, strict_alphabet: bool = True,
                 nthreads: int = 0, device_share: float | None = None):
        if backend is None:
            from psa.config import CONFIG

            backend = CONFIG.default_backend
        if backend not in _BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; choose from {_BACKENDS}")
        self.tables: ScoringTables = build_tables_cached(
            np.asarray(weights, np.float64), is_max)
        self.backend = backend
        self.strict_alphabet = strict_alphabet
        # native-engine thread count; 0 = all cores, 1 = the reference's
        # sequential oracle mode (`make runseq`, SURVEY.md §3.5)
        self.nthreads = nthreads
        # hybrid backend: percentage of offsets the accelerator takes
        # (main.c:30-42 cuda_percentage); None = the reference's auto
        # heuristic (all-device above the workload crossover, else all-host)
        self.device_share = device_share

    def _resolve_backend(self, codes1: np.ndarray | None = None,
                         codes2: np.ndarray | None = None) -> str:
        if self.backend != "auto":
            return self.backend
        n1 = codes1.shape[0] if codes1 is not None else None
        n2 = codes2.shape[0] if codes2 is not None else None
        return resolve_auto(n1, n2)

    def offset_stats(self, codes1: np.ndarray, codes2: np.ndarray):
        """Per-offset (counts (noff,4) int32, maxrank (noff,) int32)."""
        backend = self._resolve_backend(codes1, codes2)
        if backend == "hybrid":
            # stats are a whole-range product; the hybrid split only shapes
            # the WINNER search — serve stats from the host engine
            backend = "native" if native_available() else "numpy"
        if backend == "numpy":
            return offset_stats_numpy(codes1, codes2, self.tables)
        if backend == "native":
            from psa.native import offset_stats_native

            return offset_stats_native(codes1, codes2, self.tables)
        from psa.utils.cache import enable_compilation_cache

        enable_compilation_cache()  # XLA-backed paths from here down
        if backend == "xla":
            from psa.ops.engine_xla import offset_stats_xla

            return offset_stats_xla(codes1, codes2, self.tables)
        if backend == "conv":
            from psa.ops.engine_conv import offset_stats_conv

            return offset_stats_conv(codes1, codes2, self.tables)
        if backend == "pallas":
            from psa.ops.pallas_sweep import offset_stats_pallas

            return offset_stats_pallas(codes1, codes2, self.tables)
        raise AssertionError(backend)

    def search_codes(self, codes1: np.ndarray, codes2: np.ndarray) -> SearchResult:
        codes1 = np.asarray(codes1, dtype=np.int32)
        codes2 = np.asarray(codes2, dtype=np.int32)
        if codes2.shape[0] > codes1.shape[0]:
            raise ValueError("seq2 must not be longer than seq1")
        backend = self._resolve_backend(codes1, codes2)
        if backend == "native":
            # the native engine applies the reference's sequential semantics
            # directly — no separate selection pass needed
            from psa.native import search_native

            return search_native(codes1, codes2, self.tables,
                                 nthreads=self.nthreads)
        if backend == "pallas":
            return self._device_exact(codes1, codes2)
        if backend == "hybrid":
            return self._search_hybrid(codes1, codes2)
        counts, maxrank = self.offset_stats(codes1, codes2)
        noff = codes1.shape[0] - codes2.shape[0] + 1
        return select_best(np.asarray(counts), np.asarray(maxrank),
                           self.tables, codes1, codes2, noff=noff)

    def _device_exact(self, codes1: np.ndarray, codes2: np.ndarray,
                      noff_limit: int | None = None) -> SearchResult:
        """Device search via the checkable-exact top-k epilogue: a batch of
        one through the batch runner.

        Every device-path query runs the epilogue ON DEVICE: one packed
        upload, one ~800-byte fetch, host selection over <= k candidates —
        matching the reference GPU driver's copy-only-the-winner-back
        discipline (cuda_funcs.cu:106-119), instead of fetching the full
        (noff, 5) stats and scanning them on the host.

        noff_limit restricts the search to offsets [0, noff_limit) — the
        epilogue masks the rest in-graph (the hybrid backend's device block,
        cpu_funcs.c:144-147 analog).
        """
        from psa.core.alphabet import pad_codes
        from psa.core.result import NoMutationFound
        from psa.models.batch import batched_search_exact
        from psa.ops.common import plan_shapes
        from psa.utils.cache import enable_compilation_cache

        noff, noff_pad, l2p, l1k = plan_shapes(codes1.shape[0],
                                               codes2.shape[0])
        if noff_limit is not None:
            noff = min(noff, noff_limit)
        enable_compilation_cache()
        res = batched_search_exact(
            pad_codes(codes1, l1k)[None, :],
            pad_codes(codes2, l2p)[None, :],
            np.array([noff], np.int32),
            np.array([codes2.shape[0]], np.int32),
            self.tables)[0]
        if res is None:
            raise NoMutationFound(
                "no offset admits a legal substitution")
        return res

    def _search_hybrid(self, codes1: np.ndarray, codes2: np.ndarray) -> SearchResult:
        """Concurrent host+device split of ONE query — the literal analog of
        the reference's cuda_percentage split (cpu_funcs.c:144-150): the
        accelerator takes the FIRST device_share% of offsets, the C++/OpenMP
        host engine takes the rest IN PARALLEL (a thread; both the ctypes
        call and the device fetch release the GIL), and the two winners merge
        under the canonical tie-break (is_swapable, cuda_funcs.cu:290-307:
        better score, then lower offset — the device block owns the lower
        offsets, so it wins exact ties).

        Exactness: both sides produce sequentially re-scored f64 totals
        (native/psa_native.cpp and ops/select.pick_from_candidates use the
        same accumulation order), so the merge compares exact values.
        """
        import threading

        from psa.core.result import NoMutationFound
        from psa.native import search_native

        noff = codes1.shape[0] - codes2.shape[0] + 1
        share = self.device_share
        if share is None:
            # the reference's auto heuristic shape: all-device above the
            # workload crossover, all-host below (cpu_funcs.c:137-142)
            from psa.config import CONFIG

            share = 100.0 if noff * codes2.shape[0] >= CONFIG.auto_threshold \
                else 0.0
        split = min(max(int(round(noff * share / 100.0)), 0), noff)
        if split < noff and not native_available():
            raise RuntimeError(
                "hybrid backend needs the native host engine for its host "
                "block (g++); use --backend pallas or --device-share 100")
        if split == 0:
            return search_native(codes1, codes2, self.tables,
                                 nthreads=self.nthreads)

        host_out: list = [None, None]          # [result, exception]

        def host_block():
            try:
                host_out[0] = search_native(
                    codes1, codes2, self.tables, nthreads=self.nthreads,
                    first_offset=split, last_offset=noff)
            except NoMutationFound:
                pass
            except Exception as e:             # re-raised on the main thread
                host_out[1] = e

        t = None
        if split < noff:
            t = threading.Thread(target=host_block, daemon=True)
            t.start()
        try:
            # the device block only needs Seq1's prefix covering offsets
            # [0, split) — slicing it shrinks the sweep to the device's
            # share (the reference gives the GPU only its block too,
            # cpu_funcs.c:144-147); prefix offsets are global offsets
            dev = self._device_exact(
                codes1[: split + codes2.shape[0] - 1], codes2,
                noff_limit=split)
        except NoMutationFound:
            dev = None
        finally:
            if t is not None:
                t.join()
        if host_out[1] is not None:
            raise host_out[1]
        host = host_out[0]
        if dev is None and host is None:
            raise NoMutationFound("no offset admits a legal substitution")
        if dev is None:
            return host
        if host is None:
            return dev
        host_better = (host.score > dev.score if self.tables.is_max
                       else host.score < dev.score)
        return host if host_better else dev

    def search(self, seq1: str, seq2: str) -> SearchResult:
        if self.strict_alphabet and not (validate(seq1) and validate(seq2)):
            raise ValueError(
                "sequences must contain only A-Z and '-' "
                "(pass strict_alphabet=False to accept reference-UB inputs)"
            )
        return self.search_codes(encode(seq1), encode(seq2))


def search(seq1: str, seq2: str, weights: Sequence[float], is_max: bool,
           backend: str = "auto") -> SearchResult:
    """One-shot convenience wrapper."""
    return AlignmentSearchEngine(weights, is_max, backend=backend).search(seq1, seq2)
