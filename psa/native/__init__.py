"""ctypes bindings for the native C++ search engine.

The shared library is built on first use with g++ (no pip/pybind needed) into
the checkout's build directory, keyed by the source hash and the CPU — the
binary is never committed (it is -march=native, so a foreign checkout's .so
could SIGILL).
After dlopen a tiny self-test runs before the handle is trusted; any failure
raises so callers fall back to the Python oracle.  All tables are passed in
from core/tables.py, so the C++ stays semantics-free glue + hot loops.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

from psa.core.result import NoMutationFound, SearchResult
from psa.core.tables import ScoringTables

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "psa_native.cpp")
_lock = threading.Lock()
_lib = None

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")


def _cache_dir() -> str:
    """Build directory: PSA_NATIVE_CACHE, else `<checkout>/.build`
    (gitignored) — nothing is written outside the checkout."""
    return os.environ.get("PSA_NATIVE_CACHE") or os.path.join(
        os.path.dirname(os.path.dirname(_DIR)), ".build")


def _cpu_tag() -> str:
    """CPU-identity fingerprint: the build uses -march=native, and a cache
    dir on a shared home could otherwise hand a foreign-ISA binary to a
    different machine (SIGILL that no except-clause can catch)."""
    import platform

    ident = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features", "model name")):
                    ident += line
                    break
    except OSError:
        ident += platform.processor()
    return hashlib.sha256(ident.encode()).hexdigest()[:8]


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_cache_dir(), f"libpsa-{digest}-{_cpu_tag()}.so")


def _build(lib_path: str) -> None:
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(lib_path))
    os.close(fd)
    cmd = [
        "g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
        _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _self_test(lib) -> None:
    """One tiny end-to-end call; raises if the binary misbehaves."""
    from psa.core.tables import build_tables

    t = build_tables(np.array([1.0, 2.0, 3.0, 4.0]), is_max=False)
    c1 = np.array([0, 1, 2, 3, 4], np.int32)   # ABCDE
    c2 = np.array([0, 1], np.int32)            # AB
    counts = np.empty((4, 4), np.int32)
    maxrank = np.empty(4, np.int32)
    lib.psa_offset_stats(c1, c2, 2,
                         np.ascontiguousarray(t.sign.reshape(-1)),
                         np.ascontiguousarray(t.rank.reshape(-1)),
                         0, 4, counts.reshape(-1), maxrank)
    from psa.core.oracle import offset_stats_numpy

    ref_counts, ref_maxrank = offset_stats_numpy(c1, c2, t)
    if not (np.array_equal(counts, ref_counts)
            and np.array_equal(maxrank, ref_maxrank)):
        raise RuntimeError("native library self-test failed")


_available: bool | None = None


def available() -> bool:
    """Memoized build-and-self-test probe; False means every native fast
    path silently stays on its Python implementation (one build attempt
    per process, never per call)."""
    global _available
    if _available is None:
        try:
            get_lib()
            _available = True
        except Exception:
            _available = False
    return _available


def get_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib_path = _lib_path()
        if not os.path.exists(lib_path):
            _build(lib_path)
        lib = ctypes.CDLL(lib_path)
        lib.psa_search.restype = ctypes.c_int
        lib.psa_search.argtypes = [
            _i32p, ctypes.c_int32, _i32p, ctypes.c_int32,
            _f64p, _f64p, _i8p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.psa_score_offset.restype = None
        lib.psa_score_offset.argtypes = [
            _i32p, _i32p, ctypes.c_int32,
            _f64p, _f64p, _i8p,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.psa_offset_stats.restype = None
        lib.psa_offset_stats.argtypes = [
            _i32p, _i32p, ctypes.c_int32, _i8p, _i8p,
            ctypes.c_int32, ctypes.c_int32, _i32p, _i32p,
        ]
        lib.psa_parse_chunk.restype = None
        lib.psa_parse_chunk.argtypes = [
            ctypes.c_char_p, _i64p, _i32p, ctypes.c_int32, ctypes.c_int32,
            _i8p, _i32p, _f64p, _i8p, _i32p, _i32p, _i32p, _i32p,
        ]
        lib.psa_encode_padded.restype = None
        lib.psa_encode_padded.argtypes = [
            ctypes.c_char_p, _i64p, _i32p, ctypes.c_int32,
            _i8p, ctypes.c_int32,
        ]
        lib.psa_pack5.restype = None
        lib.psa_pack5.argtypes = [
            _i8p, ctypes.c_int32, ctypes.c_int32, _i32p,
        ]
        lib.psa_rescore_multi.restype = None
        lib.psa_rescore_multi.argtypes = [
            _i32p, ctypes.c_int32, _i32p, ctypes.c_int32, _i32p,
            _f64p, _f64p, _i8p, ctypes.c_int32,
            _i32p, _i64p, ctypes.c_int32,
            _f64p, _i32p, _i32p,
        ]
        lib.psa_rescore_batch.restype = None
        lib.psa_rescore_batch.argtypes = [
            _i32p, _i32p, ctypes.c_int32,
            _f64p, _f64p, _i8p, ctypes.c_int32,
            _i64p, ctypes.c_int32,
            _f64p, _i32p, _i32p,
        ]
        _self_test(lib)
        _lib = lib
        return lib


def _flat_tables(tables: ScoringTables):
    pair_w = np.ascontiguousarray(tables.pair_w.reshape(-1))
    diff = np.ascontiguousarray(tables.diff.reshape(-1))
    sub = np.ascontiguousarray(tables.sub.reshape(-1))
    return pair_w, diff, sub


def search_native(codes1: np.ndarray, codes2: np.ndarray,
                  tables: ScoringTables, nthreads: int = 0,
                  first_offset: int = 0, last_offset: int | None = None) -> SearchResult:
    lib = get_lib()
    codes1 = np.ascontiguousarray(codes1, np.int32)
    codes2 = np.ascontiguousarray(codes2, np.int32)
    noff = codes1.shape[0] - codes2.shape[0] + 1
    if last_offset is None:
        last_offset = noff
    pair_w, diff, sub = _flat_tables(tables)
    score = ctypes.c_double()
    off = ctypes.c_int32()
    coff = ctypes.c_int32()
    sc = ctypes.c_int32()
    found = lib.psa_search(
        codes1, codes1.shape[0], codes2, codes2.shape[0],
        pair_w, diff, sub, int(tables.is_max), first_offset, last_offset,
        nthreads,
        ctypes.byref(score), ctypes.byref(off), ctypes.byref(coff),
        ctypes.byref(sc),
    )
    if not found:
        raise NoMutationFound("no offset admits a legal substitution")
    return SearchResult(offset=off.value, char_offset=coff.value,
                        sub_code=sc.value, score=score.value)


def score_offset_native(codes1: np.ndarray, codes2: np.ndarray,
                        tables: ScoringTables, offset: int):
    """Native sequential re-scorer, same contract as score_offset_sequential."""
    lib = get_lib()
    codes1 = np.ascontiguousarray(codes1, np.int32)
    codes2 = np.ascontiguousarray(codes2, np.int32)
    pair_w, diff, sub = _flat_tables(tables)
    total = ctypes.c_double()
    coff = ctypes.c_int32()
    sc = ctypes.c_int32()
    lib.psa_score_offset(codes1, codes2, codes2.shape[0], pair_w, diff, sub,
                         int(tables.is_max), offset,
                         ctypes.byref(total), ctypes.byref(coff), ctypes.byref(sc))
    return total.value, coff.value, sc.value, None


def rescore_batch_native(codes1: np.ndarray, codes2: np.ndarray,
                         tables: ScoringTables, cand: np.ndarray):
    """Batch sequential re-scorer; same contract as oracle.rescore_candidates
    (bit-identical totals — C++ f64 accumulation in the same order)."""
    lib = get_lib()
    codes1 = np.ascontiguousarray(codes1, np.int32)
    codes2 = np.ascontiguousarray(codes2, np.int32)
    cand = np.ascontiguousarray(cand, np.int64)
    pair_w, diff, sub = _flat_tables(tables)
    k = cand.shape[0]
    totals = np.empty(k, np.float64)
    coffs = np.empty(k, np.int32)
    subs = np.empty(k, np.int32)
    lib.psa_rescore_batch(codes1, codes2, codes2.shape[0], pair_w, diff, sub,
                          int(tables.is_max), cand, k, totals, coffs, subs)
    return totals, coffs.astype(np.int64), subs.astype(np.int64)


def rescore_multi_native(c1b: np.ndarray, c2b: np.ndarray, n2s: np.ndarray,
                         tables: ScoringTables, qidx: np.ndarray,
                         offsets: np.ndarray):
    """Multi-query batch re-scorer: candidate k = (qidx[k], offsets[k]) over
    the padded code matrices c1b (B, L1) / c2b (B, L2).  Bit-identical to
    per-query rescore_batch_native calls, one ctypes crossing for the whole
    batch."""
    lib = get_lib()
    c1b = np.ascontiguousarray(c1b, np.int32)
    c2b = np.ascontiguousarray(c2b, np.int32)
    n2s = np.ascontiguousarray(n2s, np.int32)
    qidx = np.ascontiguousarray(qidx, np.int32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    pair_w, diff, sub = _flat_tables(tables)
    k = offsets.shape[0]
    totals = np.empty(k, np.float64)
    coffs = np.empty(k, np.int32)
    subs = np.empty(k, np.int32)
    lib.psa_rescore_multi(c1b, c1b.shape[1], c2b, c2b.shape[1], n2s,
                          pair_w, diff, sub, int(tables.is_max),
                          qidx, offsets, k, totals, coffs, subs)
    return totals, coffs, subs


# Line statuses returned by parse_chunk_native (must match psa_native.cpp).
PARSE_OK = 0
PARSE_BLANK = 1
PARSE_FEW_TOKENS = 2
PARSE_SEQ_ORDER = 3
PARSE_ALPHABET = 4
PARSE_FALLBACK = 5


def parse_chunk_native(buf: bytes, line_off: np.ndarray,
                       line_len: np.ndarray, check_alpha: bool):
    """One C pass over a chunk of protocol lines: tokenize, parse weights,
    record Seq1/Seq2 spans (offsets relative to each line start), mode, and
    optionally validate the alphabet.  Lines the scanner cannot handle
    bit-identically to Python (non-ASCII, exotic float literals) come back
    as PARSE_FALLBACK for the caller to re-parse with utils/io.parse_input.

    Returns (status, ntokens, weights(n,4), is_max, s1_off, s1_len, s2_off,
    s2_len)."""
    lib = get_lib()
    n = line_off.shape[0]
    line_off = np.ascontiguousarray(line_off, np.int64)
    line_len = np.ascontiguousarray(line_len, np.int32)
    status = np.empty(n, np.int8)
    ntokens = np.empty(n, np.int32)
    weights = np.empty((n, 4), np.float64)
    is_max = np.empty(n, np.int8)
    s1_off = np.empty(n, np.int32)
    s1_len = np.empty(n, np.int32)
    s2_off = np.empty(n, np.int32)
    s2_len = np.empty(n, np.int32)
    lib.psa_parse_chunk(buf, line_off, line_len, n, int(check_alpha),
                        status, ntokens, weights.reshape(-1), is_max,
                        s1_off, s1_len, s2_off, s2_len)
    return status, ntokens, weights, is_max, s1_off, s1_len, s2_off, s2_len


def encode_padded_native(buf: bytes, offs: np.ndarray, lens: np.ndarray,
                         length: int) -> np.ndarray:
    """(n, length) PAD-padded int8 code rows from sequence byte spans in one
    C pass (core/alphabet.encode_batch_padded's fast path)."""
    lib = get_lib()
    n = offs.shape[0]
    offs = np.ascontiguousarray(offs, np.int64)
    lens = np.ascontiguousarray(lens, np.int32)
    out = np.empty((n, length), np.int8)
    lib.psa_encode_padded(buf, offs, lens, n, out.reshape(-1), length)
    return out


def pack5_native(codes: np.ndarray) -> np.ndarray:
    """(b, n) int8 codes -> (b, ceil(n/6)) int32 wire words (the 5-bit upload
    format, models/batch.pack_code_rows's fast path)."""
    lib = get_lib()
    codes = np.ascontiguousarray(codes, np.int8)
    b, n = codes.shape
    out = np.empty((b, (n + 5) // 6), np.int32)
    lib.psa_pack5(codes.reshape(-1), b, n, out.reshape(-1))
    return out


def offset_stats_native(codes1: np.ndarray, codes2: np.ndarray,
                        tables: ScoringTables):
    """Per-offset integer stats with the device-engine contract."""
    lib = get_lib()
    codes1 = np.ascontiguousarray(codes1, np.int32)
    codes2 = np.ascontiguousarray(codes2, np.int32)
    noff = codes1.shape[0] - codes2.shape[0] + 1
    sign = np.ascontiguousarray(tables.sign.reshape(-1))
    rank = np.ascontiguousarray(tables.rank.reshape(-1))
    counts = np.empty((noff, 4), np.int32)
    maxrank = np.empty(noff, np.int32)
    lib.psa_offset_stats(codes1, codes2, codes2.shape[0], sign, rank,
                         0, noff, counts.reshape(-1), maxrank)
    return counts, maxrank
