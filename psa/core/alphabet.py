"""Alphabet encoding for the alignment engine.

Characters are mapped to small integer codes so that every pair-wise rule can
live in a precomputed (NCODES x NCODES) table that is constant in HBM:

    'A'..'Z' -> 0..25
    '-'      -> 26   (HYPHEN_CODE; special-cased analytically by the rules)
    any other input char -> 27 (OTHER_CODE; out-of-range semantics)
    padding  -> 28   (PAD_CODE; fully inert: scores 0 with everything)

The reference treats out-of-range characters as sign '\\0' weighing zero
(cuda_funcs.cu:428-429, cuda_funcs.cu:451) but checks hyphens FIRST
(cuda_funcs.cu:426-427), so '-' vs an out-of-range char is SPACE.  PAD_CODE is
distinct from OTHER_CODE because padding (required by XLA static shapes) must
be inert against *every* code, including hyphen.
"""

from __future__ import annotations

import numpy as np

NUM_LETTERS = 26
HYPHEN_CODE = 26
OTHER_CODE = 27
PAD_CODE = 28
NCODES = 29
# One-hot / table dimension padded to a power of two.
NCODES_PAD = 32

_ENC = np.full(256, OTHER_CODE, dtype=np.int32)
for _i in range(NUM_LETTERS):
    _ENC[ord("A") + _i] = _i
_ENC[ord("-")] = HYPHEN_CODE
_ENC8 = _ENC.astype(np.int8)   # codes fit int8; the device wire format

_DEC = np.array([chr(ord("A") + i) for i in range(NUM_LETTERS)] + ["-", "?", "."])


def encode(seq: str | bytes) -> np.ndarray:
    """Encode a sequence string into int32 codes (vectorized)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _ENC[raw].copy()


def decode(codes: np.ndarray) -> str:
    """Decode int codes back into a string ('?' = OTHER, '.' = PAD)."""
    codes = np.asarray(codes)
    return "".join(_DEC[np.clip(codes, 0, PAD_CODE)])


def decode_char(code: int) -> str:
    return _DEC[min(int(code), PAD_CODE)]


def pad_codes(codes: np.ndarray, length: int) -> np.ndarray:
    """Right-pad a code array with PAD_CODE to `length` (int32)."""
    codes = np.asarray(codes, dtype=np.int32)
    if codes.shape[0] > length:
        raise ValueError(f"sequence length {codes.shape[0]} exceeds padded length {length}")
    out = np.full(length, PAD_CODE, dtype=np.int32)
    out[: codes.shape[0]] = codes
    return out


def validate(seq: str) -> bool:
    """True when every character is in the engine's defined alphabet (A-Z, '-').

    Vectorized: the per-char Python loop cost ~80ns/char — ~160us per
    serving-sized query, which dominated the serve loop's host time."""
    raw = np.frombuffer(seq.encode("ascii", errors="replace"), np.uint8)
    return bool(np.all(_ENC[raw] <= HYPHEN_CODE))


def encode_batch_padded(seqs, length: int) -> np.ndarray:
    """Encode many sequences into one PAD-padded (len(seqs), length) int8
    array with ONE table gather — per-query encode+pad cost ~115us/query in
    small-array overhead at serving shapes; this is ~25x cheaper.

    int8 is the smallest dtype the 5-bit wire packer
    (models/batch.pack_code_rows) reads, so emitting it directly deletes a
    whole-batch int32 buffer + cast from the serve hot path (codes are
    always positive table indices, and every host consumer either indexes
    with them or converts itself).

    When the native library is available the gather + pad happens in one C
    pass (native.encode_padded_native, bit-identical table) — the numpy
    gather + per-row copy loop was ~10 ms of the measured ~34 ms host cost
    per 1024-query serve chunk."""
    n = len(seqs)
    lens = np.fromiter((len(s) for s in seqs), np.int64, n)
    if lens.size and int(lens.max()) > length:
        i = int(np.argmax(lens))
        raise ValueError(
            f"sequence length {len(seqs[i])} exceeds padded length {length}")
    joined = "".join(seqs).encode("ascii", errors="replace")
    try:
        from psa import native

        if native.available():
            offs = np.zeros(n, np.int64)
            np.cumsum(lens[:-1], out=offs[1:])
            return native.encode_padded_native(joined, offs,
                                               lens.astype(np.int32), length)
    except Exception:  # noqa: BLE001 - fast path is optional
        pass
    buf = np.full((n, length), PAD_CODE, np.int8)
    codes = _ENC8[np.frombuffer(joined, np.uint8)]
    o = 0
    for i, s in enumerate(seqs):
        buf[i, : len(s)] = codes[o: o + len(s)]
        o += len(s)
    return buf


def validate_batch(seqs) -> np.ndarray:
    """Per-sequence validity flags for many sequences in ONE vectorized
    pass (the serve loop validates thousands of lines per chunk; per-call
    `validate` overhead was ~1/3 of its host time)."""
    n = len(seqs)
    joined = "".join(seqs).encode("ascii", errors="replace")
    if not joined:
        return np.ones(n, bool)
    flags = _ENC8[np.frombuffer(joined, np.uint8)] > HYPHEN_CODE
    if not flags.any():                 # the common case: everything valid
        return np.ones(n, bool)
    lens = np.fromiter((len(s) for s in seqs), np.int64, n)
    bad = np.concatenate([[0], np.cumsum(flags)])
    ends = np.cumsum(lens)
    return bad[ends] == bad[ends - lens]


ALPHABET_ERROR = ("sequences must contain only A-Z and '-' "
                  "(pass --lenient to accept reference-UB inputs)")


def ensure_valid(seq1: str, seq2: str, lenient: bool = False) -> None:
    """Raise ValueError(ALPHABET_ERROR) on out-of-alphabet chars in strict
    mode — the one shared validation gate for every CLI/serving surface."""
    if not lenient and not (validate(seq1) and validate(seq2)):
        raise ValueError(ALPHABET_ERROR)
