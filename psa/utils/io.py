"""Reference-compatible file I/O.

Input: whitespace-delimited tokens — 4 weights, Seq1, Seq2, mode token —
exactly like the fscanf-based parser (cpu_funcs.c:353-368).  Tokens beyond the
first seven are ignored, so files that double as scratchpads (like the bundled
input.txt) parse identically.

Output: ``"%s\\n%d %g"`` with no trailing newline (cpu_funcs.c:373-378,
SURVEY.md Q6).  Python's ``%g`` matches C's for finite doubles.
"""

from __future__ import annotations

import dataclasses

import numpy as np


WEIGHTS_FINITE_ERROR = "weights must be finite (inf/nan rejected)"


@dataclasses.dataclass(frozen=True)
class Query:
    weights: np.ndarray  # (4,) f64
    seq1: str
    seq2: str
    is_max: bool

    MAXIMUM_STR = "maximum"


def parse_input(text: str) -> Query:
    tokens = text.split()
    if len(tokens) < 7:
        raise ValueError(f"input needs >= 7 whitespace-delimited tokens, got {len(tokens)}")
    weights = np.array([float(t) for t in tokens[:4]], dtype=np.float64)
    if not np.isfinite(weights).all():
        # C fscanf %lf accepts inf/nan spellings too, but downstream they
        # would silently corrupt the rank tables (tables.py builds ranks
        # from sorted finite diffs) and the selection epsilon bands.
        # Defined behavior: reject at parse time on every surface
        # (VERDICT r3 weak #5).
        raise ValueError(WEIGHTS_FINITE_ERROR)
    seq1, seq2 = tokens[4], tokens[5]
    # strcmp(func_type, "maximum") == 0 -> max, anything else -> min
    # (cpu_funcs.c:365).
    is_max = tokens[6] == Query.MAXIMUM_STR
    if len(seq2) > len(seq1):
        raise ValueError("seq2 must not be longer than seq1")
    return Query(weights=weights, seq1=seq1, seq2=seq2, is_max=is_max)


def parse_query_lines(lines, check_alphabet: bool = True) -> list:
    """Chunk-level line parser for the serving surfaces: one entry per line —
    None (blank, gets no reply), str (error message), or Query.

    Semantics are defined by the per-line Python path (parse_input +
    core/alphabet validation); when the native library is available the
    chunk takes ONE C pass (native.parse_chunk_native) that fuses tokenize +
    weight parse + alphabet validation — the Python pipeline's parse and
    validate passes were ~16 ms of the measured ~34 ms host cost per
    1024-query serve chunk.  Lines the scanner can't reproduce
    bit-identically (non-ASCII, exotic float literals) come back flagged
    and are re-parsed by the Python path, so the protocol contract never
    forks."""
    try:
        from psa import native

        fast = bool(lines) and native.available()
    except Exception:  # noqa: BLE001 - fast path is optional
        fast = False
    if fast:
        return _parse_query_lines_native(lines, check_alphabet, native)
    return _parse_query_lines_py(lines, check_alphabet)


def _parse_line_fallback(line: str, check_alphabet: bool):
    """Reference Python semantics for ONE line (blank -> None)."""
    s = line.strip()
    if not s:
        return None
    try:
        q = parse_input(s)
    except ValueError as e:
        return str(e)
    if check_alphabet:
        from psa.core.alphabet import ALPHABET_ERROR, validate

        if not (validate(q.seq1) and validate(q.seq2)):
            return ALPHABET_ERROR
    return q


def _parse_query_lines_py(lines, check_alphabet: bool) -> list:
    entries: list = [None] * len(lines)
    queries, slots = [], []
    for j, ln in enumerate(lines):
        s = ln.strip()
        if not s:
            continue
        try:
            entries[j] = parse_input(s)
        except ValueError as e:
            entries[j] = str(e)
            continue
        queries.append(entries[j])
        slots.append(j)
    if queries and check_alphabet:
        from psa.core.alphabet import ALPHABET_ERROR, validate_batch

        ok = (validate_batch([q.seq1 for q in queries])
              & validate_batch([q.seq2 for q in queries]))
        for k in np.nonzero(~ok)[0]:
            entries[slots[k]] = ALPHABET_ERROR
    return entries


def _parse_query_lines_native(lines, check_alphabet: bool, native) -> list:
    n = len(lines)
    try:
        buf = "".join(lines).encode("ascii")
        lens = np.fromiter((len(ln) for ln in lines), np.int64, n)
    except UnicodeEncodeError:
        # Per-line byte spans stay exact; non-ASCII lines carry >=0x80
        # bytes, which the scanner flags for the Python fallback.  (Lone
        # surrogates 'replace' to ASCII '?', preserving byte==str indexing
        # — and '?' fails the same checks the original char fails.)
        parts = [ln.encode("utf-8", errors="replace") for ln in lines]
        buf = b"".join(parts)
        lens = np.fromiter((len(p) for p in parts), np.int64, n)
    if lens.size and int(lens.max()) >= 2**31:
        return _parse_query_lines_py(lines, check_alphabet)
    offs = np.zeros(n, np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    (status, ntok, weights, is_max,
     s1_off, s1_len, s2_off, s2_len) = native.parse_chunk_native(
        buf, offs, lens.astype(np.int32), check_alphabet)

    from psa.core.alphabet import ALPHABET_ERROR

    # plain-int lists: per-line np-scalar indexing costs ~1 ms per 1024
    # lines, a measurable share of what's left of the parse pass
    status = status.tolist()
    s1_off, s1_len = s1_off.tolist(), s1_len.tolist()
    s2_off, s2_len = s2_off.tolist(), s2_len.tolist()
    is_max = is_max.tolist()
    # strtod parses overflowing literals like 1e999 to inf with full
    # consumption (so the scanner reports PARSE_OK) — apply the same
    # finite-weights rule parse_input enforces (weights rows of non-OK
    # lines are uninitialized; only OK rows are consulted)
    finite = np.isfinite(weights).all(axis=1).tolist()

    entries: list = [None] * n
    for j in range(n):
        st = status[j]
        if st == native.PARSE_BLANK:
            continue
        # Python precedence: parse_input raises the finite-weights error
        # BEFORE the seq-order check, and before the alphabet check (which
        # runs after parse_input) — the C scanner sets status 3/4 after
        # parsing weights, so apply the finite rule first for those too
        if st in (native.PARSE_OK, native.PARSE_SEQ_ORDER,
                  native.PARSE_ALPHABET) and not finite[j]:
            entries[j] = WEIGHTS_FINITE_ERROR
            continue
        if st == native.PARSE_OK:
            ln = lines[j]
            a, b = s1_off[j], s2_off[j]
            entries[j] = Query(weights=weights[j],
                               seq1=ln[a: a + s1_len[j]],
                               seq2=ln[b: b + s2_len[j]],
                               is_max=bool(is_max[j]))
        elif st == native.PARSE_FEW_TOKENS:
            entries[j] = ("input needs >= 7 whitespace-delimited tokens, "
                          f"got {ntok[j]}")
        elif st == native.PARSE_SEQ_ORDER:
            entries[j] = "seq2 must not be longer than seq1"
        elif st == native.PARSE_ALPHABET:
            entries[j] = ALPHABET_ERROR
        else:  # PARSE_FALLBACK: Python defines the behavior
            entries[j] = _parse_line_fallback(lines[j], check_alphabet)
    return entries


def read_input(path: str) -> Query:
    with open(path, "r") as f:
        return parse_input(f.read())


def parse_cases(text: str) -> list[Query]:
    """Parse every embedded 7-token case record.

    The reference's fscanf parser consumes only the first record
    (cpu_funcs.c:353-368), but its bundled input.txt doubles as a scratchpad
    holding more cases as leftover tokens (input.txt:6+, e.g. lines 29-32 =
    README example 1).  This reads them all: records are consumed greedily,
    7 whitespace tokens each (4 weights, Seq1, Seq2, mode).
    """
    tokens = text.split()
    cases = []
    i = 0
    while i + 7 <= len(tokens):
        try:
            weights = np.array([float(t) for t in tokens[i: i + 4]],
                               dtype=np.float64)
        except ValueError:
            break  # scratchpad junk after the last complete record
        seq1, seq2, mode = tokens[i + 4], tokens[i + 5], tokens[i + 6]
        # Records after the first must carry a real mode token, otherwise
        # trailing numeric scratchpad junk would fabricate bogus cases.
        # (The FIRST record mirrors read_input/the reference: any token
        # that isn't "maximum" means minimum, cpu_funcs.c:365.)
        if i > 0 and mode not in ("maximum", "minimum"):
            break
        if not np.isfinite(weights).all():
            raise ValueError(f"case {len(cases)}: {WEIGHTS_FINITE_ERROR}")
        if len(seq2) > len(seq1):
            raise ValueError(f"case {len(cases)}: seq2 longer than seq1")
        cases.append(Query(weights=weights, seq1=seq1, seq2=seq2,
                           is_max=mode == Query.MAXIMUM_STR))
        i += 7
    if not cases:
        raise ValueError("no complete 7-token case records found")
    return cases


def read_cases(path: str) -> list[Query]:
    with open(path, "r") as f:
        return parse_cases(f.read())


def format_output(mutant: str, offset: int, score: float) -> str:
    return "%s\n%d %g" % (mutant, offset, score)


def write_output(path: str, mutant: str, offset: int, score: float) -> None:
    with open(path, "w") as f:
        f.write(format_output(mutant, offset, score))
