"""Exact batched selection + multi-case parsing + batch CLI tests."""

import numpy as np
import pytest

from psa.core.alphabet import encode, pad_codes
from psa.core.oracle import offset_stats_numpy
from psa.core.tables import build_tables
from psa.models.batch import batched_search_exact, search_batch
from psa.ops.select import select_best
from psa.utils.io import parse_cases, read_cases, read_input

from conftest import GOLDEN_INPUT, random_codes, random_seq


@pytest.fixture(scope="module")
def tables_min():
    return build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)


def _batch(rng, B, n1, n2, l1k, l2p):
    c1b = np.stack([pad_codes(random_codes(rng, n1), l1k) for _ in range(B)])
    c2b = np.stack([pad_codes(random_codes(rng, n2), l2p) for _ in range(B)])
    noffs = np.full(B, n1 - n2 + 1, np.int32)
    n2s = np.full(B, n2, np.int32)
    return c1b, c2b, noffs, n2s


@pytest.mark.parametrize("is_max", [False, True])
@pytest.mark.parametrize("shared", [True, False])
def test_batched_exact_matches_single_query(is_max, shared):
    rng = np.random.default_rng(11)
    t = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), is_max)
    n1, n2, l2p = 700, 120, 128
    l1k = 768 + l2p           # noff=581 -> noff_pad=768 (3 offset tiles)
    B = 6
    c1b, c2b, noffs, n2s = _batch(rng, B, n1, n2, l1k, l2p)
    if shared:                # one Seq1 row read by every query
        c1b[:] = c1b[0]
    res = batched_search_exact(c1b, c2b, noffs, n2s, t, interpret=True,
                               shared_s1=shared)
    assert len(res) == B
    for q in range(B):
        c1, c2 = c1b[q][: n1], c2b[q][: n2]
        counts, maxrank = offset_stats_numpy(c1, c2, t)
        ref = select_best(counts, maxrank, t, c1, c2)
        r = res[q]
        assert (r.offset, r.char_offset, r.sub_code, r.score) == (
            ref.offset, ref.char_offset, ref.sub_code, ref.score), q


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_batched_exact_sharded_mesh_size_independent(ndev, tables_min):
    """Mesh-data-parallel exact batch: identical winners at every mesh
    size, including a batch that does not divide the device count (dummy
    PAD rows) and a no-mutation query."""
    import jax

    from psa.models.batch import batched_search_exact_sharded
    from psa.parallel.mesh import make_mesh

    rng = np.random.default_rng(23)
    n1, n2, l2p = 700, 120, 128
    l1k = 1024 + l2p
    B = 5                                  # not a multiple of 2/4/8
    c1b, c2b, noffs, n2s = _batch(rng, B, n1, n2, l1k, l2p)
    # query 2: out-of-range chars everywhere -> every pair weighs 0 with
    # no legal substitution (the defined no-mutation path, SURVEY Q3)
    c1b[2, :n1] = 27
    c2b[2, :n2] = 27
    mesh = make_mesh(jax.devices()[:ndev], axis="dp")
    got = batched_search_exact_sharded(c1b, c2b, noffs, n2s, tables_min,
                                       mesh, interpret=True)
    want = batched_search_exact(c1b, c2b, noffs, n2s, tables_min,
                                interpret=True)
    assert len(got) == B
    for q in range(B):
        if want[q] is None:
            assert got[q] is None, q
            continue
        assert (got[q].offset, got[q].char_offset, got[q].sub_code,
                got[q].score) == (want[q].offset, want[q].char_offset,
                                  want[q].sub_code, want[q].score), q
    assert got[2] is None


def test_batched_exact_massive_tie_fallback():
    """Periodic seq1 floods the f32 near-tie band past k -> host fallback;
    the winner must still be the reference's exactly."""
    t = build_tables(np.asarray([np.pi / 4, np.e / 7, np.sqrt(2) / 3, 1 / 3]),
                     False)
    base = np.array([0, 1], np.int32)
    c1 = np.tile(base, 1000)              # 2000 chars, ~1873 tied offsets
    c2 = np.tile(base, 64)                # 128 chars
    l2p, l1k = 128, 2048 + 128
    c1b = pad_codes(c1, l1k)[None, :]
    c2b = pad_codes(c2, l2p)[None, :]
    noffs = np.array([c1.shape[0] - c2.shape[0] + 1], np.int32)
    n2s = np.array([c2.shape[0]], np.int32)
    res = batched_search_exact(c1b, c2b, noffs, n2s, t, interpret=True)
    counts, maxrank = offset_stats_numpy(c1, c2, t)
    ref = select_best(counts, maxrank, t, c1, c2)
    r = res[0]
    assert (r.offset, r.char_offset, r.sub_code, r.score) == (
        ref.offset, ref.char_offset, ref.sub_code, ref.score)


def test_batched_exact_no_mutation():
    t = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), True)
    # out-of-range chars everywhere (lenient-mode input): every pair weighs
    # 0 with no legal substitution -> defined no-mutation path (SURVEY Q3)
    c1 = np.full(700, 27, np.int32)
    c2 = np.full(120, 27, np.int32)
    l2p, l1k = 128, 1024 + 128
    res = batched_search_exact(pad_codes(c1, l1k)[None, :],
                               pad_codes(c2, l2p)[None, :],
                               np.array([581], np.int32),
                               np.array([120], np.int32), t, interpret=True)
    assert res == [None]


def test_search_batch_mixed_sizes_host_path():
    """Bucketed mixed-size batch on the host path == per-query engine."""
    from psa.models.search import AlignmentSearchEngine
    from psa.utils.io import Query

    rng = np.random.default_rng(5)
    specs = [(300, 40, False), (300, 40, True), (900, 200, False),
             (1501, 77, False), (300, 40, False)]
    queries = [
        Query(weights=np.array([1.0, 3.0, 4.0, 2.0]), seq1=random_seq(rng, n1),
              seq2=random_seq(rng, n2), is_max=m)
        for n1, n2, m in specs
    ]
    got = search_batch(queries, backend="numpy")
    for q, r in zip(queries, got):
        eng = AlignmentSearchEngine(q.weights, q.is_max, backend="numpy")
        ref = eng.search(q.seq1, q.seq2)
        assert (r.offset, r.char_offset, r.score) == (
            ref.offset, ref.char_offset, ref.score)


def test_search_batch_auto_is_workload_aware(monkeypatch):
    """`--backend auto` routes small buckets to the host engine and big
    buckets to the device path, per bucket (cpu_funcs.c:135-142 analog)."""
    from psa.config import CONFIG
    from psa.models import batch as batch_mod
    from psa.models.search import AlignmentSearchEngine
    from psa.ops import device
    from psa.utils.io import Query

    rng = np.random.default_rng(7)
    queries = [
        Query(weights=np.array([1.0, 3.0, 4.0, 2.0]),
              seq1=random_seq(rng, 300), seq2=random_seq(rng, 40),
              is_max=False)
        for _ in range(3)
    ]
    monkeypatch.setattr(device, "accelerator_present", lambda: True)

    device_calls = []

    def fake_device(c1b, c2b, noffs, n2s, tables, **kw):
        device_calls.append(len(noffs))
        return [], lambda: [None] * len(noffs)

    monkeypatch.setattr(batch_mod, "batched_search_exact_async", fake_device)

    # bucket total 3*(261*40) = 31,320 pair-evals < threshold -> host path
    monkeypatch.setattr(CONFIG, "auto_threshold", 200_000_000)
    got = search_batch(queries, backend="auto")
    assert device_calls == []
    eng = AlignmentSearchEngine(queries[0].weights, False, backend="numpy")
    ref = eng.search(queries[0].seq1, queries[0].seq2)
    assert (got[0].offset, got[0].score) == (ref.offset, ref.score)

    # drop the threshold below the bucket size -> device path, one call
    monkeypatch.setattr(CONFIG, "auto_threshold", 1_000)
    search_batch(queries, backend="auto")
    assert device_calls == [3]


def test_parse_cases_golden_scratchpad():
    cases = read_cases(GOLDEN_INPUT)
    assert len(cases) == 5
    first = read_input(GOLDEN_INPUT)
    assert cases[0].seq1 == first.seq1 and cases[0].seq2 == first.seq2
    assert cases[0].is_max == first.is_max
    # psa-gen --cases: one seed per record, all the same shape and mode
    assert len(cases[4].seq1) == 9711 and len(cases[4].seq2) == 2131
    assert not cases[4].is_max and cases[4].seq1 != first.seq1


def test_parse_cases_rejects_empty():
    with pytest.raises(ValueError):
        parse_cases("1 2 3")


def test_parse_cases_ignores_numeric_junk_tail():
    # a >=7-token numeric stats row after real cases must not fabricate a
    # bogus case (the mode-token guard): only the real record survives
    text = "1 3 4 2\nABCDE\nABC\nminimum\n1 2 3 4 5 6 7\n"
    cases = parse_cases(text)
    assert len(cases) == 1 and cases[0].seq1 == "ABCDE"

    # but the FIRST record keeps the reference's lenient mode semantics
    # (any non-"maximum" token = minimum, cpu_funcs.c:365)
    cases = parse_cases("1 3 4 2 ABCDE ABC garbage")
    assert len(cases) == 1 and not cases[0].is_max


def test_cli_case_selector(tmp_path):
    from psa.utils.cli import main

    out = tmp_path / "o.txt"
    rc = main([GOLDEN_INPUT, "-o", str(out), "--case", "4",
               "--backend", "numpy", "--quiet"])
    assert rc == 0
    body = out.read_text()
    mutant, trailer = body.split("\n")
    assert len(mutant) == 2131

    # --case 0 must byte-match the default single-case run
    out0, out_def = tmp_path / "o0.txt", tmp_path / "od.txt"
    assert main([GOLDEN_INPUT, "-o", str(out0), "--case", "0",
                 "--backend", "numpy", "--quiet"]) == 0
    assert main([GOLDEN_INPUT, "-o", str(out_def),
                 "--backend", "numpy", "--quiet"]) == 0
    assert out0.read_text() == out_def.read_text()


def test_cli_batch_mode(tmp_path):
    from psa.utils.cli import main
    from psa.utils.generator import random_sequences

    # build a 4-case scratchpad file (two shape buckets, both modes)
    recs = []
    for seed, (n1, n2, mode) in enumerate(
            [(400, 60, "minimum"), (400, 60, "maximum"),
             (900, 150, "minimum"), (400, 60, "minimum")]):
        s1, s2 = random_sequences(n1, n2, seed=seed)
        recs.append(f"1 3 4 2\n{s1}\n{s2}\n{mode}")
    inp = tmp_path / "cases.txt"
    inp.write_text("\n".join(recs))

    outdir = tmp_path / "outs"
    rc = main([str(inp), "-o", str(outdir), "--batch",
               "--backend", "numpy", "--quiet"])
    assert rc == 0
    outs = sorted(p.name for p in outdir.iterdir())
    assert outs == [f"out_{i:04d}.txt" for i in range(4)]

    # each file must byte-match the corresponding --case single run
    for i in range(4):
        single = tmp_path / f"single_{i}.txt"
        assert main([str(inp), "-o", str(single), "--case", str(i),
                     "--backend", "numpy", "--quiet"]) == 0
        assert (outdir / f"out_{i:04d}.txt").read_text() == single.read_text()


def test_batched_exact_sharded_microbatch_pipeline(tables_min):
    """The sharded path streams through microbatches (per-shard count >
    micro_b) and still matches the non-sharded exact path."""
    import jax

    from psa.models.batch import batched_search_exact_sharded
    from psa.parallel.mesh import make_mesh

    rng = np.random.default_rng(31)
    n1, n2, l2p = 700, 120, 128
    l1k = 1024 + l2p
    B = 9
    c1b, c2b, noffs, n2s = _batch(rng, B, n1, n2, l1k, l2p)
    mesh = make_mesh(jax.devices()[:2], axis="dp")
    got = batched_search_exact_sharded(c1b, c2b, noffs, n2s, tables_min,
                                       mesh, interpret=True, micro_b=2)
    want = batched_search_exact(c1b, c2b, noffs, n2s, tables_min,
                                interpret=True)
    for q in range(B):
        assert (got[q].offset, got[q].char_offset, got[q].sub_code,
                got[q].score) == (want[q].offset, want[q].char_offset,
                                  want[q].sub_code, want[q].score), q


def test_cli_batch_sharded_device_path(tmp_path):
    """--batch --sharded --backend pallas routes buckets through the
    mesh-sharded exact device path (interpret on CPU) and still
    byte-matches per-case single runs."""
    from psa.utils.cli import main
    from psa.utils.generator import random_sequences

    recs = []
    for seed, (n1, n2, mode) in enumerate(
            [(400, 60, "minimum"), (400, 60, "maximum"),
             (400, 60, "minimum")]):
        s1, s2 = random_sequences(n1, n2, seed=40 + seed)
        recs.append(f"1 3 4 2\n{s1}\n{s2}\n{mode}")
    inp = tmp_path / "cases.txt"
    inp.write_text("\n".join(recs))

    outdir = tmp_path / "outs"
    rc = main([str(inp), "-o", str(outdir), "--batch", "--sharded",
               "--backend", "pallas", "--quiet"])
    assert rc == 0
    for i in range(3):
        single = tmp_path / f"single_{i}.txt"
        assert main([str(inp), "-o", str(single), "--case", str(i),
                     "--backend", "numpy", "--quiet"]) == 0
        assert (outdir / f"out_{i:04d}.txt").read_text() == single.read_text()


def test_pack_query_inputs_roundtrip_in_graph():
    """The single-upload input packing (6 codes per int32 word, 5 bits
    each) must bit-round-trip through the in-graph unpack, including code
    lengths that are not multiples of the pack width and all code values
    0..28 (PAD)."""
    import jax

    from psa.models.batch import (_packed_words, pack_query_inputs,
                                      unpack_query_inputs)

    rng = np.random.default_rng(0)
    b, l1k, l2p = 5, 640, 128              # 640 % 6 != 0, 128 % 6 != 0
    c1b = rng.integers(0, 29, (b, l1k), dtype=np.int32)
    c2b = rng.integers(0, 29, (b, l2p), dtype=np.int8)   # int8 input too
    noffs = np.array([1, 255, 256, 513, 100000], np.int32)
    buf = pack_query_inputs(c1b, c2b, noffs)
    assert buf.dtype == np.int32
    assert buf.shape == (b, _packed_words(l1k) + _packed_words(l2p) + 1)
    g1, g2, gn = jax.jit(
        lambda x: unpack_query_inputs(x, l1k, l2p))(buf)
    np.testing.assert_array_equal(np.asarray(g1), c1b)
    np.testing.assert_array_equal(np.asarray(g2), c2b.astype(np.int32))
    np.testing.assert_array_equal(np.asarray(gn), noffs)


def test_batched_exact_microbatch_pipeline(tables_min):
    """B=20 with micro_b=8 exercises the 2-deep pipeline, the power-of-two
    padding of the tail microbatch, and result reassembly in input order."""
    rng = np.random.default_rng(3)
    n1, n2, l1k, l2p = 600, 150, 768, 256
    B = 20
    c1b, c2b, noffs, n2s = _batch(rng, B, n1, n2, l1k, l2p)
    got = batched_search_exact(c1b, c2b, noffs, n2s, tables_min,
                               interpret=True, micro_b=8)
    assert len(got) == B
    for q in range(B):
        counts, maxrank = offset_stats_numpy(c1b[q][:n1], c2b[q][:n2],
                                             tables_min)
        ref = select_best(counts, maxrank, tables_min, c1b[q][:n1],
                          c2b[q][:n2])
        r = got[q]
        assert r is not None, q
        assert (r.offset, r.char_offset, r.sub_code, r.score) == (
            ref.offset, ref.char_offset, ref.sub_code, ref.score), q


def _device_bucket_queries(seed):
    from psa.utils.io import Query

    rng = np.random.default_rng(seed)
    return [Query(weights=np.array([1.0, 3.0, 4.0, 2.0]),
                  seq1=random_seq(rng, 400), seq2=random_seq(rng, 60),
                  is_max=False) for _ in range(3)]


@pytest.mark.parametrize("at", ["dispatch", "fetch"])
def test_search_batch_device_failure_raises(monkeypatch, at):
    """A device failure on a bucket raises — at dispatch or at fetch time —
    instead of silently answering from the host engine."""
    from psa.models import batch as batch_mod

    def boom(*a, **k):
        raise RuntimeError("device lost")

    if at == "dispatch":
        monkeypatch.setattr(batch_mod, "batched_search_exact_async", boom)
    else:
        monkeypatch.setattr(batch_mod, "batched_search_exact_async",
                            lambda *a, **k: ([], boom))
    with pytest.raises(RuntimeError, match="device lost"):
        search_batch(_device_bucket_queries(13), backend="pallas")


def test_search_batch_auto_device_failure_raises(monkeypatch):
    """Under backend=auto a bucket routed to the device raises on a device
    failure too: no bucket changes engine behind the caller's back."""
    from psa.config import CONFIG
    from psa.models import batch as batch_mod
    from psa.ops import device

    monkeypatch.setattr(device, "accelerator_present", lambda: True)
    monkeypatch.setattr(CONFIG, "auto_threshold", 1)  # everything -> device

    def boom(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(batch_mod, "batched_search_exact_async", boom)
    with pytest.raises(RuntimeError, match="device lost"):
        search_batch(_device_bucket_queries(17), backend="auto")


def test_search_batch_pallas_without_gpu_raises(monkeypatch):
    """No GPU and no interpret request: the device backend raises a clear
    error rather than interpreting or answering from the host."""
    from psa.ops.device import DeviceUnavailableError

    monkeypatch.delenv("PSA_INTERPRET", raising=False)
    with pytest.raises(DeviceUnavailableError, match="GPU"):
        search_batch(_device_bucket_queries(19), backend="pallas")


def test_dispatch_window_bounds_inflight():
    """_dispatch_all_spans must keep at most _DISPATCH_WINDOW microbatches
    in flight (every enqueued buffer stays alive until its program runs, so
    unbounded up-front dispatch held O(workload) device memory) while still
    completing every span in order."""
    from psa.models.batch import (_DISPATCH_WINDOW, _dispatch_all_spans,
                                      microbatch_spans)

    spans = microbatch_spans(33, 2)            # 17 spans of <= 2 queries
    live = {"now": 0, "max": 0}
    order = []

    def dispatch(s, e):
        live["now"] += 1
        live["max"] = max(live["max"], live["now"])
        return (s, e)

    results = [None] * 33

    def finish_one(span, dev):
        live["now"] -= 1
        assert span == dev
        order.append(span)
        s, e = span
        results[s:e] = list(range(s, e))

    handles, fin = _dispatch_all_spans(spans, dispatch, finish_one, results)
    assert len(handles) <= _DISPATCH_WINDOW
    out = fin()
    # +1: the refill dispatches before blocking on the oldest fetch so the
    # new upload overlaps it (see _dispatch_all_spans docstring)
    assert live["max"] <= _DISPATCH_WINDOW + 1
    assert live["now"] == 0
    assert order == spans                      # fetches stay in input order
    assert out == list(range(33))


def test_pack_epilogue_outputs_compact_roundtrip():
    """Compact (int16-pair) epilogue packing must bit-round-trip, including
    maxrank -1 sentinels in both halves of a word and count values at the
    int16 boundary."""
    import jax.numpy as jnp

    from psa.models.batch import (epilogue_compact,
                                      pack_epilogue_outputs,
                                      unpack_epilogue_outputs)

    assert epilogue_compact(2048, 512)
    assert not epilogue_compact(40960, 512)      # big offset range
    assert not epilogue_compact(2048, 40960)     # big seq2

    rng = np.random.default_rng(3)
    b, k = 4, 32
    topi = rng.integers(0, 32767, (b, k), dtype=np.int32)
    stats = rng.integers(0, 32767, (b, 5, k), dtype=np.int32)
    stats[:, 4, ::3] = -1                        # maxrank sentinels
    near = rng.integers(0, 1 << 20, b, dtype=np.int32)
    best = rng.standard_normal(b).astype(np.float32)
    best[0] = -np.inf
    for compact in (False, True):
        buf = np.asarray(pack_epilogue_outputs(
            jnp.asarray(topi), jnp.asarray(stats), jnp.asarray(near),
            jnp.asarray(best), compact))
        assert buf.shape[1] == (3 * k + 2 if compact else 6 * k + 2)
        g_topi, g_stats, g_near, g_best = unpack_epilogue_outputs(
            buf, k, compact)
        np.testing.assert_array_equal(g_topi, topi)
        np.testing.assert_array_equal(g_stats, stats)
        np.testing.assert_array_equal(g_near, near)
        np.testing.assert_array_equal(g_best, best)


def test_batched_exact_noncompact_gate_end_to_end():
    """A bucket past the int16 gate (noff_pad >= 32768) must run the
    NON-compact epilogue wire format end-to-end and still match the
    oracle — CI's other shapes all take the compact path."""
    from psa.core.alphabet import pad_codes
    from psa.core.oracle import offset_stats_numpy
    from psa.core.tables import build_tables
    from psa.models.batch import batched_search_exact, epilogue_compact
    from psa.ops.select import select_best

    l2p, noff_pad = 128, 32768
    l1k = noff_pad + l2p
    assert not epilogue_compact(noff_pad, l2p)
    t = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    rng = np.random.default_rng(21)
    n1, n2 = 32650, 100
    c1 = rng.integers(0, 26, n1, dtype=np.int32)
    c2 = rng.integers(0, 26, n2, dtype=np.int32)
    noff = n1 - n2 + 1
    rs = batched_search_exact(pad_codes(c1, l1k)[None], pad_codes(c2, l2p)[None],
                              np.array([noff], np.int32),
                              np.array([n2], np.int32), t, interpret=True)
    counts, maxrank = offset_stats_numpy(c1, c2, t)
    ref = select_best(counts, maxrank, t, c1, c2)
    got = rs[0]
    assert (got.offset, got.char_offset, got.sub_code, got.score) == (
        ref.offset, ref.char_offset, ref.sub_code, ref.score)


def test_runner_cache_lru_eviction():
    """The runner caches evict least-recently-used entries past the cap so
    a long-lived server with unbounded weight diversity cannot accumulate
    XLA executables forever."""
    from psa.models import batch as bm

    cache: dict = {}
    old = bm._RUNNER_CACHE_CAP
    try:
        bm._RUNNER_CACHE_CAP = 3
        for i in range(5):
            bm._cache_put(cache, i, f"r{i}")
        assert list(cache) == [2, 3, 4]
        assert bm._cache_get(cache, 2) == "r2"     # refreshes recency
        bm._cache_put(cache, 5, "r5")
        assert list(cache) == [4, 2, 5]            # 3 evicted, 2 kept
        assert bm._cache_get(cache, 99) is None
    finally:
        bm._RUNNER_CACHE_CAP = old
