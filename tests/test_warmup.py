"""Bucket warmup + cold-bucket host routing.

A serve reply must never wait out a compile: buckets whose runner is not yet
compiled answer from
the host engine while a single background thread compiles them
(models/batch.warm_bucket_async), and `psa --serve --warmup FILE`
pre-compiles declared buckets before serving starts.
"""

from __future__ import annotations

import io
import sys

import numpy as np

from psa.core.tables import build_tables
from psa.models import batch as bm
from psa.utils.generator import random_sequences
from psa.utils.io import Query


def _queries(n=3, n1=600, n2=100, w=(1.0, 3.0, 4.0, 2.0)):
    qs = []
    for seed in range(n):
        s1, s2 = random_sequences(n1, n2, seed=seed)
        qs.append(Query(weights=np.asarray(w, np.float64), seq1=s1, seq2=s2,
                        is_max=False))
    return qs


def _bucket_shapes(n1=600, n2=100):
    from psa.ops.common import plan_shapes

    _, _, l2p, l1k = plan_shapes(n1, n2)
    return l1k, l2p


def _forget(keys):
    """Force the cold state for a set of runner keys (warm state is
    process-global, and keys are weights-generic, so earlier tests on the
    same shape bucket may have warmed them)."""
    with bm._CACHE_LOCK:
        for kk in keys:
            bm._WARM_KEYS.discard(kk)
            bm._EXACT_RUNNERS.pop(kk, None)


def test_warm_fused_runner_marks_planned_keys_warm():
    w = np.array([1.125, 3.375, 4.625, 2.875])
    t = build_tables(w, False)
    l1k, l2p = _bucket_shapes()
    keys = bm.planned_runner_keys(t, 3, l1k, l2p)
    assert len(keys) == 1
    (key,) = keys
    _forget(keys)
    assert not bm.runner_is_warm(key)
    bm.warm_fused_runner(t, bm.runner_key_batch(key), l1k, l2p)
    assert bm.runner_is_warm(key)
    # and the planned keys mirror the dispatch plan exactly: a dispatch for
    # the same bucket now hits the (warm) cached runner
    assert bm._cache_get(bm._EXACT_RUNNERS, key) is not None


def test_planned_keys_cover_multi_microbatch_and_sharded_plans():
    import jax

    w = np.array([1.0, 3.0, 4.0, 2.0])
    t = build_tables(w, False)
    l1k, l2p = _bucket_shapes()
    ks = bm.planned_runner_keys(t, 2500, l1k, l2p, micro_b=1024)
    assert sorted(bm.runner_key_batch(k) for k in ks) == [512, 1024]
    from psa.parallel.mesh import make_mesh

    mesh = make_mesh(jax.devices()[:4], axis="dp")
    ks = bm.planned_runner_keys(t, 6, l1k, l2p, mesh=mesh, micro_b=1024)
    assert [k[0] for k in ks] == ["fused-shardedW"]
    assert sorted(bm.runner_key_batch(k) for k in ks) == [8]  # ceil(6/4)->2
    #                                                     pow2, *4 devices


def test_cold_bucket_routes_to_host_then_warms(monkeypatch):
    w = (1.0, 2.75, 4.5, 2.0)
    qs = _queries(w=w)
    t = build_tables(np.asarray(w), False)
    l1k, l2p = _bucket_shapes()
    _forget(bm.planned_runner_keys(t, len(qs), l1k, l2p))
    calls = []
    real = bm.batched_search_exact_async

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(bm, "batched_search_exact_async", spy)

    # chunk 1: bucket cold -> host engine answers, background warm queued
    _, finish = bm.search_batch_async(qs, backend="pallas", cold_route=True)
    rs1 = finish()
    assert calls == []                 # no device dispatch on the cold chunk
    assert all(r is not None for r in rs1)
    # interpret mode takes ~1 s; a cold GPU compile takes seconds
    assert bm.warmup_join(timeout=600)

    # chunk 2: bucket warm -> device path, bit-identical results
    _, finish = bm.search_batch_async(qs, backend="pallas", cold_route=True)
    rs2 = finish()
    assert calls                       # device dispatch happened
    for a, b in zip(rs1, rs2):
        assert (a.offset, a.char_offset, a.sub_code, a.score) == \
            (b.offset, b.char_offset, b.sub_code, b.score)


def test_weights_generic_runner_shared_across_weights():
    """Two different weight vectors on the same (mode, B, shapes) bucket
    must hit ONE cached runner program (the weights enter as operands) —
    the property that makes new-weights traffic compile-free — and both
    must stay bit-exact vs the oracle."""
    from psa.core.alphabet import pad_codes
    from psa.models.search import AlignmentSearchEngine
    from psa.ops.common import plan_shapes

    rng = np.random.default_rng(77)
    n1, n2 = 700, 120
    _, _, l2p, l1k = plan_shapes(n1, n2)
    c1 = rng.integers(0, 26, n1, dtype=np.int32)
    c2 = rng.integers(0, 26, n2, dtype=np.int32)
    c1b = pad_codes(c1, l1k)[None]
    c2b = pad_codes(c2, l2p)[None]
    noffs = np.array([n1 - n2 + 1], np.int32)
    n2s = np.array([n2], np.int32)

    w_a = np.array([1.0, 3.0, 4.0, 2.0])
    w_b = np.array([0.7, 2.9, 5.3, 1.1]) * np.pi / 3   # irrational
    t_a = build_tables(w_a, False)
    t_b = build_tables(w_b, False)
    key_a = bm.planned_runner_keys(t_a, 1, l1k, l2p)
    key_b = bm.planned_runner_keys(t_b, 1, l1k, l2p)
    assert key_a == key_b                    # weights-free keys

    n_runners_before = len(bm._EXACT_RUNNERS)
    rs_a = bm.batched_search_exact(c1b, c2b, noffs, n2s, t_a,
                                   interpret=True)
    rs_b = bm.batched_search_exact(c1b, c2b, noffs, n2s, t_b,
                                   interpret=True)
    # at most one NEW runner was created for both weight vectors
    assert len(bm._EXACT_RUNNERS) <= n_runners_before + 1

    for w, rs in ((w_a, rs_a), (w_b, rs_b)):
        ref = AlignmentSearchEngine(w, False,
                                    backend="numpy").search_codes(c1, c2)
        got = rs[0]
        assert (got.offset, got.char_offset, got.sub_code, got.score) == (
            ref.offset, ref.char_offset, ref.sub_code, ref.score), w


def test_warm_sharded_runner_and_cold_route_with_mesh():
    """warm_fused_runner(mesh=...) pre-compiles the mesh-sharded runner,
    and a sharded dispatch then hits the warm cache."""
    import jax

    from psa.parallel.mesh import make_mesh

    w = np.array([1.0, 3.0, 4.0, 2.0])
    t = build_tables(w, False)
    l1k, l2p = _bucket_shapes()
    mesh = make_mesh(jax.devices()[:2], axis="dp")
    keys = bm.planned_runner_keys(t, 3, l1k, l2p, mesh=mesh)
    assert len(keys) == 1
    (key,) = keys
    _forget(keys)
    assert not bm.runner_is_warm(key)
    bm.warm_fused_runner(t, bm.runner_key_batch(key), l1k, l2p, mesh=mesh)
    assert bm.runner_is_warm(key)
    qs = _queries(3)
    _, finish = bm.search_batch_async(qs, backend="pallas", mesh=mesh,
                                      cold_route=True)
    rs = finish()
    assert all(r is not None for r in rs)


def test_warmer_gives_up_after_repeated_failures():
    """A deterministically-failing bucket compile must not monopolize the
    single background warmer: after _MAX_FAILURES attempts the key is
    dropped and further submits are refused (the bucket stays
    host-routed)."""
    key = ("fusedW", False, 999991, 640, 128, True, 32)   # synthetic
    _forget([key])
    calls = []

    def boom():
        calls.append(1)
        raise RuntimeError("synthetic compile failure")

    import time

    for i in range(bm._WARMER._MAX_FAILURES):
        assert bm._WARMER.submit(key, boom) is True, i
        assert bm.warmup_join(timeout=30)
    assert len(calls) == bm._WARMER._MAX_FAILURES
    # memoized failure: no further attempts are queued
    assert bm._WARMER.submit(key, boom) is False
    time.sleep(0.05)
    assert len(calls) == bm._WARMER._MAX_FAILURES
    with bm._CACHE_LOCK:                      # cleanup for other tests
        bm._WARMER._failures.pop(key, None)


def test_cold_route_policy_env_override(monkeypatch):
    from psa.utils.server import cold_route_default

    monkeypatch.setenv("PSA_COLD_ROUTE", "1")
    assert cold_route_default("native") is True
    monkeypatch.setenv("PSA_COLD_ROUTE", "0")
    assert cold_route_default("pallas") is False
    monkeypatch.delenv("PSA_COLD_ROUTE")
    assert cold_route_default("native") is False   # host backend: never
    # platform default: ON with an accelerator present (a cold bucket is a
    # compile inside the reply path), OFF on the CPU test platform (the
    # device path should be exercised directly)
    from psa.ops import device

    assert cold_route_default("pallas") is False
    monkeypatch.setattr(device, "accelerator_present", lambda: True)
    assert cold_route_default("pallas") is True


def test_cli_serve_warmup_precompiles(monkeypatch, capsys, tmp_path):
    from psa.core.tables import build_tables_cached
    from psa.utils.cli import main

    w = (1.5, 3.25, 4.0, 2.0)
    s1, s2 = random_sequences(600, 100, seed=42)
    line = " ".join("%g" % x for x in w) + f" {s1} {s2} minimum"
    wf = tmp_path / "warm.txt"
    wf.write_text(line + "\n")
    t0 = build_tables_cached(np.asarray(w), False)
    l1k, l2p = _bucket_shapes()
    _forget(bm.planned_runner_keys(t0, 4, l1k, l2p))
    # the test is about --warmup itself; without this, on real hardware
    # the B=1 serve chunk would cold-route and queue a background compile
    # that outlives the test
    monkeypatch.setenv("PSA_COLD_ROUTE", "0")

    monkeypatch.setattr(sys, "stdin", io.StringIO(line + "\n"))
    assert main(["--serve", "--quiet", "--backend", "pallas",
                 "--serve-batch", "4", "--warmup", str(wf)]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and not out[0].startswith("error")

    # the full-chunk (B=4) runner the warmup compiled is warm
    t = build_tables_cached(np.asarray(w), False)
    l1k, l2p = _bucket_shapes()
    for key in bm.planned_runner_keys(t, 4, l1k, l2p):
        assert bm.runner_is_warm(key)


def test_cli_serve_warmup_shared_pattern_warms_s1_variant(monkeypatch,
                                                         capsys, tmp_path):
    """A warmup file whose bucket queries share one Seq1 pre-compiles the
    dedup-Seq1 runner variant (plus the plain one for mixed chunks)."""
    from psa.core.tables import build_tables_cached
    from psa.utils.cli import main

    w = (2.5, 3.0, 4.0, 1.75)
    s1, _ = random_sequences(600, 100, seed=7)
    lines = []
    for seed in (8, 9):
        _, s2 = random_sequences(600, 100, seed=seed)
        lines.append(" ".join("%g" % x for x in w) + f" {s1} {s2} minimum")
    wf = tmp_path / "warm_shared.txt"
    wf.write_text("\n".join(lines) + "\n")
    t = build_tables_cached(np.asarray(w), False)
    l1k, l2p = _bucket_shapes()
    plain = bm.planned_runner_keys(t, 4, l1k, l2p)
    s1keys = bm.planned_runner_keys(t, 4, l1k, l2p, shared_s1=True)
    _forget(plain | s1keys)
    monkeypatch.setenv("PSA_COLD_ROUTE", "0")
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(lines) + "\n"))
    assert main(["--serve", "--quiet", "--backend", "pallas",
                 "--serve-batch", "4", "--warmup", str(wf)]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 2 and not any(o.startswith("error") for o in out)
    for key in plain | s1keys:
        assert bm.runner_is_warm(key), key


def test_cli_serve_warmup_sizes_ladder(monkeypatch, capsys, tmp_path):
    """--warmup-sizes ladder pre-compiles the power-of-two batch ladder per
    declared bucket, so PARTIAL chunks (which dispatch at smaller pow2
    bucket sizes) also skip the cold compile — the r4 advisor's finding that
    full-chunk-only warming undercuts the feature for trickle traffic."""
    from psa.core.tables import build_tables_cached
    from psa.utils.cli import main

    w = (1.25, 3.5, 4.0, 2.0)
    s1, s2 = random_sequences(600, 100, seed=11)
    line = " ".join("%g" % x for x in w) + f" {s1} {s2} minimum"
    wf = tmp_path / "warm_ladder.txt"
    wf.write_text(line + "\n")
    t = build_tables_cached(np.asarray(w), False)
    l1k, l2p = _bucket_shapes()
    ladder_keys: set = set()
    for bsz in (1, 2, 4):
        ladder_keys |= bm.planned_runner_keys(t, bsz, l1k, l2p)
    assert sorted(bm.runner_key_batch(k) for k in ladder_keys) == [1, 2, 4]
    _forget(ladder_keys)
    monkeypatch.setenv("PSA_COLD_ROUTE", "0")
    monkeypatch.setattr(sys, "stdin", io.StringIO(line + "\n"))
    assert main(["--serve", "--quiet", "--backend", "pallas",
                 "--serve-batch", "4", "--warmup", str(wf),
                 "--warmup-sizes", "ladder"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and not out[0].startswith("error")
    for key in ladder_keys:
        assert bm.runner_is_warm(key), key


def test_cli_warmup_bad_sizes_spec_errors(monkeypatch, capsys, tmp_path):
    from psa.utils.cli import main

    wf = tmp_path / "w.txt"
    wf.write_text("1 3 4 2 ABC AB minimum\n")
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    assert main(["--serve", "--quiet", "--warmup", str(wf),
                 "--warmup-sizes", "4,banana"]) == 2
    assert "bad --warmup-sizes" in capsys.readouterr().err


def test_cli_warmup_missing_file_errors(monkeypatch, capsys):
    from psa.utils.cli import main

    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    assert main(["--serve", "--quiet", "--warmup", "/nonexistent/w.txt"]) == 2
    assert "cannot read --warmup" in capsys.readouterr().err
