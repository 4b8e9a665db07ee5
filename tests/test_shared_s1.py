"""Dedup-Seq1 wire variant (many Seq2 reads vs one Seq1 reference).

When every query in a bucket shares Seq1, the batch path ships it ONCE per
workload and every query's kernel program reads that one row
(models/batch.pack_query_inputs_shared) — per-query upload bytes drop ~3x.
Results must be bit-identical to the per-row path and the oracle.
"""

from __future__ import annotations

import numpy as np

from psa.core.alphabet import pad_codes
from psa.core.tables import build_tables
from psa.models import batch as bm
from psa.models.search import AlignmentSearchEngine
from psa.ops.common import plan_shapes

from conftest import random_codes


def _shared_batch(rng, b, n1, n2):
    _, _, l2p, l1k = plan_shapes(n1, n2)
    c1 = random_codes(rng, n1, 0.05)
    c1b = np.broadcast_to(pad_codes(c1, l1k), (b, l1k)).copy()
    c2b = np.stack([pad_codes(random_codes(rng, n2, 0.05), l2p)
                    for _ in range(b)])
    noffs = np.full(b, n1 - n2 + 1, np.int32)
    n2s = np.full(b, n2, np.int32)
    return c1, c1b, c2b, noffs, n2s, l1k, l2p


def test_shared_s1_auto_detected_and_exact():
    rng = np.random.default_rng(101)
    b, n1, n2 = 6, 900, 130
    c1, c1b, c2b, noffs, n2s, l1k, l2p = _shared_batch(rng, b, n1, n2)
    w = np.array([1.0, 3.0, 4.0, 2.0])
    t = build_tables(w, False)

    rs = bm.batched_search_exact(c1b, c2b, noffs, n2s, t, interpret=True)
    # the dedup variant's runner key was used
    key = bm._fused_runner_key(t, bm._round_batch(b, 1024), l1k, l2p, True,
                               bm.TOPK, shared_s1=True)
    assert bm.runner_is_warm(key)

    ref_eng = AlignmentSearchEngine(w, False, backend="numpy")
    for q in range(b):
        ref = ref_eng.search_codes(c1, c2b[q][:n2])
        got = rs[q]
        assert (got.offset, got.char_offset, got.sub_code, got.score) == (
            ref.offset, ref.char_offset, ref.sub_code, ref.score), q


def test_shared_vs_per_row_bit_identical():
    """Forcing the per-row path on the same shared-Seq1 batch must give
    identical results (including an adversarial all-OTHER row and the
    numpy-oracle winners)."""
    rng = np.random.default_rng(202)
    b, n1, n2 = 5, 700, 120
    c1, c1b, c2b, noffs, n2s, l1k, l2p = _shared_batch(rng, b, n1, n2)
    c2b[3, :n2] = 27          # OTHER everywhere (lenient-mode input)
    w = np.array([0.9, 2.8, 4.4, 1.7]) * np.pi / 3
    t = build_tables(w, True)

    rs_shared = bm.batched_search_exact(c1b, c2b, noffs, n2s, t,
                                        interpret=True, shared_s1=True)
    rs_rows = bm.batched_search_exact(c1b, c2b, noffs, n2s, t,
                                      interpret=True, shared_s1=False)
    assert len(rs_shared) == len(rs_rows) == b
    from psa.core.result import NoMutationFound

    ref_eng = AlignmentSearchEngine(w, True, backend="numpy",
                                    strict_alphabet=False)
    for q, (a, r) in enumerate(zip(rs_shared, rs_rows)):
        try:
            ref = ref_eng.search_codes(c1, c2b[q][:n2])
        except NoMutationFound:
            ref = None
        got = (None if a is None else
               (a.offset, a.char_offset, a.sub_code, a.score))
        want = (None if ref is None else
                (ref.offset, ref.char_offset, ref.sub_code, ref.score))
        assert got == want, q
    for a, r in zip(rs_shared, rs_rows):
        if a is None:
            assert r is None
            continue
        assert (a.offset, a.char_offset, a.sub_code, a.score) == (
            r.offset, r.char_offset, r.sub_code, r.score)


def test_search_batch_shared_seq1_end_to_end():
    """search_batch with one reference Seq1 and many reads routes through
    the dedup variant and matches per-query engine results."""
    from psa.core.alphabet import decode
    from psa.utils.io import Query

    rng = np.random.default_rng(303)
    n1, n2 = 800, 110
    s1 = decode(random_codes(rng, n1, 0.05))
    w = np.array([1.0, 3.0, 4.0, 2.0])
    queries = []
    for _ in range(4):
        s2 = decode(random_codes(rng, n2, 0.05))
        queries.append(Query(weights=w, seq1=s1, seq2=s2, is_max=False))
    rs = bm.search_batch(queries, backend="pallas")
    eng = AlignmentSearchEngine(w, False, backend="numpy")
    for q, got in zip(queries, rs):
        ref = eng.search(q.seq1, q.seq2)
        assert (got.offset, got.char_offset, got.sub_code, got.score) == (
            ref.offset, ref.char_offset, ref.sub_code, ref.score)


def test_shared_s1_sharded_mesh_exact():
    """Dedup-Seq1 on the mesh-sharded batch path: one replicated Seq1
    operand, batch axis sharded, results oracle-exact."""
    import jax

    from psa.parallel.mesh import make_mesh

    rng = np.random.default_rng(505)
    b, n1, n2 = 6, 700, 120
    c1, c1b, c2b, noffs, n2s, l1k, l2p = _shared_batch(rng, b, n1, n2)
    w = np.array([1.0, 3.0, 4.0, 2.0])
    t = build_tables(w, False)
    ndev = min(2, len(jax.devices()))
    mesh = make_mesh(jax.devices()[:ndev], axis="dp")
    rs = bm.batched_search_exact_sharded(c1b, c2b, noffs, n2s, t, mesh,
                                         interpret=True)
    key = bm._sharded_runner_key(
        t, bm._round_batch(-(-b // ndev), 1024) * ndev, l1k, l2p, mesh,
        True, bm.TOPK, shared_s1=True)
    assert bm.runner_is_warm(key)
    ref_eng = AlignmentSearchEngine(w, False, backend="numpy")
    for q in range(b):
        ref = ref_eng.search_codes(c1, c2b[q][:n2])
        got = rs[q]
        assert (got.offset, got.char_offset, got.sub_code, got.score) == (
            ref.offset, ref.char_offset, ref.sub_code, ref.score), q


def test_shared_kernel_multi_tile_bit_identical():
    """The shared-Seq1 kernel operand (ONE Seq1 row, read by every query's
    programs) must bit-match the per-row operand across multiple tiles,
    chunks and queries."""
    import jax.numpy as jnp

    from psa.ops import pallas_sweep as ps

    rng = np.random.default_rng(606)
    b, n1, n2 = 4, 2600, 500
    _, noff_pad, l2p, l1k = plan_shapes(n1, n2)
    c1p = pad_codes(random_codes(rng, n1, 0.05), l1k)
    c2b = np.stack([pad_codes(random_codes(rng, n2, 0.05), l2p)
                    for _ in range(b)])
    code_t = ps.code_table_t(build_tables(
        np.array([1.0, 3.0, 4.0, 2.0]), False).code)
    assert noff_pad // 256 >= 2   # multi-tile is the point
    ref = np.asarray(ps.sweep_stats5(
        jnp.asarray(np.broadcast_to(c1p, (b, l1k))), jnp.asarray(c2b),
        code_t, interpret=True))
    got = np.asarray(ps.sweep_stats5(
        jnp.asarray(c1p[None]), jnp.asarray(c2b), code_t, interpret=True))
    np.testing.assert_array_equal(got, ref)


def test_shared_s1_multi_microbatch_spans():
    """Shared Seq1 across several microbatches: one c1 upload, every span
    through the dedup runner, exact results."""
    rng = np.random.default_rng(404)
    b, n1, n2 = 9, 600, 100
    c1, c1b, c2b, noffs, n2s, l1k, l2p = _shared_batch(rng, b, n1, n2)
    w = np.array([1.0, 3.0, 4.0, 2.0])
    t = build_tables(w, False)
    rs = bm.batched_search_exact(c1b, c2b, noffs, n2s, t, interpret=True,
                                 micro_b=4)
    ref_eng = AlignmentSearchEngine(w, False, backend="numpy")
    for q in range(b):
        ref = ref_eng.search_codes(c1, c2b[q][:n2])
        got = rs[q]
        assert (got.offset, got.char_offset, got.sub_code, got.score) == (
            ref.offset, ref.char_offset, ref.sub_code, ref.score), q
