"""Tests that need an NVIDIA GPU: the compiled sweep kernel (no interpret
mode) and the device paths built on it.  They skip elsewhere; on a card run
`PSA_INTERPRET=0 python -m pytest -m gpu tests/` (chip_smoke.py does)."""

import jax.numpy as jnp
import numpy as np
import pytest

from psa.core.alphabet import pad_codes
from psa.core.oracle import offset_stats_numpy
from psa.core.tables import build_tables
from psa.models.search import AlignmentSearchEngine
from psa.ops.common import plan_shapes

from conftest import random_codes
from test_device import KERNEL_CASES

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_compiled_kernel_matches_oracle(gpu, case):
    from psa.ops.device import sweep_kernel
    from psa.ops.pallas_sweep import code_table_t, sweep_stats5

    sweep = sweep_kernel()
    assert sweep is sweep_stats5          # compiled, not interpreted
    n1, n2, b, shared, other = KERNEL_CASES[case]
    rng = np.random.default_rng(len(case))
    tables = build_tables(np.array([1.5, 2.0, 0.5, 3.0]), False)
    noff, _, l2p, l1k = plan_shapes(n1, n2)
    c1s = [random_codes(rng, n1) for _ in range(1 if shared else b)]
    c2s = [random_codes(rng, n2) for _ in range(b)]
    if other:
        c1s[0][::7] = 27
        c2s[0][::5] = 27
    out = np.asarray(sweep(
        jnp.asarray(np.stack([pad_codes(c, l1k) for c in c1s])),
        jnp.asarray(np.stack([pad_codes(c, l2p) for c in c2s])),
        code_table_t(tables.code)))
    for q in range(b):
        counts, maxrank = offset_stats_numpy(c1s[0 if shared else q], c2s[q],
                                             tables)
        np.testing.assert_array_equal(out[q, :4, :noff].T, counts)
        np.testing.assert_array_equal(out[q, 4, :noff], maxrank)


@pytest.mark.parametrize("is_max", [False, True])
def test_golden_through_device(gpu, golden_query, is_max):
    c1 = golden_query.seq1
    c2 = golden_query.seq2
    ref = AlignmentSearchEngine(golden_query.weights, is_max,
                                backend="native").search(c1, c2)
    got = AlignmentSearchEngine(golden_query.weights, is_max,
                                backend="pallas").search(c1, c2)
    assert got == ref


@pytest.mark.parametrize("shared", [False, True])
def test_batch_exact_on_device(gpu, shared):
    from psa.models.batch import batched_search_exact

    rng = np.random.default_rng(3)
    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    b, n1, n2 = 37, 900, 200
    _, _, l2p, l1k = plan_shapes(n1, n2)
    c1b = np.stack([pad_codes(random_codes(rng, n1), l1k) for _ in range(b)])
    if shared:
        c1b[:] = c1b[0]
    c2b = np.stack([pad_codes(random_codes(rng, n2), l2p) for _ in range(b)])
    rs = batched_search_exact(c1b, c2b, np.full(b, n1 - n2 + 1, np.int32),
                              np.full(b, n2, np.int32), tables)
    eng = AlignmentSearchEngine(tables.weights, False, backend="numpy")
    for q in range(b):
        assert rs[q] == eng.search_codes(c1b[q][:n1], c2b[q][:n2]), q


def test_sharded_search_on_device(gpu):
    import jax

    from psa.parallel.mesh import make_mesh, search_sharded

    rng = np.random.default_rng(4)
    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), True)
    c1, c2 = random_codes(rng, 5000), random_codes(rng, 300)
    got = search_sharded(c1, c2, tables, make_mesh(jax.devices()),
                         kernel="pallas")
    ref = AlignmentSearchEngine(tables.weights, True,
                                backend="numpy").search_codes(c1, c2)
    assert got == ref
