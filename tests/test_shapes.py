"""Property tests for padding/tiling plans: every shape the planners emit
must satisfy the kernel's alignment invariants, for arbitrary input sizes."""

import numpy as np
import pytest

from psa.ops.common import CHUNK, TILE_O, bucket_len, plan_shapes, round_up
from psa.parallel.mesh import pad_for_mesh, pad_for_mesh_2d

from conftest import random_codes


def test_plan_shapes_invariants():
    rng = np.random.default_rng(0)
    for _ in range(200):
        n2 = int(rng.integers(1, 20000))
        n1 = n2 + int(rng.integers(0, 200000))
        noff, noff_pad, l2p, l1k = plan_shapes(n1, n2)
        assert noff == n1 - n2 + 1
        assert noff_pad >= noff
        assert l2p >= n2 and l2p % CHUNK == 0
        assert noff_pad % TILE_O == 0
        # every padded offset's full window fits in the padded seq1
        assert l1k == noff_pad + l2p


def test_plan_shapes_padding_below_one_block():
    """Padding waste is below one kernel block on each axis."""
    for n1, n2 in [(1, 1), (TILE_O, 1), (TILE_O + 1, 2), (1000, 999),
                   (131071 + 8191, 8192), (10**6, 2048)]:
        noff, noff_pad, l2p, _ = plan_shapes(n1, n2)
        assert 0 <= noff_pad - noff < TILE_O
        assert 0 <= l2p - max(n2, CHUNK) < CHUNK


def test_kernel_block_is_power_of_two():
    """The Triton route takes power-of-two blocks only."""
    for n in (TILE_O, CHUNK):
        assert n > 0 and n & (n - 1) == 0


def test_pad_for_mesh_invariants():
    rng = np.random.default_rng(1)
    for n_shards in (1, 2, 4, 8):
        for _ in range(30):
            n2 = int(rng.integers(1, 3000))
            n1 = n2 + int(rng.integers(0, 50000))
            c1 = random_codes(rng, n1)
            c2 = random_codes(rng, n2)
            c1p, c2p, noff = pad_for_mesh(c1, c2, n_shards)
            noff_pad = c1p.shape[0] - c2p.shape[0]
            assert noff == n1 - n2 + 1
            assert noff_pad % (n_shards * TILE_O) == 0
            assert c2p.shape[0] % CHUNK == 0
            per_shard = noff_pad // n_shards
            # each shard's window [o0, o0 + per_shard + l2p) fits
            assert (n_shards - 1) * per_shard + per_shard + c2p.shape[0] \
                <= c1p.shape[0]
            # payload preserved
            np.testing.assert_array_equal(c1p[:n1], c1)
            np.testing.assert_array_equal(c2p[:n2], c2)


def test_bucket_len_monotone_and_bounded():
    prev = 0
    for n in range(1, 5000, 37):
        b = bucket_len(n)
        assert b >= n and b % 128 == 0
        assert b >= prev or n < prev  # monotone in n
        prev = b
        # geometric buckets waste at most ~50%
        assert b <= max(512, round_up(n * 3 // 2 + 128, 128))


def test_round_batch_invariants():
    """Microbatch rounding: power of two, >= n, capped but never below n,
    and 1 maps to 1 (dummy rows sweep their full shape — a padded-to-8
    oversized single query would run its sweep eight times)."""
    from psa.models.batch import _round_batch

    assert _round_batch(1, 1024) == 1
    for cap in (8, 100, 1024):
        for n in list(range(1, 70)) + [127, 128, 129, 1000, 1024, 5000]:
            r = _round_batch(n, cap)
            assert r >= n                       # never truncates the batch
            # a power of two, or the cap itself, or exactly n (n > cap)
            assert (r & (r - 1) == 0) or r == cap or r == n
            if n <= cap:
                assert r <= cap                 # compile-size bounded


@pytest.mark.parametrize("n_op,n_ch", [(1, 2), (2, 2), (1, 4), (4, 1)])
def test_pad_for_mesh_2d_invariants(n_op, n_ch):
    rng = np.random.default_rng(3)
    for _ in range(20):
        n2 = int(rng.integers(1, 3000))
        n1 = n2 + int(rng.integers(0, 50000))
        c1p, c2p, noff = pad_for_mesh_2d(random_codes(rng, n1),
                                         random_codes(rng, n2), n_op, n_ch)
        noff_pad = c1p.shape[0] - c2p.shape[0]
        assert noff == n1 - n2 + 1 and noff_pad >= noff
        assert noff_pad % (n_op * n_ch * TILE_O) == 0
        assert c2p.shape[0] % (n_ch * CHUNK) == 0


def test_microbatch_spans_partition():
    """The pipeline's span arithmetic must partition [0, B) exactly —
    tested on the real helper batched_search_exact iterates over."""
    from psa.models.batch import microbatch_spans

    for b_n in (1, 7, 8, 1000, 1024, 2049):
        for mb in (1, 8, 1000, 1024):
            spans = microbatch_spans(b_n, mb)
            assert spans[0][0] == 0 and spans[-1][1] == b_n
            for (a0, a1), (b0, _) in zip(spans, spans[1:]):
                assert a1 == b0 and a1 - a0 == mb
            assert all(e - s >= 1 for s, e in spans)
