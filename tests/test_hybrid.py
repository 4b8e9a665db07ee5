"""Hybrid backend: concurrent host+device split of one query.

The literal analog of the reference's cuda_percentage flag
(main.c:30-42, cpu_funcs.c:144-150): the accelerator takes the first
--device-share% of offsets, the C++/OpenMP host engine the rest in
parallel, winners merged under the canonical tie-break
(is_swapable, cuda_funcs.cu:290-307).
"""

import numpy as np
import pytest

from conftest import GOLDEN_INPUT, random_codes
from psa.models.search import AlignmentSearchEngine, native_available

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="native engine unavailable")

W = np.array([1.0, 3.0, 4.0, 2.0])


def _engine(is_max, share, weights=W):
    return AlignmentSearchEngine(weights, is_max, backend="hybrid",
                                 device_share=share)


@pytest.mark.parametrize("is_max", [False, True])
@pytest.mark.parametrize("share", [0, 30, 50, 80, 100])
def test_hybrid_matches_native_full_range(is_max, share):
    rng = np.random.default_rng(1000 + share + is_max)
    c1 = random_codes(rng, 1500)
    c2 = random_codes(rng, 300)
    ref = AlignmentSearchEngine(W, is_max, backend="native").search_codes(c1, c2)
    got = _engine(is_max, share).search_codes(c1, c2)
    assert (got.offset, got.char_offset, got.sub_code, got.score) == (
        ref.offset, ref.char_offset, ref.sub_code, ref.score)


def test_hybrid_tie_prefers_device_block():
    """All windows identical -> every offset ties; the canonical rule
    (lower offset wins) must survive the host/device merge: the device
    block owns offsets [0, split)."""
    c1 = np.zeros(900, np.int32)        # 'AAA...'
    c2 = np.zeros(200, np.int32)
    for is_max in (False, True):
        res = _engine(is_max, 50).search_codes(c1, c2)
        ref = AlignmentSearchEngine(W, is_max,
                                    backend="native").search_codes(c1, c2)
        assert res.offset == 0
        assert (res.offset, res.char_offset, res.sub_code, res.score) == (
            ref.offset, ref.char_offset, ref.sub_code, ref.score)


def test_hybrid_winner_in_host_block():
    """Plant a strictly-better window deep in the host block's offset range
    and check the merge surfaces the host-side winner."""
    rng = np.random.default_rng(7)
    c2 = random_codes(rng, 120, hyphen_p=0.0)
    c1 = random_codes(rng, 1200, hyphen_p=0.0)
    c1[1000:1120] = c2                  # perfect match at offset 1000
    ref = AlignmentSearchEngine(W, True, backend="native").search_codes(c1, c2)
    got = _engine(True, 25).search_codes(c1, c2)   # split = 270 < 1000
    assert ref.offset == 1000
    assert (got.offset, got.char_offset, got.sub_code, got.score) == (
        ref.offset, ref.char_offset, ref.sub_code, ref.score)


def test_hybrid_no_mutation_raises():
    """Out-of-range chars everywhere: neither block finds a legal
    substitution -> NoMutationFound from the merged search."""
    from psa.core.result import NoMutationFound

    eng = AlignmentSearchEngine(W, True, backend="hybrid", device_share=50,
                                strict_alphabet=False)
    c1 = np.full(700, 27, np.int32)
    c2 = np.full(150, 27, np.int32)
    with pytest.raises(NoMutationFound):
        eng.search_codes(c1, c2)


def test_hybrid_auto_share_uses_crossover():
    """device_share=None follows the reference's auto heuristic shape
    (cpu_funcs.c:137-142): all-host below the workload crossover."""
    rng = np.random.default_rng(11)
    c1 = random_codes(rng, 800)
    c2 = random_codes(rng, 200)
    ref = AlignmentSearchEngine(W, False, backend="native").search_codes(c1, c2)
    got = _engine(False, None).search_codes(c1, c2)
    assert (got.offset, got.char_offset, got.sub_code, got.score) == (
        ref.offset, ref.char_offset, ref.sub_code, ref.score)


def test_cli_device_share(tmp_path, golden_expected):
    """--device-share 50 through the CLI byte-matches the golden output."""
    from psa.utils.cli import main

    out = tmp_path / "out.txt"
    rc = main([str(GOLDEN_INPUT), "-o", str(out), "--device-share", "50",
               "--quiet"])
    assert rc == 0
    assert out.read_text() == golden_expected


def test_cli_device_share_minus100_is_sequential(tmp_path, golden_expected):
    from psa.utils.cli import main

    out = tmp_path / "out.txt"
    rc = main([str(GOLDEN_INPUT), "-o", str(out), "--device-share", "-100",
               "--quiet"])
    assert rc == 0
    assert out.read_text() == golden_expected


def test_cli_device_share_validation(capsys):
    from psa.utils.cli import main

    assert main(["x.txt", "--device-share", "150"]) == 2
    assert main(["x.txt", "--device-share", "50", "--backend", "native"]) == 2
    assert main(["x.txt", "--device-share", "50", "--batch"]) == 2
