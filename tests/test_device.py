"""The device layer off the card: the sweep kernel in interpret mode against
the numpy oracle, the one platform decision, the compile-cache placement,
the launcher's per-rank cards, and the f32 ranking bound."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from psa.core.alphabet import OTHER_CODE, pad_codes
from psa.core.oracle import offset_stats_numpy
from psa.core.tables import build_tables
from psa.ops.common import CHUNK, TILE_O, plan_shapes
from psa.ops.pallas_sweep import code_table_t, sweep_stats5

from conftest import random_codes

# (n1, n2, batch, shared Seq1, OTHER chars)
KERNEL_CASES = {
    "one_tile": (TILE_O + CHUNK - 1, CHUNK, 1, False, False),
    "several_tiles": (5 * TILE_O + 40, 40, 1, False, False),
    "several_chunks": (TILE_O + 7 * CHUNK, 7 * CHUNK + 1, 1, False, False),
    "padding_tails": (3 * TILE_O + 37, 3 * CHUNK + 5, 1, False, False),
    "shared_seq1": (2 * TILE_O + 90, 90, 3, True, False),
    "other_chars": (2 * TILE_O + 60, 60, 1, False, True),
    "batch": (2 * TILE_O + 70, 70, 3, False, False),
}


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_sweep_kernel_matches_oracle(case):
    n1, n2, b, shared, other = KERNEL_CASES[case]
    rng = np.random.default_rng(len(case))
    tables = build_tables(np.array([1.5, 2.0, 0.5, 3.0]), case == "batch")
    noff, noff_pad, l2p, l1k = plan_shapes(n1, n2)
    c1s = [random_codes(rng, n1) for _ in range(1 if shared else b)]
    c2s = [random_codes(rng, n2) for _ in range(b)]
    if other:
        c1s[0][::7] = OTHER_CODE
        c2s[0][::5] = OTHER_CODE
    out = np.asarray(sweep_stats5(
        jnp.asarray(np.stack([pad_codes(c, l1k) for c in c1s])),
        jnp.asarray(np.stack([pad_codes(c, l2p) for c in c2s])),
        code_table_t(tables.code), interpret=True))
    assert out.shape == (b, 5, noff_pad)
    for q in range(b):
        counts, maxrank = offset_stats_numpy(c1s[0 if shared else q], c2s[q],
                                             tables)
        np.testing.assert_array_equal(out[q, :4, :noff].T, counts)
        np.testing.assert_array_equal(out[q, 4, :noff], maxrank)


def test_sweep_kernel_counter_flush(monkeypatch):
    """Seq2 longer than SEGMENT steps flushes the 16-bit counter fields
    into int32 totals between segments (forced here with a tiny SEGMENT on
    a shape no other test traces)."""
    from psa.ops import pallas_sweep as ps

    monkeypatch.setattr(ps, "SEGMENT", 2)
    rng = np.random.default_rng(99)
    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), True)
    n1, n2 = TILE_O + 5 * CHUNK + 3, 5 * CHUNK - 3
    noff, _, l2p, l1k = plan_shapes(n1, n2)
    c1, c2 = random_codes(rng, n1), random_codes(rng, n2)
    out = np.asarray(ps.sweep_stats5(
        jnp.asarray(pad_codes(c1, l1k))[None],
        jnp.asarray(pad_codes(c2, l2p))[None],
        code_table_t(tables.code), interpret=True))[0]
    counts, maxrank = offset_stats_numpy(c1, c2, tables)
    np.testing.assert_array_equal(out[:4, :noff].T, counts)
    np.testing.assert_array_equal(out[4, :noff], maxrank)


def test_sweep_kernel_rejects_unpadded_shapes():
    code_t = code_table_t(build_tables(np.ones(4), False).code)
    with pytest.raises(ValueError, match="padded"):
        sweep_stats5(jnp.zeros((1, TILE_O + CHUNK + 1), jnp.int32),
                     jnp.zeros((1, CHUNK), jnp.int32), code_t, interpret=True)
    with pytest.raises(ValueError, match="Seq1 rows"):
        sweep_stats5(jnp.zeros((2, TILE_O + CHUNK), jnp.int32),
                     jnp.zeros((3, CHUNK), jnp.int32), code_t, interpret=True)


def test_code_table_is_seq2_char_major():
    code = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False).code
    flat = np.asarray(code_table_t(code))
    a, b = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    np.testing.assert_array_equal(flat[b * 32 + a], code.astype(np.int32))


def test_sweep_kernel_returns_gpu_kernel_on_gpu(monkeypatch):
    from psa.ops import device

    monkeypatch.delenv("PSA_INTERPRET", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert device.accelerator_present()
    assert device.sweep_kernel() is sweep_stats5


def test_device_backend_without_gpu_raises(monkeypatch):
    from psa.models.search import AlignmentSearchEngine
    from psa.ops import device

    monkeypatch.delenv("PSA_INTERPRET", raising=False)
    assert not device.accelerator_present()
    with pytest.raises(device.DeviceUnavailableError, match="GPU"):
        device.sweep_kernel()
    eng = AlignmentSearchEngine([1.0, 3.0, 4.0, 2.0], False, backend="pallas")
    with pytest.raises(device.DeviceUnavailableError):
        eng.search("ABCDEFGHIJKLMNOP", "ABC")


def test_interpret_only_on_request(monkeypatch):
    from psa.ops import device

    monkeypatch.delenv("PSA_INTERPRET", raising=False)
    assert device.resolve_interpret(True) is True
    monkeypatch.setenv("PSA_INTERPRET", "1")
    assert device.resolve_interpret() is True
    assert device.sweep_kernel().keywords == {"interpret": True}


def test_cli_pallas_without_gpu_is_a_clear_error(monkeypatch, tmp_path,
                                                 capsys):
    from psa.utils.cli import main

    from conftest import GOLDEN_INPUT

    monkeypatch.delenv("PSA_INTERPRET", raising=False)
    rc = main([GOLDEN_INPUT, "-o", str(tmp_path / "o.txt"),
               "--backend", "pallas", "--quiet"])
    assert rc == 2
    assert "needs an NVIDIA GPU" in capsys.readouterr().err
    assert not (tmp_path / "o.txt").exists()


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(monkeypatch, tmp_path, env_set):
    from psa.utils import cache

    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.cache_dir() == str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert cache.cache_dir() == os.path.join(cache.CHECKOUT,
                                                 ".jax_cache")
    cache.enable_compilation_cache()
    # the environment variable is JAX's own setting: nothing overrides it
    assert ("jax_compilation_cache_dir" in updates) is not env_set
    if not env_set:
        assert updates["jax_compilation_cache_dir"] == cache.cache_dir()
    assert updates["jax_persistent_cache_min_compile_time_secs"] == \
        cache.MIN_COMPILE_SECS


def test_compile_cache_path_is_gitignored():
    from psa.utils import cache

    with open(os.path.join(cache.CHECKOUT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("ngpu,platform,want", [
    (4, None, [["--local-device-id", "0"], ["--local-device-id", "1"]]),
    (0, None, [[], []]),
    (4, "cpu", [["--platform", "cpu"], ["--platform", "cpu"]]),
])
def test_launcher_rank_devices(ngpu, platform, want):
    from psa.utils.launcher import rank_commands

    cmds = rank_commands(2, ["in.txt"], 1234, platform, ngpu)
    assert len(cmds) == 2
    for i, (cmd, extra) in enumerate(zip(cmds, want)):
        assert cmd[cmd.index("--process-id") + 1] == str(i)
        assert cmd[cmd.index("--coordinator") + 1] == "localhost:1234"
        has_dev = "--local-device-id" in cmd
        assert has_dev == ("--local-device-id" in extra)
        if has_dev:
            assert cmd[cmd.index("--local-device-id") + 1] == str(i)
        if platform:
            assert cmd[cmd.index("--platform") + 1] == platform


def test_launcher_more_ranks_than_cards_is_an_error():
    from psa.utils.launcher import rank_commands

    with pytest.raises(ValueError, match="one process per card"):
        rank_commands(3, [], 1234, None, 2)


@pytest.mark.parametrize("is_max", [False, True])
def test_f32_total_within_band_epsilon(is_max):
    """The in-graph f32 ranking total stays within f32_band_epsilon of the
    exact f64 total, and is computed elementwise (no matrix product, which
    a GPU may run in TF32)."""
    from psa.models.batch import f32_band_epsilon
    from psa.ops.common import keyed_f32_totals

    tables = build_tables(np.array([np.pi, np.e / 3, 7.3, 0.1]), is_max)
    rng = np.random.default_rng(5)
    l2p, n = 8192, 4096
    counts = rng.multinomial(l2p, [0.25] * 4, size=n).astype(np.int32)
    maxrank = rng.integers(0, tables.num_ranks, n).astype(np.int32)
    for axis, cin in ((-1, counts), (-2, counts.T)):
        fn = lambda c, m: keyed_f32_totals(c, m, tables, n, axis)[1]
        assert "dot_general" not in str(jax.make_jaxpr(fn)(cin, maxrank))
        total = np.asarray(fn(cin, maxrank), np.float64)
        exact = (tables.score_from_counts(counts)
                 + tables.diff_vals[maxrank])
        assert np.max(np.abs(total - exact)) <= f32_band_epsilon(tables, l2p)
