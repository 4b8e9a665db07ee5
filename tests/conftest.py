"""Test harness configuration.

The suite runs on a virtual 8-device CPU mesh (per the multi-chip test
strategy in SURVEY.md §4): sharding semantics are platform-independent, so
CPU results validate the mesh design.  The device sweep kernel runs in Pallas
interpret mode here (PSA_INTERPRET=1, inherited by CLI subprocesses).

Tests marked `gpu` need an NVIDIA GPU: the `gpu` fixture skips them here, and
`JAX_PLATFORMS= PSA_INTERPRET=0 python -m pytest -m gpu tests/` runs them on
a card (chip_smoke.py does).
"""

import os

if os.environ.get("PSA_INTERPRET") != "0":
    os.environ["PSA_INTERPRET"] = "1"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    # pin the CPU backend before any backend initializes (the
    # JAX_PLATFORMS environment variable alone is read only at import)
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

from psa.utils.io import read_input

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
# Seeded golden case (`psa-gen 9711 2131 --seed 2026 --cases 5
# --hyphen-rate 0.01`); the pinned output is the byte-identical answer of
# the numpy oracle and the native engine.
GOLDEN_INPUT = os.path.join(_DATA, "golden_input.txt")
GOLDEN_OUTPUT = os.path.join(_DATA, "golden_output.txt")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time,
    never at import, so every xdist worker collects the same tests)."""
    from psa.ops.device import accelerator_present

    if not accelerator_present():
        pytest.skip("needs an NVIDIA GPU (run with -m gpu on a card)")


@pytest.fixture(scope="session")
def golden_query():
    return read_input(GOLDEN_INPUT)


@pytest.fixture(scope="session")
def golden_expected():
    with open(GOLDEN_OUTPUT) as f:
        return f.read()


def random_codes(rng: np.random.Generator, n: int, hyphen_p: float = 0.05) -> np.ndarray:
    """Random sequence codes over A-Z with occasional hyphens."""
    codes = rng.integers(0, 26, size=n, dtype=np.int32)
    mask = rng.random(n) < hyphen_p
    codes[mask] = 26
    return codes


def random_seq(rng: np.random.Generator, n: int, hyphen_p: float = 0.05) -> str:
    from psa.core.alphabet import decode

    return decode(random_codes(rng, n, hyphen_p))
