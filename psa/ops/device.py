"""The one platform decision: which device kernel this process runs.

Every caller that routes work to the accelerator asks here; no other module
names a platform.  The sweep kernel (ops/pallas_sweep.py) is compiled through
Triton for an NVIDIA GPU.  Pallas interpret mode runs only on request — an
explicit `interpret=True`, or PSA_INTERPRET=1, which the CPU test suite sets
— and a device backend asked for on a machine without a GPU raises
`DeviceUnavailableError` instead of falling back.
"""

from __future__ import annotations

import functools
import os

_ACCELERATOR = "gpu"


class DeviceUnavailableError(RuntimeError):
    """A device backend was requested but JAX found no GPU."""


def accelerator_present() -> bool:
    """True when JAX's default backend is a GPU (initializes the backend)."""
    import jax

    return jax.default_backend() == _ACCELERATOR


def resolve_interpret(interpret: bool | None = None) -> bool:
    """Whether the device kernel runs in Pallas interpret mode.

    None reads PSA_INTERPRET.  Interpret mode off means the compiled GPU
    kernel, so this raises when there is no GPU."""
    if interpret is None:
        interpret = os.environ.get("PSA_INTERPRET", "") == "1"
    if not interpret and not accelerator_present():
        import jax

        raise DeviceUnavailableError(
            f"the device backend needs an NVIDIA GPU; JAX found "
            f"{jax.default_backend()!r} (use --backend native on a host "
            f"without one)")
    return bool(interpret)


def sweep_kernel(interpret: bool | None = None):
    """The sweep for this process: `sweep_stats5(s1, s2, code_t)` compiled
    for the GPU, or in interpret mode on request (see `resolve_interpret`)."""
    from psa.ops.pallas_sweep import sweep_stats5

    if resolve_interpret(interpret):
        return functools.partial(sweep_stats5, interpret=True)
    return sweep_stats5
