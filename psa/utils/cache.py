"""JAX persistent compilation cache placement.

The CLI and the benchmarks call `enable_compilation_cache()` before first
device use, so that separate processes reuse compiled executables.  Where
JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing here
overrides it.  Otherwise the cache sits at a fixed path inside the checkout,
`<checkout>/.jax_cache` (gitignored): the path is part of the cache's key, so
a directory that moves would never hit.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Executables that compiled faster than this are not written: recompiling
# them costs less than the cache traffic.  The device runners compile in
# seconds on an H100 (`chip_smoke.py` prints each phase's compile time).
MIN_COMPILE_SECS = 1.0


def cache_dir() -> str:
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compilation_cache() -> None:
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        path = cache_dir()
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      MIN_COMPILE_SECS)
