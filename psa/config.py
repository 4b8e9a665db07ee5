"""Engine configuration.

The reference hard-codes its knobs as #defines (def.h:4-48: thread count,
file paths, size caps) plus one runtime flag.  Here everything is a dataclass
with environment overrides, and the reference's hard size caps are gone —
shapes are bucketed, not bounded (SURVEY.md §7.2).
"""

from __future__ import annotations

import dataclasses
import os


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


@dataclasses.dataclass
class EngineConfig:
    # padding buckets
    bucket_floor: int = _env_int("PSA_BUCKET_FLOOR", 512)

    # host selection
    max_candidates: int = _env_int("PSA_MAX_CANDIDATES", 4096)

    # `auto` backend crossover (pair-evals): below this the native host
    # engine runs the query without touching XLA — the reference's
    # workload-aware CPU/GPU split (cpu_funcs.c:135-142); above it the
    # device start-up and compile amortize.
    auto_threshold: int = _env_int("PSA_AUTO_THRESHOLD", 200_000_000)

    # batched serving: queries stream through the device in fixed-size
    # microbatches (padded up to the next power of two, capped here) so one
    # compiled batch program serves ANY workload size — the fused runner
    # is specialized on B, so unbounded batch sizes would mean one compile
    # per distinct B.  Microbatching also enables the 2-deep
    # dispatch pipeline (host selection of batch i overlaps device compute
    # of batch i+1).
    micro_batch: int = _env_int("PSA_MICRO_BATCH", 1024)

    # serve-loop pipeline depth: dispatched-but-uncollected batches.  2
    # overlaps the result fetch with device compute + host work; deeper
    # keeps the device fed when fetches are slow.
    serve_inflight: int = _env_int("PSA_SERVE_INFLIGHT", 2)

    # defaults mirroring the reference CLI contract (def.h:20-21)
    default_input: str = "./input.txt"
    default_output: str = "./output.txt"

    # backend resolution
    default_backend: str = os.environ.get("PSA_BACKEND", "auto")


CONFIG = EngineConfig()
