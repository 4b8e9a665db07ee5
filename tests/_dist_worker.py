"""Worker process for the 2-process distributed test.

Run as: python _dist_worker.py <pid> <nproc> <port> <input> <outdir> [ndev]

ndev (default 1) forces that many local virtual CPU devices per process —
ndev > 1 exercises the shape where the global mesh mixes local
and cross-process device axes.

Counts the actual cross-process primitive calls (broadcast_one_to_all from
broadcast_query, process_allgather from search_sharded's multi-process
branch) to prove the non-degenerate code paths executed, then runs the full
distributed search.  Rank != 0 receives a nonexistent input path — it can
only produce the right answer via the broadcast.
"""

import os
import sys

# Workers must import psa even when the package isn't pip-installed
# (fresh checkouts): fall back to the repo root two levels up.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
input_path, outdir = sys.argv[4], sys.argv[5]
ndev = int(sys.argv[6]) if len(sys.argv) > 6 else 1
if ndev > 1:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count={ndev}").strip()

import jax

jax.config.update("jax_platforms", "cpu")

from jax.experimental import multihost_utils as mh  # noqa: E402

calls = {"broadcast": 0, "allgather": 0}
_b, _ag = mh.broadcast_one_to_all, mh.process_allgather


def _counted_b(*a, **k):
    calls["broadcast"] += 1
    return _b(*a, **k)


def _counted_ag(*a, **k):
    calls["allgather"] += 1
    return _ag(*a, **k)


mh.broadcast_one_to_all = _counted_b
mh.process_allgather = _counted_ag

from psa.parallel import multihost  # noqa: E402

multihost.initialize(f"localhost:{port}", nproc, pid)
assert jax.process_count() == nproc, jax.process_count()
assert jax.local_device_count() == ndev, jax.local_device_count()
assert jax.device_count() == nproc * ndev, jax.device_count()

rank_input = input_path if pid == 0 else "/nonexistent/never-read.txt"
code = multihost.run_distributed_search(rank_input, f"{outdir}/out.txt",
                                        backend_kernel="xla")
assert code == 0, code
assert calls["broadcast"] >= 1, f"broadcast_one_to_all never ran: {calls}"
assert calls["allgather"] >= 1, f"process_allgather never ran: {calls}"
print(f"RANK{pid}_OK broadcast={calls['broadcast']} "
      f"allgather={calls['allgather']}", flush=True)
