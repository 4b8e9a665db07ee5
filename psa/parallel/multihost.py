"""Multi-process bootstrap.

Replacement for the reference's MPI process layer (main.c:20-22,
mpi_funcs.c, cpu_funcs.c:51): `jax.distributed` forms the process group,
process 0 owns file I/O, the query broadcasts to every process, and the
search itself is the
same mesh-sharded program as single-host (parallel/mesh.py) — the global mesh
simply spans all hosts' devices, so the cross-host merge is the same in-graph
collective instead of MPI_Allreduce + Send/Recv (cpu_funcs.c:64-94).

Exercised for real by tests/test_distributed.py: two processes joined
through a local coordinator (CPU backend, Gloo collectives) run the full
read -> broadcast -> sharded search -> allgather -> write flow, with the
non-primary rank receiving no input file at all.  Launch locally with
`psa-dist -np N` or per-host with `psa --distributed`.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_id: int | None = None) -> None:
    """Join the process group (the reference's MPI_Init, main.c:20-22).

    The coordinator, process count and rank are explicit (the `mpiexec -np
    N` analog — the psa-dist launcher passes them); a single process with
    none of them is a no-op.  local_device_id restricts this process to one
    local GPU, so that N ranks on one host open one card each."""
    import jax

    if num_processes in (None, 1) and coordinator_address is None:
        return  # single-process: nothing to do
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=(None if local_device_id is None
                          else [local_device_id]),
    )


def is_primary() -> bool:
    import jax

    return jax.process_index() == 0


def broadcast_query(query=None):
    """Broadcast (weights, codes1, codes2, is_max) from process 0 to all.

    The reference broadcasts its ~15KB ProgramData struct (cpu_funcs.c:51);
    here the payload is the padded code arrays + weights via
    multihost_utils.broadcast_one_to_all.
    """
    import jax
    from jax.experimental import multihost_utils

    if jax.process_count() == 1:
        return query

    from psa.core.alphabet import encode

    if is_primary():
        assert query is not None
        c1 = encode(query.seq1).astype(np.int32)
        c2 = encode(query.seq2).astype(np.int32)
        header = np.array(
            [c1.shape[0], c2.shape[0], int(query.is_max)], np.int32
        )
        w = np.asarray(query.weights, np.float64)
    else:
        header = np.zeros(3, np.int32)
        w = np.zeros(4, np.float64)
        c1 = c2 = None

    header = multihost_utils.broadcast_one_to_all(header)
    w = multihost_utils.broadcast_one_to_all(w)
    n1, n2, is_max = (int(x) for x in header)
    if c1 is None:
        c1 = np.zeros(n1, np.int32)
        c2 = np.zeros(n2, np.int32)
    c1 = multihost_utils.broadcast_one_to_all(c1)
    c2 = multihost_utils.broadcast_one_to_all(c2)
    return w, c1, c2, bool(is_max)


def _partition(n: int, nproc: int, pid: int) -> tuple[int, int]:
    """Contiguous equal blocks, remainder to the last rank — the same split
    rule as the reference's offset partition (cpu_funcs.c:128-133), applied
    to the case axis."""
    per = n // nproc
    lo = per * pid
    hi = n if pid == nproc - 1 else lo + per
    return lo, hi


def broadcast_cases(cases=None):
    """Broadcast a whole case list from process 0 (the batch analog of
    `broadcast_query`): one header array + weights + two concatenated RAW
    BYTE arrays — 4 broadcasts regardless of case count.

    Sequences ship as raw bytes (not alphabet codes): under --lenient the
    inputs may contain arbitrary characters, and a code round-trip would
    collapse them all to '?'.  The primary returns its ORIGINAL list, so
    its output files are byte-identical to single-process mode by
    construction."""
    import jax
    from jax.experimental import multihost_utils

    from psa.utils.io import Query

    if jax.process_count() == 1:
        return cases

    if is_primary():
        assert cases is not None
        heads = np.array([[len(q.seq1), len(q.seq2), int(q.is_max)]
                          for q in cases], np.int32).reshape(-1, 3)
        w = np.array([np.asarray(q.weights, np.float64) for q in cases],
                     np.float64).reshape(-1, 4)
        b1cat = np.frombuffer(
            "".join(q.seq1 for q in cases).encode("latin-1"), np.uint8)
        b2cat = np.frombuffer(
            "".join(q.seq2 for q in cases).encode("latin-1"), np.uint8)
        meta = np.array([len(cases), b1cat.shape[0], b2cat.shape[0]],
                        np.int32)
    else:
        meta = np.zeros(3, np.int32)
    meta = multihost_utils.broadcast_one_to_all(meta)
    n, t1, t2 = (int(x) for x in meta)
    if not is_primary():
        heads = np.zeros((n, 3), np.int32)
        w = np.zeros((n, 4), np.float64)
        b1cat = np.zeros(t1, np.uint8)
        b2cat = np.zeros(t2, np.uint8)
    heads = multihost_utils.broadcast_one_to_all(heads)
    w = multihost_utils.broadcast_one_to_all(w)
    b1cat = multihost_utils.broadcast_one_to_all(b1cat)
    b2cat = multihost_utils.broadcast_one_to_all(b2cat)
    if is_primary():
        return cases

    out, o1, o2 = [], 0, 0
    for i in range(n):
        n1, n2, is_max = (int(x) for x in heads[i])
        out.append(Query(
            weights=w[i],
            seq1=b1cat[o1: o1 + n1].tobytes().decode("latin-1"),
            seq2=b2cat[o2: o2 + n2].tobytes().decode("latin-1"),
            is_max=bool(is_max)))
        o1 += n1
        o2 += n2
    return out


def _read_on_primary(read_fn, input_path: str, lenient: bool, valid_fn):
    """Primary-only read+validate with a status broadcast BEFORE any payload
    broadcast, so a bad input file fails every rank promptly instead of
    stranding the others inside broadcast_one_to_all.  Returns the payload
    on the primary, None elsewhere; raises the primary's error everywhere."""
    import jax

    payload, status = None, 0
    if is_primary():
        try:
            payload = read_fn(input_path)
            if not lenient and not valid_fn(payload):
                status = 3
        except FileNotFoundError:
            status = 1
        except ValueError:
            status = 2
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        status = int(multihost_utils.broadcast_one_to_all(
            np.array([status], np.int32))[0])
    if status == 1:
        raise FileNotFoundError(input_path)
    if status == 2:
        raise ValueError(f"bad input file `{input_path}`")
    if status == 3:
        from psa.core.alphabet import ALPHABET_ERROR

        raise ValueError(ALPHABET_ERROR)
    return payload


def run_distributed_batch(input_path: str, outdir: str,
                          backend: str = "auto",
                          lenient: bool = False,
                          quiet: bool = False,
                          json_out: bool = False,
                          shard_local: bool = False) -> int:
    """Multi-process batch flow: proc-0 read -> case broadcast -> contiguous
    case blocks per process (each searched with the local batched engine) ->
    allgather of packed winner rows -> proc-0 writes out_%04d.txt files.

    The batch-scale analog of `run_distributed_search`; outputs byte-match
    single-process `--batch` mode.  Returns 0, or 1 when any case has no
    mutation (same contract as the CLI batch mode)."""
    import os

    import jax

    from psa.core.alphabet import validate
    from psa.models.batch import search_batch
    from psa.utils.io import format_output, read_cases

    cases = _read_on_primary(
        read_cases, input_path, lenient,
        lambda cs: all(validate(q.seq1) and validate(q.seq2) for q in cs))
    cases = broadcast_cases(cases)
    nproc = jax.process_count()
    pid = jax.process_index()
    lo, hi = _partition(len(cases), nproc, pid)
    # two composable parallel axes: the CASE axis splits across processes
    # (above); with shard_local each process additionally shards its
    # block's QUERY axis over its own local chips
    mesh = None
    if shard_local:
        from psa.parallel.mesh import make_mesh

        mesh = make_mesh(jax.local_devices(), axis="dp")
    block = search_batch(cases[lo:hi], backend=backend,
                         strict_alphabet=False, mesh=mesh)

    # packed winner rows: [found, offset, char_offset, sub_code, score]
    rows = np.zeros((len(cases), 5), np.float64)
    for j, res in enumerate(block):
        if res is not None:
            rows[lo + j] = [1.0, res.offset, res.char_offset, res.sub_code,
                            res.score]
    if nproc > 1:
        from jax.experimental import multihost_utils

        gathered = np.asarray(multihost_utils.process_allgather(rows))
        for r in range(nproc):
            rlo, rhi = _partition(len(cases), nproc, r)
            rows[rlo:rhi] = gathered[r, rlo:rhi]

    if not is_primary():
        return 1 if (rows[:, 0] == 0).any() else 0

    os.makedirs(outdir, exist_ok=True)
    n_missing = 0
    for i, q in enumerate(cases):
        path = os.path.join(outdir, f"out_{i:04d}.txt")
        found, off, coff, sub, score = rows[i]
        res = None
        if found:
            from psa.core.result import SearchResult

            res = SearchResult(offset=int(off), char_offset=int(coff),
                               sub_code=int(sub), score=float(score))
        else:
            n_missing += 1
        with open(path, "w") as f:
            if res is None:
                bad = float("-inf") if q.is_max else float("inf")
                f.write(format_output(q.seq2, -1, bad))
            else:
                f.write(format_output(res.mutant(q.seq2), res.offset,
                                      res.score))
        if json_out:
            from psa.utils.cli import _result_json

            print(_result_json(q, res, case=i), flush=True)
    if not quiet:
        import sys

        print(f"{len(cases)} cases -> {outdir}/ "
              f"({n_missing} without mutation)", file=sys.stderr, flush=True)
    return 1 if n_missing else 0


def run_distributed_search(input_path: str, output_path: str,
                           backend_kernel: str = "auto",
                           lenient: bool = False) -> int:
    """Full multi-host flow: proc-0 read -> broadcast -> global-mesh sharded
    search -> proc-0 write. Returns 0/1 like the CLI; raises the primary's
    read/validation error on EVERY process (a status broadcast precedes the
    query broadcast, so a bad input file fails all ranks promptly instead
    of stranding the others inside broadcast_one_to_all)."""
    import jax

    from psa.core.alphabet import validate
    from psa.core.result import NoMutationFound
    from psa.core.tables import build_tables
    from psa.parallel.mesh import make_mesh, search_sharded
    from psa.utils.io import read_input, write_output

    query = _read_on_primary(
        read_input, input_path, lenient,
        lambda q: validate(q.seq1) and validate(q.seq2))
    if jax.process_count() > 1:
        w, c1, c2, is_max = broadcast_query(query)
    else:
        from psa.core.alphabet import encode

        w = np.asarray(query.weights, np.float64)
        c1, c2 = encode(query.seq1), encode(query.seq2)
        is_max = query.is_max

    tables = build_tables(w, is_max)
    mesh = make_mesh()  # global mesh across all hosts' devices
    # the primary writes from its ORIGINAL seq2 string, never from decoded
    # codes — under --lenient, out-of-alphabet characters all map to
    # OTHER_CODE and would decode as '?' (the search itself is unaffected:
    # out-of-range chars share one defined semantics)
    try:
        res = search_sharded(c1, c2, tables, mesh, kernel=backend_kernel)
    except NoMutationFound:
        if is_primary():
            write_output(output_path, query.seq2, -1,
                         float("-inf") if is_max else float("inf"))
        return 1
    if is_primary():
        write_output(output_path, res.mutant(query.seq2), res.offset,
                     res.score)
    return 0
