"""Multihost module: single-process degenerate paths (the multi-process code
path is identical by JAX's multi-controller model; real pod runs exercise it
with the same program)."""

import numpy as np

from conftest import GOLDEN_INPUT
from psa.parallel import multihost
from psa.utils.generator import random_sequences, write_input_file


def test_initialize_single_process_noop():
    multihost.initialize()  # must not raise or try to form a cluster
    assert multihost.is_primary()


def test_broadcast_query_passthrough(golden_query):
    assert multihost.broadcast_query(golden_query) is golden_query


def test_run_distributed_search_single_process(tmp_path, golden_expected):
    out = tmp_path / "out.txt"
    rc = multihost.run_distributed_search(
        GOLDEN_INPUT, str(out), backend_kernel="xla")
    assert rc == 0
    assert out.read_text() == golden_expected


def test_run_distributed_search_max_mode(tmp_path):
    s1, s2 = random_sequences(1500, 300, seed=2)
    inp = tmp_path / "in.txt"
    write_input_file(str(inp), [2.0, 1.0, 0.5, 3.0], s1, s2, True)
    out = tmp_path / "out.txt"
    rc = multihost.run_distributed_search(str(inp), str(out), backend_kernel="xla")
    assert rc == 0
    from psa.models.search import AlignmentSearchEngine

    ref = AlignmentSearchEngine([2.0, 1.0, 0.5, 3.0], True, backend="numpy").search(s1, s2)
    mutant, tail = out.read_text().split("\n")
    off, score = tail.split()
    assert int(off) == ref.offset
    assert mutant == ref.mutant(s2)


def test_run_distributed_batch_single_process(tmp_path, capsys):
    """Single-process run_distributed_batch: outputs byte-match _main_batch,
    --json emits one object per case, quiet suppresses the summary."""
    import json

    from psa.utils.cli import main

    recs = []
    for seed in range(3):
        s1, s2 = random_sequences(400, 60, seed=seed)
        recs.append(f"1 3 4 2\n{s1}\n{s2}\nminimum")
    inp = tmp_path / "cases.txt"
    inp.write_text("\n".join(recs))

    refdir = tmp_path / "ref"
    assert main([str(inp), "-o", str(refdir), "--batch",
                 "--backend", "numpy", "--quiet"]) == 0
    capsys.readouterr()

    outdir = tmp_path / "outs"
    rc = multihost.run_distributed_batch(str(inp), str(outdir),
                                         backend="native", quiet=True,
                                         json_out=True)
    assert rc == 0
    cap = capsys.readouterr()
    objs = [json.loads(ln) for ln in cap.out.strip().splitlines()]
    assert [o["case"] for o in objs] == [0, 1, 2]
    assert all(o["mutation_found"] for o in objs)
    assert cap.err == ""                      # quiet: no summary line
    for i in range(3):
        name = f"out_{i:04d}.txt"
        assert (outdir / name).read_text() == (refdir / name).read_text()
