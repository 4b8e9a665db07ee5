"""Local multi-process launcher: `psa-dist -np N input.txt [psa flags...]`.

The reference launches its distributed run as `mpiexec -np 2 -machinefile mf
-map-by node ./bin` (Makefile:18-22, README.md:232-244).  The analog here
spawns N copies of the `psa` CLI joined through a local jax.distributed
coordinator, like `mpiexec -np N` on one node.  On a GPU host rank i opens
card i only (one process per card); N larger than the card count is an
error.  With `--platform cpu` the ranks share the host's CPU backend.

Process 0's stdout/stderr stream through; the other ranks' output is
captured and replayed only on failure.
"""

from __future__ import annotations

import argparse
import socket
import subprocess
import sys


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="psa-dist",
        description="launch an N-process distributed psa search on this "
                    "machine (mpiexec -np N analog)",
    )
    p.add_argument("-np", "--num-processes", type=int, default=2,
                   help="process count (default 2, like the reference's "
                        "Makefile run target)")
    p.add_argument("--port", type=int, default=None,
                   help="coordinator port (default: pick a free one)")
    p.add_argument("--platform", default=None,
                   help="forwarded to every rank (e.g. cpu)")
    return p


def local_gpu_count() -> int:
    """Cards on this host, read without initializing JAX (the launcher
    itself never opens a card); 0 when there is no NVIDIA driver."""
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return 0
    if out.returncode:
        return 0
    return sum(1 for line in out.stdout.splitlines()
               if line.startswith("GPU "))


def rank_commands(n: int, rest: list, port: int, platform: str | None,
                  ngpu: int) -> list:
    """The N rank command lines.  With cards (ngpu > 0, no --platform)
    rank i gets --local-device-id i, so each process opens one card."""
    use_cards = ngpu > 0 and platform is None
    if use_cards and n > ngpu:
        raise ValueError(f"-np {n} exceeds the {ngpu} GPUs on this host "
                         "(one process per card)")
    common = [sys.executable, "-m", "psa.utils.cli", *rest,
              "--distributed", "--coordinator", f"localhost:{port}",
              "--num-processes", str(n)]
    if platform:
        common += ["--platform", platform]
    return [common + ["--process-id", str(i)]
            + (["--local-device-id", str(i)] if use_cards else [])
            for i in range(n)]


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    args, rest = build_parser().parse_known_args(argv)
    ngpu = 0 if args.platform else local_gpu_count()
    try:
        cmds = rank_commands(args.num_processes, rest,
                             args.port or _free_port(), args.platform, ngpu)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    import tempfile

    procs = []
    logs = []
    for i, cmd in enumerate(cmds):
        if i == 0:
            procs.append(subprocess.Popen(cmd))
            logs.append(None)
        else:
            # spool non-primary output to a temp file — a PIPE would fill
            # and deadlock the rank if it logs more than the pipe buffer
            f = tempfile.TemporaryFile(mode="w+")
            procs.append(subprocess.Popen(cmd, stdout=f, stderr=f))
            logs.append(f)
    rc = procs[0].wait()
    for i, p in enumerate(procs[1:], start=1):
        p.wait()
        f = logs[i]
        if p.returncode not in (0, rc):
            f.seek(0)
            print(f"[psa-dist] rank {i} exited {p.returncode}:\n{f.read()}",
                  file=sys.stderr)
            rc = rc or p.returncode
        f.close()
    return rc


if __name__ == "__main__":
    sys.exit(main())
