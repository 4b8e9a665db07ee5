#!/usr/bin/env python3
"""On-card smoke test: the search engine's main paths on an NVIDIA GPU.

    python chip_smoke.py              # one card
    python chip_smoke.py --cards 4    # the four-card paths only

One card: (1) the committed golden case through `psa --backend pallas`,
byte-compared with its pinned output; (2) the sweep kernel at 131072x8192
bit-compared with the native engine's statistics, and the kernel timed
against the plain-XLA sweeps there and on a 1024-query batch of 2048x512
(distinct and shared Seq1); (3) `psa` on the 100k x 10k north star and on a
1M x 2048 query, byte-compared with `--backend native`; (4) `psa --batch` on
1024 distinct queries and `psa --serve --warmup` on 1024 lines sharing one
Seq1, every reply byte-compared with the native engine and none answered by
the host engine; (5) `pytest -m gpu`.

Four cards: `psa --sharded` on the north star over a (4,1) and a (2,2)
offset x char mesh, `psa --batch --sharded` on 4096 queries, `psa-dist -np 4`
(one process per card), each byte-compared with the native engine; and the
psum_scatter rate behind parallel/mesh._PAIRS_PER_LINK_BYTE.

Every phase that uses a card runs as its own child process, one at a time,
so one process holds the card.  Inputs are generated from seeds under
`<checkout>/.smoke/`.  Any failure exits non-zero; the last line of standard
output is {"ok": true, "device": {...}} only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")
T_START = time.perf_counter()

import psa  # noqa: E402,F401 - the repo must sit beside this script


class PhaseFailed(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except FileNotFoundError:
        raise PhaseFailed("nvidia-smi not found: no NVIDIA driver") from None
    if out.returncode:
        raise PhaseFailed(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def child_env(**extra) -> dict:
    env = dict(os.environ)
    env.pop("PSA_INTERPRET", None)      # the compiled kernel, never interpret
    env.update(extra)
    return env


def run(name: str, cmd: list, *, env=None, stdin=None,
        timeout=900) -> subprocess.CompletedProcess:
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, env=env or child_env(), stdin=stdin,
                       capture_output=True, text=True, timeout=timeout)
    dt = time.perf_counter() - t0
    if p.returncode:
        log(f"[{name}] FAILED rc={p.returncode} after {dt:.1f}s: "
            f"{' '.join(cmd)}")
        log(p.stdout[-4000:])
        log(p.stderr[-8000:])
        raise PhaseFailed(name)
    log(f"[{name}] {dt:.1f}s wall (process start and compiles included)")
    return p


def psa_cli(*args) -> list:
    return [sys.executable, "-m", "psa.utils.cli", *args]


def gen(path: str, n1: int, n2: int, seed: int, cases: int = 1) -> str:
    if not os.path.exists(path):
        run(f"gen {os.path.basename(path)}",
            [sys.executable, "-m", "psa.utils.generator", str(n1), str(n2),
             "--seed", str(seed), "--cases", str(cases), "-o", path])
    return path


def same_bytes(name: str, a: str, b: str) -> None:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        if fa.read() != fb.read():
            raise PhaseFailed(f"{name}: {a} differs from {b}")
    log(f"[{name}] byte-identical")


def same_dirs(name: str, a: str, b: str) -> None:
    files = sorted(os.listdir(b))
    if sorted(os.listdir(a)) != files or not files:
        raise PhaseFailed(f"{name}: {a} and {b} hold different files")
    for f in files:
        with open(os.path.join(a, f), "rb") as fa, \
                open(os.path.join(b, f), "rb") as fb:
            if fa.read() != fb.read():
                raise PhaseFailed(f"{name}: {f} differs")
    log(f"[{name}] {len(files)} outputs byte-identical")


def single_vs_native(name: str, inp: str, *device_args, env=None) -> None:
    dev = os.path.join(WORK, f"{name}_device.txt")
    ref = os.path.join(WORK, f"{name}_native.txt")
    if not os.path.exists(ref):
        run(f"{name} native", psa_cli(inp, "-o", ref, "--backend", "native",
                                      "--quiet"))
    run(f"{name} device", psa_cli(inp, "-o", dev, "--backend", "pallas",
                                  *device_args), env=env)
    same_bytes(name, dev, ref)


def batch_vs_native(name: str, inp: str, *device_args) -> None:
    dev = os.path.join(WORK, f"{name}_device")
    ref = os.path.join(WORK, f"{name}_native")
    run(f"{name} native", psa_cli(inp, "--batch", "-o", ref, "--backend",
                                  "native", "--quiet"))
    run(f"{name} device", psa_cli(inp, "--batch", "-o", dev, "--backend",
                                  "pallas", *device_args))
    same_dirs(name, dev, ref)


def device_phase(name: str) -> dict:
    """Run one `--phase` of this script in a child; return its DEVICE."""
    p = run(name, [sys.executable, os.path.abspath(__file__), "--phase",
                   name])
    log(p.stdout.rstrip())
    dev = [ln for ln in p.stdout.splitlines() if ln.startswith("DEVICE ")]
    if not dev:
        raise PhaseFailed(f"{name}: no DEVICE line")
    return json.loads(dev[-1][len("DEVICE "):])


# ---------------------------------------------------------------- children

def _require_gpus(n: int):
    import jax

    from psa.ops.device import accelerator_present
    from psa.utils.cache import cache_dir, enable_compilation_cache

    if not accelerator_present():
        print(f"error: JAX found no GPU (default backend "
              f"{jax.default_backend()!r})", file=sys.stderr)
        sys.exit(3)
    if len(jax.devices()) < n:
        print(f"error: {n} GPUs needed, JAX found {len(jax.devices())}",
              file=sys.stderr)
        sys.exit(3)
    enable_compilation_cache()
    print(f"jax {jax.__version__}; devices {jax.devices()}; "
          f"compile cache {cache_dir()}")
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _timeit(fn, reps: int = 20) -> float:
    """Median warm wall time in ms (each call ends in block_until_ready)."""
    import jax
    import numpy as np

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def phase_kernel() -> None:
    """The sweep kernel vs the native engine, bit for bit, and timed
    against the plain-XLA sweeps."""
    device = _require_gpus(1)
    import jax
    import jax.numpy as jnp
    import numpy as np

    from psa.core.alphabet import pad_codes
    from psa.core.tables import build_tables
    from psa.native import offset_stats_native
    from psa.ops import engine_conv, engine_xla
    from psa.ops.common import plan_shapes
    from psa.ops.pallas_sweep import code_table_t, sweep_stats5

    card = card_info()
    rng = np.random.default_rng(2026)
    tables = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    code_t = code_table_t(tables.code)
    code_flat = jnp.asarray(tables.code.reshape(-1).astype(np.int32))
    rows = []

    # single sweep 131072 x 8192
    noff, n2 = 131072, 8192
    c1 = rng.integers(0, 27, noff + n2 - 1).astype(np.int32)
    c2 = rng.integers(0, 27, n2).astype(np.int32)
    _, noff_pad, l2p, l1k = plan_shapes(len(c1), n2)
    s1 = jnp.asarray(pad_codes(c1, l1k))[None]
    s2 = jnp.asarray(pad_codes(c2, l2p))[None]
    t0 = time.perf_counter()
    sweep_stats5.lower(s1, s2, code_t).compile()
    print(f"kernel compile {time.perf_counter() - t0:.2f}s")
    out = np.asarray(sweep_stats5(s1, s2, code_t))[0]
    counts, maxrank = offset_stats_native(c1, c2, tables)
    if not (np.array_equal(out[:4, :noff].T, counts)
            and np.array_equal(out[4, :noff], maxrank)):
        raise PhaseFailed("kernel stats differ from the native engine")
    print("kernel 131072x8192 stats bit-identical to offset_stats_native")
    t_k = _timeit(lambda: sweep_stats5(s1, s2, code_t))
    xla = jax.jit(lambda a, b: engine_xla.local_stats_xla(
        a, b, code_flat, noff_pad, 4096))
    t0 = time.perf_counter()
    ref = np.asarray(xla(s1[0], s2[0]))
    print(f"xla gather compile+run {time.perf_counter() - t0:.2f}s")
    if not np.array_equal(ref[:, :noff], out[:, :noff]):
        raise PhaseFailed("xla gather stats differ")
    t_x = _timeit(lambda: xla(s1[0], s2[0]), 5)
    conv_args = (s1[0][: noff + n2 - 1], s2[0], jnp.asarray(tables.code),
                 tables.num_ranks)
    cc, cm = engine_conv._sweep_conv(*conv_args)
    if not (np.array_equal(np.asarray(cc)[:noff], counts)
            and np.array_equal(np.asarray(cm)[:noff], maxrank)):
        raise PhaseFailed("conv stats differ")
    t_c = _timeit(lambda: engine_conv._sweep_conv(*conv_args), 5)
    pairs = float(noff) * n2
    rows += [("131072x8192 sweep", "kernel", t_k),
             ("131072x8192 sweep", "xla gather", t_x),
             ("131072x8192 sweep", "xla conv", t_c)]
    print(f"kernel rate {pairs / (t_k * 1e-3):.4g} pair-evals/s")

    # batch of 1024 queries of 2048 x 512, distinct and shared Seq1
    b, n1, n2 = 1024, 2048, 512
    noff, noff_pad, l2p, l1k = plan_shapes(n1, n2)
    c1b = np.stack([pad_codes(rng.integers(0, 27, n1).astype(np.int32), l1k)
                    for _ in range(b)])
    c2b = np.stack([pad_codes(rng.integers(0, 27, n2).astype(np.int32), l2p)
                    for _ in range(b)])

    @jax.jit
    def xla_batch(a, bb):
        return jax.vmap(lambda x, y: engine_xla.local_stats_xla(
            x, y, code_flat, noff_pad, noff_pad))(a, bb)

    for label, c1x in (("distinct", c1b), ("shared", c1b[:1])):
        s1 = jnp.asarray(c1x)
        s2 = jnp.asarray(c2b)
        full = jnp.asarray(np.broadcast_to(c1x, c1b.shape))
        got = np.asarray(sweep_stats5(s1, s2, code_t))
        ref = np.asarray(xla_batch(full, s2))
        if not np.array_equal(got, ref):
            raise PhaseFailed(f"batch ({label}) stats differ from xla")
        for q in range(0, b, 128):
            counts, maxrank = offset_stats_native(c1x[min(q, len(c1x) - 1)]
                                                  [: n1], c2b[q][: n2],
                                                  tables)
            if not (np.array_equal(got[q, :4, :noff].T, counts)
                    and np.array_equal(got[q, 4, :noff], maxrank)):
                raise PhaseFailed(f"batch ({label}) query {q} differs "
                                  "from the native engine")
        rows += [(f"1024x(2048x512) {label}", "kernel",
                  _timeit(lambda: sweep_stats5(s1, s2, code_t))),
                 (f"1024x(2048x512) {label}", "xla gather",
                  _timeit(lambda: xla_batch(full, s2), 5))]
    print(f"timings on {card} (median warm ms, block_until_ready):")
    for shape, what, ms in rows:
        print(f"  {shape:28s} {what:11s} {ms:10.4f} ms")
    print("DEVICE " + json.dumps(device))


def phase_link() -> None:
    """psum_scatter bytes/s across the cards, as the 2-D search uses it."""
    device = _require_gpus(4)
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import shard_map
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    n = len(jax.devices())
    mesh = Mesh(np.asarray(jax.devices()), ("ch",))
    card = card_info().splitlines()[0]
    for per in (90112, 1 << 20, 1 << 22):       # offsets per shard
        x = jax.device_put(jnp.ones((4, n * per), jnp.int32),
                           NamedSharding(mesh, P(None, "ch")))
        f = jax.jit(shard_map(
            lambda a: jax.lax.psum_scatter(a, "ch", scatter_dimension=1,
                                           tiled=True),
            mesh=mesh, in_specs=P(None, "ch"), out_specs=P(None, "ch")))
        got = np.asarray(f(x))
        if not (got == n).all():
            raise PhaseFailed("psum_scatter result wrong")
        ms = _timeit(lambda: f(x))
        moved = 4 * 4 * per * (n - 1) / n       # bytes each card sends
        print(f"psum_scatter {n} cards, (4, {per}) int32 per card: "
              f"{ms:.4f} ms, {moved / (ms * 1e-3):.4g} B/s per card "
              f"({card})")
    print("DEVICE " + json.dumps(device))


def phase_devices() -> None:
    print("DEVICE " + json.dumps(_require_gpus(4)))


# ------------------------------------------------------------------ parents

def one_card() -> dict:
    device = device_phase("kernel")

    golden = os.path.join(WORK, "golden_device.txt")
    run("golden", psa_cli(os.path.join(ROOT, "tests", "data",
                                       "golden_input.txt"),
                          "-o", golden, "--backend", "pallas", "--quiet"))
    same_bytes("golden", golden,
               os.path.join(ROOT, "tests", "data", "golden_output.txt"))

    single_vs_native("northstar", gen(os.path.join(WORK, "ns.txt"),
                                      100_000, 10_000, 11))
    single_vs_native("1Mx2048", gen(os.path.join(WORK, "1m.txt"),
                                    1_000_000, 2048, 12))

    batch_vs_native("batch", gen(os.path.join(WORK, "batch.txt"), 2048, 512,
                                 21, cases=1024))

    from psa.utils.generator import random_sequences

    serve_in = os.path.join(WORK, "serve.txt")
    seq1, _ = random_sequences(2048, 512, seed=31)
    with open(serve_in, "w") as f:
        for i in range(1024):
            f.write(f"1 3 4 2 {seq1} {random_sequences(512, 512, seed=1000 + i)[1]}"
                    " minimum\n")
    with open(serve_in) as fin:
        dev = run("serve device", psa_cli("--serve", "--serve-batch", "1024",
                                          "--warmup", serve_in,
                                          "--backend", "pallas"), stdin=fin)
    with open(serve_in) as fin:
        ref = run("serve native", psa_cli("--serve", "--backend", "native",
                                          "--quiet"), stdin=fin)
    log("\n".join(ln for ln in dev.stderr.splitlines()
                  if ln.startswith(("[warmup]", "[serve]"))))
    if dev.stdout != ref.stdout or len(dev.stdout.splitlines()) != 1024:
        raise PhaseFailed("serve replies differ from the native engine")
    if "host engine: 0 queries" not in dev.stderr:
        raise PhaseFailed("serve answered some queries from the host engine")
    log("[serve] 1024 replies byte-identical, none from the host engine")

    p = run("pytest -m gpu", [sys.executable, "-m", "pytest", "-m", "gpu",
                              "tests", "-q", "-p", "no:cacheprovider"],
            env=child_env(PSA_INTERPRET="0"))
    summary = p.stdout.strip().splitlines()[-1]
    log(summary)
    if "passed" not in summary or "skipped" in summary:
        raise PhaseFailed("pytest -m gpu ran no test on the card")
    return device


def four_cards() -> dict:
    device = device_phase("devices")
    ns = gen(os.path.join(WORK, "ns.txt"), 100_000, 10_000, 11)
    for shape in ("4,1", "2,2"):
        single_vs_native("northstar", ns, "--sharded", "--quiet",
                         env=child_env(PSA_MESH_SHAPE=shape))
    batch_vs_native("batch4096", gen(os.path.join(WORK, "batch4096.txt"),
                                     2048, 512, 41, cases=4096), "--sharded")
    dist = os.path.join(WORK, "northstar_dist.txt")
    run("psa-dist -np 4", [sys.executable, "-m", "psa.utils.launcher", "-np",
                           "4", ns, "-o", dist, "--backend", "pallas",
                           "--quiet"])
    same_bytes("psa-dist", dist, os.path.join(WORK, "northstar_native.txt"))
    device_phase("link")
    return device


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    ap.add_argument("--phase", choices=("kernel", "link", "devices"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.phase:
        {"kernel": phase_kernel, "link": phase_link,
         "devices": phase_devices}[args.phase]()
        return 0
    os.makedirs(WORK, exist_ok=True)
    try:
        log(card_info())
        device = one_card() if args.cards == 1 else four_cards()
    except (PhaseFailed, subprocess.TimeoutExpired) as e:
        log(f"chip smoke FAILED: {e}")
        return 1
    if device["platform"] != "gpu" or device["count"] < args.cards:
        log(f"chip smoke FAILED: unexpected device {device}")
        return 1
    log(f"all phases passed in {time.perf_counter() - T_START:.1f}s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
