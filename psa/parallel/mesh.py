"""Offset-axis sharding over a device mesh.

Replacement for the reference's MPI data split
(cpu_funcs.c:128-133: contiguous equal offset blocks per rank, remainder to
the last) and its MAXLOC/Allreduce + Send/Recv merge (cpu_funcs.c:64-94):

* Seq1/Seq2/tables are replicated (Seq1 is small: bytes per char),
* the offset axis is block-sharded over the mesh with `shard_map` — each
  device slices its own Seq1 window with `lax.dynamic_slice` and sweeps only
  that window,
* per-offset integer statistics come back as a global array sharded on the
  offset axis; the exact winner is selected on the host (ops/select.py),
  whose integer inputs make the result independent of device count —
  the multi-host determinism requirement of SURVEY.md §7.2,
* a fully in-graph merge (`device_reduce_winner`) is also provided for
  pipelines that must not leave the device: it reduces each shard to a
  packed candidate and picks the global winner with an all-gather +
  lexicographic argmin, reproducing the canonical tie-break.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from psa.core.tables import ScoringTables
from psa.ops.common import CHUNK, TILE_O, round_up
from psa.ops.engine_xla import local_stats_xla


def make_mesh(devices=None, axis: str = "op") -> Mesh:
    """1-D mesh over all (or given) devices; offsets shard along `axis`."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def _pack_codes_host(codes: np.ndarray) -> np.ndarray:
    """5-bit packing of one padded code vector — the shared upload wire
    format (models/batch.pack_code_rows on a single row: the 100k-char
    north-star Seq1 ships as 67 KB instead of 400 KB)."""
    from psa.models.batch import pack_code_rows

    return pack_code_rows(codes[None, :])[0]


def _unpack_codes_graph(words: jnp.ndarray, n: int) -> jnp.ndarray:
    """In-graph inverse of `_pack_codes_host` (shift+mask, replicated)."""
    from psa.models.batch import unpack_code_rows

    return unpack_code_rows(words[None, :], n)[0]


def _resolve_kernel(kernel: str):
    """-> (kernel, interpret).  'auto' picks the device kernel when a GPU is
    present and the plain XLA sweep otherwise (a CPU mesh)."""
    from psa.ops.device import accelerator_present, resolve_interpret

    if kernel == "auto":
        kernel = "pallas" if accelerator_present() else "xla"
    return kernel, (resolve_interpret() if kernel == "pallas" else False)


def _local_stats(kernel: str, interpret: bool, c1_local, c2, tables,
                 per_shard: int):
    """(5, per_shard) statistics rows of one shard's offsets:
    c1_local holds exactly per_shard + len(c2) codes."""
    if kernel == "pallas":
        from psa.ops.device import sweep_kernel
        from psa.ops.pallas_sweep import code_table_t

        return sweep_kernel(interpret)(c1_local[None], c2[None],
                                       code_table_t(tables.code))[0]
    code_flat = jnp.asarray(tables.code.reshape(-1).astype(np.int32))
    return local_stats_xla(c1_local, c2, code_flat, per_shard)


_SHARDED_FNS: dict = {}   # LRU-capped via models/batch's locked helpers


def make_sharded_stats_fn(tables: ScoringTables, mesh: Mesh,
                          l1p: int, l2p: int, kernel: str = "auto"):
    """Build (and cache) the jitted sharded sweep for one configuration.
    Rebuilding the shard_map closure per call costs ~200ms of host tracing,
    so callers should reuse the returned function."""
    axis = mesh.axis_names[0]
    n_shards = mesh.shape[axis]
    kernel, interpret = _resolve_kernel(kernel)
    key = (tuple(tables.weights.tolist()), tables.is_max, kernel, interpret,
           l1p, l2p, axis, tuple(d.id for d in mesh.devices.flat))
    from psa.models.batch import _cache_get, _cache_put

    cached = _cache_get(_SHARDED_FNS, key)
    if cached is not None:
        return cached

    from psa.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    noff_pad = l1p - l2p
    assert noff_pad % (n_shards * TILE_O) == 0, "pad offsets to n_shards*TILE_O"
    per_shard = noff_pad // n_shards

    def body(c1, c2):
        k = jax.lax.axis_index(axis)
        o0 = k * per_shard
        c1_local = jax.lax.dynamic_slice(c1, (o0,), (per_shard + l2p,))
        return _local_stats(kernel, interpret, c1_local, c2, tables,
                            per_shard).T

    # Explicit replicated in_shardings: host numpy inputs become global
    # replicated arrays without cross-process resharding — required for the
    # multi-process (multi-controller) path, harmless single-process.
    repl = NamedSharding(mesh, P())
    fn = jax.jit(shard_map(
        body, mesh=mesh,
        in_specs=(P(), P()),
        out_specs=P(axis, None),
        check_vma=False,
    ), in_shardings=(repl, repl))
    return _cache_put(_SHARDED_FNS, key, fn)


def sharded_offset_stats(codes1p: jnp.ndarray, codes2p: jnp.ndarray,
                         tables: ScoringTables, mesh: Mesh,
                         kernel: str = "auto"):
    """Global (noff_pad, 5) int32 stats, block-sharded over the mesh.

    codes1p must be padded so every shard's window fits:
    len >= noff_pad + len(codes2p) where noff_pad = n_shards * per_shard.
    """
    fn = make_sharded_stats_fn(tables, mesh, codes1p.shape[0],
                               codes2p.shape[0], kernel)
    return fn(codes1p, codes2p)


def pad_for_mesh(codes1: np.ndarray, codes2: np.ndarray, n_shards: int):
    """Pad sequences so the offset axis splits into n_shards x TILE_O
    blocks and Seq2 into CHUNK-char steps."""
    from psa.core.alphabet import pad_codes

    n1, n2 = codes1.shape[0], codes2.shape[0]
    noff = n1 - n2 + 1
    l2p = round_up(max(n2, CHUNK), CHUNK)
    noff_pad = round_up(noff, n_shards * TILE_O)
    l1p = noff_pad + l2p
    return pad_codes(codes1, l1p), pad_codes(codes2, l2p), noff


def make_sharded_topk_fn(tables: ScoringTables, mesh: Mesh,
                         l1p: int, l2p: int, kernel: str = "auto",
                         k: int | None = None):
    """Build (and cache) the jitted sharded sweep WITH the in-graph
    checkable-exact top-k epilogue: each shard sweeps its offset block and
    reduces it to k candidate offsets with exact integer stats, so only
    (n_shards, 6k+2) ints ever leave the devices — the sharded analog of
    the reference GPU driver copying only the winner back
    (cuda_funcs.cu:106-119).  Returns fn(c1w, c2w, noff) -> packed rows
    (one per shard, global offsets; models/batch.unpack_epilogue_outputs);
    c1w/c2w are `_pack_codes_host` words — the upload wire format, 6 codes
    per int32 word (the 100k-char north star's Seq1 ships as 67 KB instead
    of 400 KB)."""
    from psa.models.batch import (TOPK, epilogue_compact,
                                      exact_topk_epilogue_rows,
                                      pack_epilogue_outputs)

    if k is None:
        k = TOPK
    axis = mesh.axis_names[0]
    n_shards = mesh.shape[axis]
    kernel, interpret = _resolve_kernel(kernel)
    key = ("topk", tuple(tables.weights.tolist()), tables.is_max, kernel,
           interpret, l1p, l2p, k, axis,
           tuple(d.id for d in mesh.devices.flat))
    from psa.models.batch import _cache_get, _cache_put

    cached = _cache_get(_SHARDED_FNS, key)
    if cached is not None:
        return cached

    from psa.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    noff_pad = l1p - l2p
    assert noff_pad % (n_shards * TILE_O) == 0, "pad offsets to n_shards*TILE_O"
    per_shard = noff_pad // n_shards

    def body(c1w, c2w, noff):
        c1 = _unpack_codes_graph(c1w, l1p)
        c2 = _unpack_codes_graph(c2w, l2p)
        s = jax.lax.axis_index(axis)
        o0 = s * per_shard
        c1_local = jax.lax.dynamic_slice(c1, (o0,), (per_shard + l2p,))
        stats5 = _local_stats(kernel, interpret, c1_local, c2, tables,
                              per_shard)
        # shard-local valid offset count; the epilogue masks the rest
        noff_local = jnp.clip(noff[0] - o0, 0, per_shard)
        topi, stats_k, near, best = exact_topk_epilogue_rows(
            stats5, tables, noff_local, l2p, k)
        # report GLOBAL offsets so the host merge needs no shard arithmetic;
        # the compact gate therefore uses the GLOBAL offset range
        return pack_epilogue_outputs((topi + o0)[None], stats_k[None],
                                     near[None], best[None],
                                     epilogue_compact(noff_pad, l2p))

    repl = NamedSharding(mesh, P())
    fn = jax.jit(shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(axis, None),
        check_vma=False,
    ), in_shardings=(repl, repl, repl))
    return _cache_put(_SHARDED_FNS, key, fn)


def make_mesh_2d(devices=None, n_op: int = 1, n_ch: int = 1) -> Mesh:
    """2-D search mesh with axes ("op", "ch"): offset blocks x char chunks.

    The char axis is the mesh analog of the reference tiling the char
    dimension across CUDA threads (cuda_funcs.cu:165-175): each (i, j)
    shard sweeps offset block i over Seq2 chunk j, then class counts SUM
    and substitution ranks MAX across the "ch" axis — exact by
    construction (integer stats).  For small-offset-count workloads
    (noff/N ~ l2p, the strong-scaling regime where pure offset sharding
    pays the full window overlap per shard), char sharding removes the
    overlap: per-shard work is (noff + l2p/n_ch) * l2p/n_ch instead of
    (noff/N + l2p) * l2p."""
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices)[: n_op * n_ch]
    assert devices.size == n_op * n_ch, (devices.size, n_op, n_ch)
    return Mesh(devices.reshape(n_op, n_ch), ("op", "ch"))


# choose_mesh_shape's collective-cost conversion: pair-evals the sweep
# kernel retires in the time the "ch" reduce-scatter moves one byte between
# cards.  Both rates measured on NVIDIA H100 80GB HBM3 cards by
# `chip_smoke.py`: the kernel's 8.2e11 pair-evals/s on the 131072x8192 sweep
# (one card), over psum_scatter's 5.4e10 B/s per card at 64 MB per card
# across four NVLink-joined cards (`--cards 4`; small messages pay a fixed
# ~0.6 ms per standalone call on top, which this linear model leaves out).
_PAIRS_PER_LINK_BYTE = 15.2


def choose_mesh_shape(ndev: int, noff: int, n2: int) -> tuple[int, int]:
    """(n_op, n_ch) minimizing per-shard sweep work + modeled collective.

    Sweep model: (per_op + lc) * lc with per_op = noff/n_op, lc = l2p/n_ch
    — the kernel cost is ~ window_width * chars (window overlap included).
    Collective model: the "ch" reduction moves ~24 bytes per owned offset
    row ((4-row int32 psum_scatter + 1-row pmax) x (n_ch-1)/n_ch), charged
    at _PAIRS_PER_LINK_BYTE.  Pure offset sharding wins for long-Seq1
    workloads (overlap amortized, no collective); char sharding wins when
    noff/N is comparable to l2p (the north-star 100k x 10k regime).  The
    char split is capped so each char chunk keeps >= 256 chars."""
    best = (ndev, 1)
    best_cost = None
    n_ch = 1
    while n_ch <= ndev:
        n_op = ndev // n_ch
        if n_op * n_ch == ndev:
            # the chunk length this split would actually pad to
            lc = round_up(max(n2, CHUNK * n_ch), CHUNK * n_ch) // n_ch
            if n_ch == 1 or lc >= 256:
                per_op = noff / n_op
                cost = (per_op + lc) * lc
                cost += _PAIRS_PER_LINK_BYTE * 24.0 * per_op * (
                    (n_ch - 1) / n_ch)
                if best_cost is None or cost < best_cost:
                    best, best_cost = (n_op, n_ch), cost
        n_ch *= 2
    return best


def pad_for_mesh_2d(codes1: np.ndarray, codes2: np.ndarray, n_op: int,
                    n_ch: int):
    """Pad so the offset axis splits into n_op x n_ch x TILE_O blocks (each
    (i, j) shard epilogues a TILE_O-multiple block after the char
    reduction) and Seq2 splits into n_ch CHUNK-multiple chunks."""
    from psa.core.alphabet import pad_codes

    n1, n2 = codes1.shape[0], codes2.shape[0]
    noff = n1 - n2 + 1
    l2p = round_up(max(n2, CHUNK * n_ch), CHUNK * n_ch)
    noff_pad = round_up(noff, n_op * n_ch * TILE_O)
    l1p = noff_pad + l2p
    return pad_codes(codes1, l1p), pad_codes(codes2, l2p), noff


def make_sharded_topk_fn_2d(tables: ScoringTables, mesh: Mesh,
                            l1p: int, l2p: int, kernel: str = "auto",
                            k: int | None = None):
    """2-D (offset x char) sharded sweep with in-graph exact reduction and
    per-shard checkable-exact top-k.

    Per (i, j) shard: sweep offset block i over Seq2 chunk j (the sweep
    kernel unchanged — a char chunk is just a shorter Seq2), then
    - class counts: `psum_scatter` over "ch" (counts are exact ints; sum
      over chunks = full-sweep counts), scattered along the offset axis so
      each shard owns a disjoint per_op/n_ch block — the merge is part of
      the compiled program, not a host loop;
    - substitution rank: `pmax` over "ch" (rank of the max is the max of
      chunk ranks — monotone), sliced to the same block;
    then the standard exact_topk epilogue on the owned block (f32 epsilon
    from the FULL l2p: post-reduction stats are full-length sums).  Output:
    one packed candidate row per shard, global offsets — the host merge is
    identical to the 1-D path (`_select_from_shard_topk`).
    """
    from psa.models.batch import (TOPK, epilogue_compact,
                                      exact_topk_epilogue_rows,
                                      pack_epilogue_outputs)

    if k is None:
        k = TOPK
    assert mesh.axis_names == ("op", "ch"), mesh.axis_names
    n_op = mesh.shape["op"]
    n_ch = mesh.shape["ch"]
    kernel, interpret = _resolve_kernel(kernel)
    # weights in the key: the epilogue bakes tables as compiled constants
    # (same as the 1-D fn) — omitting them would reuse the wrong program
    # for a second weight vector on the same (mode, shapes)
    key = ("topk2d", tuple(tables.weights.tolist()), tables.is_max, kernel,
           interpret, l1p, l2p, k, n_op, n_ch,
           tuple(d.id for d in mesh.devices.flat))
    from psa.models.batch import _cache_get, _cache_put

    cached = _cache_get(_SHARDED_FNS, key)
    if cached is not None:
        return cached

    from psa.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    noff_pad = l1p - l2p
    assert l2p % (CHUNK * n_ch) == 0, (l2p, n_ch)
    assert noff_pad % (n_op * n_ch * TILE_O) == 0, (noff_pad, n_op, n_ch)
    per_op = noff_pad // n_op          # offsets per op-row
    blk = per_op // n_ch               # offsets owned per shard post-scatter
    lc = l2p // n_ch                   # Seq2 chars per char-chunk
    compact = epilogue_compact(noff_pad, l2p)

    def body(c1w, c2w, noff):
        c1 = _unpack_codes_graph(c1w, l1p)
        c2 = _unpack_codes_graph(c2w, l2p)
        i = jax.lax.axis_index("op")
        j = jax.lax.axis_index("ch")
        o0 = i * per_op
        c0 = j * lc
        # offsets [o0, o0+per_op) x chars [c0, c0+lc): the Seq1 window is
        # c1[o0+c0 : o0+c0+per_op+lc] (end <= l1p by construction)
        c1_local = jax.lax.dynamic_slice(c1, (o0 + c0,), (per_op + lc,))
        c2_local = jax.lax.dynamic_slice(c2, (c0,), (lc,))
        stats5 = _local_stats(kernel, interpret, c1_local, c2_local, tables,
                              per_op)
        counts = jax.lax.psum_scatter(stats5[:4], "ch",
                                      scatter_dimension=1, tiled=True)
        mr_full = jax.lax.pmax(stats5[4:5], "ch")
        mr = jax.lax.dynamic_slice(mr_full, (0, j * blk), (1, blk))
        stats_l = jnp.concatenate([counts, mr], axis=0)       # (5, blk)
        g0 = o0 + j * blk                  # global offset of the owned block
        noff_local = jnp.clip(noff[0] - g0, 0, blk)
        topi, stats_k, near, best = exact_topk_epilogue_rows(
            stats_l, tables, noff_local, l2p, k)
        return pack_epilogue_outputs((topi + g0)[None], stats_k[None],
                                     near[None], best[None], compact)

    repl = NamedSharding(mesh, P())
    fn = jax.jit(shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(("op", "ch"), None),
        check_vma=False,
    ), in_shardings=(repl, repl, repl))
    return _cache_put(_SHARDED_FNS, key, fn)


def search_sharded_2d(codes1: np.ndarray, codes2: np.ndarray,
                      tables: ScoringTables, mesh: Mesh,
                      kernel: str = "auto"):
    """End-to-end 2-D sharded search -> SearchResult (exact host selection).

    The f32-uncertifiable fallback (provably rare: > k near-ties inside a
    contributing shard) re-runs through the 1-D full-stats path on a flat
    mesh over the same devices."""
    from psa.models.batch import TOPK, epilogue_compact
    from psa.ops.select import select_best

    n_op = mesh.shape["op"]
    n_ch = mesh.shape["ch"]
    c1p, c2p, noff = pad_for_mesh_2d(codes1, codes2, n_op, n_ch)
    fn = make_sharded_topk_fn_2d(tables, mesh, c1p.shape[0], c2p.shape[0],
                                 kernel=kernel)
    buf = fn(_pack_codes_host(c1p), _pack_codes_host(c2p),
             np.array([noff], np.int32))
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        buf = multihost_utils.process_allgather(buf, tiled=True)
    res = _select_from_shard_topk(
        np.asarray(buf), noff, c2p.shape[0], tables, codes1, codes2, TOPK,
        epilogue_compact(c1p.shape[0] - c2p.shape[0], c2p.shape[0]))
    if res is not None:
        return res
    flat = Mesh(mesh.devices.reshape(-1), ("op",))
    c1f, c2f, noff = pad_for_mesh(codes1, codes2, flat.devices.size)
    stats = sharded_offset_stats(c1f, c2f, tables, flat, kernel=kernel)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        stats = multihost_utils.process_allgather(stats, tiled=True)
    stats = np.asarray(stats)
    return select_best(stats[:, :4], stats[:, 4], tables,
                       np.asarray(codes1, np.int32),
                       np.asarray(codes2, np.int32), noff=noff)


def _select_from_shard_topk(buf: np.ndarray, noff: int, l2p: int,
                            tables: ScoringTables, codes1, codes2, k: int,
                            compact: bool):
    """Exact host selection from per-shard top-k candidate rows.

    Returns a SearchResult, or None when the f32 ranking was insufficient
    for some contributing shard (near > k inside the global band) — the
    caller falls back to the full-stats path.  Raises NoMutationFound when
    no shard found any legal substitution."""
    from psa.core.result import NoMutationFound
    from psa.models.batch import f32_band_epsilon, unpack_epilogue_outputs
    from psa.ops.select import (candidate_epsilon, pick_from_candidates,
                                    totals_from_stats)

    topi, stats_k, near, best = unpack_epilogue_outputs(buf, k, compact)
    if np.all(np.isneginf(best)):
        raise NoMutationFound("no offset admits a legal substitution")
    bg = best.max()                       # global keyed f32 best
    eps32 = f32_band_epsilon(tables, l2p)
    # checkability: every offset within the f32 band of the GLOBAL best must
    # appear in its shard's top-k.  A shard whose own band population
    # exceeded k can only hide such an offset if its local best reaches the
    # global band.
    if np.any((near > k) & (best >= bg - eps32)):
        return None
    offs = topi.reshape(-1).astype(np.int64)
    st = np.swapaxes(stats_k, 1, 2).reshape(-1, 5)      # (S*k, 5)
    keep = (offs < noff) & (st[:, 4] >= 0)
    offs, st = offs[keep], st[keep]
    if offs.size == 0:
        raise NoMutationFound("no offset admits a legal substitution")
    totals = totals_from_stats(st[:, :4], st[:, 4], tables)
    bq = totals.max() if tables.is_max else totals.min()
    cand = offs[np.abs(totals - bq) <= candidate_epsilon(
        tables, int(codes2.shape[0]))]
    # ascending order = the canonical lowest-offset tie-break (shards own
    # disjoint blocks, so there are no duplicates)
    return pick_from_candidates(np.asarray(codes1, np.int32),
                                np.asarray(codes2, np.int32), tables,
                                np.sort(cand))


def search_sharded(codes1: np.ndarray, codes2: np.ndarray,
                   tables: ScoringTables, mesh: Mesh | None = None,
                   kernel: str = "auto"):
    """End-to-end sharded search -> SearchResult (exact host selection).

    The hot path reduces each shard to its top-k exact candidates in-graph
    (make_sharded_topk_fn) so the host fetch is ~(6k+2) ints per shard, not
    the full (noff, 5) stats; the provably-rare case where f32 ranking
    cannot certify the winner (>k near-ties inside a contributing shard)
    falls back to the full-stats fetch + unrestricted exact selection."""
    from psa.core.result import NoMutationFound
    from psa.models.batch import TOPK
    from psa.ops.select import select_best

    if mesh is None:
        mesh = make_mesh()
    n_shards = mesh.shape[mesh.axis_names[0]]
    c1p, c2p, noff = pad_for_mesh(codes1, codes2, n_shards)
    # pass host numpy (uncommitted) so the jit's replicated in_shardings can
    # place full copies per process — a committed single-device array cannot
    # be resharded across processes
    fn = make_sharded_topk_fn(tables, mesh, c1p.shape[0], c2p.shape[0],
                              kernel=kernel)
    buf = fn(_pack_codes_host(c1p), _pack_codes_host(c2p),
             np.array([noff], np.int32))
    if jax.process_count() > 1:
        # multi-host: each process holds only its shards; gather over DCN
        from jax.experimental import multihost_utils

        buf = multihost_utils.process_allgather(buf, tiled=True)
    from psa.models.batch import epilogue_compact

    res = _select_from_shard_topk(
        np.asarray(buf), noff, c2p.shape[0], tables, codes1, codes2, TOPK,
        epilogue_compact(c1p.shape[0] - c2p.shape[0], c2p.shape[0]))
    if res is not None:
        return res
    stats = sharded_offset_stats(c1p, c2p, tables, mesh, kernel=kernel)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        stats = multihost_utils.process_allgather(stats, tiled=True)
    stats = np.asarray(stats)
    return select_best(stats[:, :4], stats[:, 4], tables,
                       np.asarray(codes1, np.int32),
                       np.asarray(codes2, np.int32), noff=noff)


def search_sharded_auto(codes1: np.ndarray, codes2: np.ndarray,
                        tables: ScoringTables, devices=None,
                        kernel: str = "auto"):
    """Sharded search with the mesh SHAPE chosen per workload.

    `choose_mesh_shape` picks (n_op, n_ch) from the sweep-work + collective
    model; n_ch == 1 routes through the plain offset-sharded path (no
    collectives), n_ch > 1 through the 2-D char-reduction path.  Override
    with PSA_MESH_SHAPE="n_op,n_ch" (must multiply to the device count)."""
    import os

    if devices is None:
        devices = jax.devices()
    ndev = len(devices)
    noff = codes1.shape[0] - codes2.shape[0] + 1
    spec = os.environ.get("PSA_MESH_SHAPE")
    if spec:
        n_op, n_ch = (int(x) for x in spec.split(","))
        if n_op * n_ch != ndev:
            raise ValueError(
                f"PSA_MESH_SHAPE={spec} does not cover {ndev} devices")
    else:
        n_op, n_ch = choose_mesh_shape(ndev, noff, codes2.shape[0])
    if n_ch == 1:
        return search_sharded(codes1, codes2, tables,
                              make_mesh(devices), kernel=kernel)
    return search_sharded_2d(codes1, codes2, tables,
                             make_mesh_2d(devices, n_op, n_ch),
                             kernel=kernel)


def device_reduce_winner(stats: jnp.ndarray, tables: ScoringTables, noff: int):
    """In-graph global winner from sharded stats (f32 ranking).

    Returns (offset, maxrank, total_f32). Used by throughput paths that must
    avoid host transfers; exactness-critical flows use ops/select.py instead.
    """
    from psa.ops.common import keyed_f32_totals

    maxrank = stats[:, 4]
    keyed, total = keyed_f32_totals(stats[:, :4], maxrank, tables, noff)
    best = jnp.argmax(keyed)  # first occurrence = lowest offset on ties
    return best, maxrank[best], total[best]
