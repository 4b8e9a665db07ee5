"""Batched multi-query search over a 2-D (batch x offset) device mesh.

BASELINE.json config 5: stream many independent (Seq1, Seq2, weights-shared)
queries data-parallel across the devices.  Queries are padded to shared bucketed
shapes and sharded over the 'dp' mesh axis; each query's offset axis is
sharded over 'op' exactly like the single-query path (parallel/mesh.py).
The winner reduction stays in-graph so only (B, 3) scalars leave the device.
"""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from psa.core.tables import ScoringTables
from psa.ops.common import TILE_O
from psa.ops.device import resolve_interpret
from psa.ops.engine_xla import local_stats_xla


def make_mesh_2d(dp: int, op: int, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices[: dp * op]).reshape(dp, op)
    return Mesh(devices, ("dp", "op"))


def batched_sharded_stats(c1b: jnp.ndarray, c2b: jnp.ndarray,
                          tables: ScoringTables, mesh: Mesh,
                          block: int = TILE_O):
    """(B, L1P) x (B, L2P) -> (B, noff_pad, 5) int32 sharded (dp, op, None)."""
    l1p, l2p = c1b.shape[1], c2b.shape[1]
    noff_pad = l1p - l2p
    op = mesh.shape["op"]
    assert noff_pad % (op * block) == 0
    per_shard = noff_pad // op
    code_flat = jnp.asarray(tables.code.reshape(-1).astype(np.int32))

    def body(c1_loc, c2_loc, cflat):
        k = jax.lax.axis_index("op")
        o0 = k * per_shard

        def per_query(c1, c2):
            c1l = jax.lax.dynamic_slice(c1, (o0,), (per_shard + l2p,))
            return local_stats_xla(c1l, c2, cflat, per_shard, block).T

        return jax.vmap(per_query)(c1_loc, c2_loc)

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(P("dp", None), P("dp", None), P()),
        out_specs=P("dp", "op", None),
        check_vma=False,
    )
    return fn(c1b, c2b, code_flat)


def batched_device_winners(stats: jnp.ndarray, tables: ScoringTables,
                           noffs: jnp.ndarray):
    """In-graph per-query winners: (B,) offsets, (B,) maxranks, (B,) f32 totals."""
    from psa.ops.common import keyed_f32_totals

    maxrank = stats[..., 4]
    keyed, total = keyed_f32_totals(stats[..., :4], maxrank, tables, noffs)
    best = jnp.argmax(keyed, axis=1)  # first occurrence = lowest offset
    bi = jnp.arange(stats.shape[0])
    return best, maxrank[bi, best], total[bi, best]


def _stats5(c1b, c2b, code_tab, interpret: bool):
    """Whole-batch sweep -> stats5 (b, 5, noff_pad) int32: rows 0-3 class
    counts, row 4 maxrank, offset axis minor.  c1b: (b, l1k) codes, or ONE
    (1, l1k) row that every query shares (the many-reads-vs-one-reference
    serving pattern: the kernel reads row 0 for every query, so Seq1 is
    neither uploaded nor stored B times).

    code_tab: the (32, 32) fused code table (tables.code) as a VALUE — a
    traced operand in the weights-generic runners (one compiled program per
    shape serves any weights).  Also the per-shard body of the mesh-sharded
    exact batch path (each shard sweeps its local queries)."""
    from psa.ops.device import sweep_kernel
    from psa.ops.pallas_sweep import code_table_t

    return sweep_kernel(interpret)(c1b, c2b, code_table_t(code_tab))


_EXACT_RUNNERS: dict = {}
# A long-lived server streaming queries with UNBOUNDED weight/shape
# diversity would otherwise accumulate one jitted runner (and its XLA
# executable) per distinct configuration forever; evicting the least
# recently used entry drops the last reference so the executable can be
# collected.  The cap is generous — eviction costs a recompile, and real
# serving traffic has a handful of configurations.
_RUNNER_CACHE_CAP = 128
# One lock for every runner cache: the Finisher thread refills the
# dispatch window (building runners) concurrently with the serve loop's
# own dispatches — an unlocked del-then-reinsert could KeyError or drop a
# hot runner into a ~0.8s re-trace.
_CACHE_LOCK = threading.Lock()


def _cache_put(cache: dict, key, value):
    """Insert with LRU eviction (dicts preserve insertion order)."""
    with _CACHE_LOCK:
        cache[key] = value
        while len(cache) > _RUNNER_CACHE_CAP:
            evicted = next(iter(cache))
            cache.pop(evicted)
            # the evicted executable is gone; a future dispatch recompiles
            _WARM_KEYS.discard(evicted)
    return value


def _cache_get(cache: dict, key):
    """Lookup that refreshes recency (move-to-end on hit)."""
    with _CACHE_LOCK:
        v = cache.get(key)
        if v is not None:
            del cache[key]
            cache[key] = v
        return v


# Runner keys whose XLA executable has actually been BUILT (the jitted
# callable compiled on a completed call, or an explicit warmup).  A key in
# _EXACT_RUNNERS alone is not enough: jit compiles on first call, and a
# compile is a latency a serve reply must never wait on.  Guarded by
# _CACHE_LOCK.
_WARM_KEYS: set = set()


def runner_is_warm(key) -> bool:
    with _CACHE_LOCK:
        return key in _WARM_KEYS


# Queries answered by the host engine because their bucket's device runner
# was still cold (search_batch_async cold_route); the serve loops report it.
_COLD_ROUTED = [0]


def cold_routed_queries() -> int:
    with _CACHE_LOCK:
        return _COLD_ROUTED[0]


def reset_runner_caches() -> None:
    """Drop every cached runner AND its warm flag together.

    The warm-flag invariant (warm => a compiled executable is cached) is
    otherwise maintained only via _cache_put's eviction; anything that
    clears `_EXACT_RUNNERS` / `jax.clear_caches()` by hand (campaign,
    long-running test harnesses) must go through here or cold_route would
    dispatch a 'warm' bucket straight into a synchronous recompile."""
    with _CACHE_LOCK:
        _EXACT_RUNNERS.clear()
        _WARM_KEYS.clear()


def _mark_warm(key) -> None:
    # only while the runner is still cached: a concurrent LRU eviction
    # (_cache_put) may have dropped this key mid-call, and a warm flag
    # without a cached runner would make cold_route dispatch a reply
    # straight into a synchronous recompile
    with _CACHE_LOCK:
        if key in _EXACT_RUNNERS:
            _WARM_KEYS.add(key)


def _mark_warm_after_first(run, key):
    """Wrap a jitted runner so its key is marked warm once a call completes
    (jit compiles synchronously inside the call, so returning == built)."""
    state = {"done": False}

    def wrapper(*args):
        out = run(*args)
        if not state["done"]:    # benign race: set-add is idempotent
            state["done"] = True
            _mark_warm(key)
        return out

    return wrapper


def _fused_runner_key(tables: ScoringTables, b: int, l1k: int, l2p: int,
                      interpret: bool, k: int, shared_s1: bool = False):
    # NO weights in the key: the fused runners are weights-generic (the
    # code/w/diff/eps tables enter as runtime operands), so one compiled
    # program per (mode, batch, shapes) serves any weights — a new weights
    # vector on a known bucket costs zero compiles.  shared_s1 selects the
    # dedup-Seq1 wire variant (one uploaded Seq1 row, device broadcast).
    return ("fusedW" + ("s1" if shared_s1 else ""), tables.is_max, b, l1k,
            l2p, interpret, k)


def runner_key_batch(key) -> int:
    """The padded batch size a fused/sharded runner key was built for."""
    assert key[0] in ("fusedW", "fusedWs1", "fused-shardedW",
                      "fused-shardedWs1"), key
    return key[2]


def _mesh_cache_key(mesh: Mesh):
    return (mesh.axis_names, tuple(d.id for d in mesh.devices.flat))


def _sharded_runner_key(tables: ScoringTables, b: int, l1k: int, l2p: int,
                        mesh: Mesh, interpret: bool, k: int,
                        shared_s1: bool = False):
    return ("fused-shardedW" + ("s1" if shared_s1 else ""), tables.is_max,
            b, l1k, l2p, _mesh_cache_key(mesh), interpret, k)


def planned_runner_keys(tables: ScoringTables, b_n: int, l1k: int, l2p: int,
                        interpret: bool | None = None, k: int | None = None,
                        mesh: Mesh | None = None,
                        micro_b: int | None = None,
                        shared_s1: bool = False) -> set:
    """The exact runner-cache keys a `batched_search_exact[_sharded]_async`
    call for a b_n-query bucket would dispatch through — the cold-bucket
    check and the warmup path both derive their work from this, so they can
    never drift from the dispatch plan."""
    from psa.config import CONFIG

    interpret = resolve_interpret(interpret)
    if k is None:
        k = TOPK
    mb = int(micro_b) if micro_b else CONFIG.micro_batch
    keys = set()
    if mesh is None:
        for s, e in microbatch_spans(b_n, mb):
            keys.add(_fused_runner_key(tables, _round_batch(e - s, mb), l1k,
                                       l2p, bool(interpret), k,
                                       shared_s1 and b_n > 1))
    else:
        ndev = mesh.devices.size
        for s, e in microbatch_spans(b_n, mb * ndev):
            per = _round_batch(-(-(e - s) // ndev), mb)
            keys.add(_sharded_runner_key(tables, per * ndev, l1k, l2p, mesh,
                                         bool(interpret), k,
                                         shared_s1 and b_n > 1))
    return keys


def warm_fused_runner(tables: ScoringTables, b: int, l1k: int, l2p: int,
                      interpret: bool | None = None, k: int | None = None,
                      mesh: Mesh | None = None,
                      shared_s1: bool = False) -> None:
    """Pre-compile one bucket runner: build it, execute one all-PAD dummy
    microbatch, and block until the result is ready.  After this returns,
    a serve chunk hitting the same (mode, b, l1k, l2p) bucket pays zero
    compile latency — for ANY weights (the runners are weights-generic).
    The reference analog: it always answers with whatever engine it has
    (cpu_funcs.c:135-150) — never block a reply on device setup."""
    import jax

    from psa.core.alphabet import PAD_CODE

    interpret = resolve_interpret(interpret)
    if k is None:
        k = TOPK
    c1 = np.full((b, l1k), PAD_CODE, np.int8)
    c2 = np.full((b, l2p), PAD_CODE, np.int8)
    noffs = np.ones(b, np.int32)
    # the runner wrapper marks the key warm when this call completes
    if mesh is None:
        run = make_batched_fused_runner(tables, b, l1k, l2p, bool(interpret),
                                        k, shared_s1=shared_s1)
    else:
        run = make_batched_fused_sharded_runner(tables, b, l1k, l2p, mesh,
                                                bool(interpret), k,
                                                shared_s1=shared_s1)
    if shared_s1:
        inbuf, c1w = pack_query_inputs_shared(c1[0], c2, noffs)
        jax.block_until_ready(run(jnp.asarray(inbuf), jnp.asarray(c1w)))
        return
    jax.block_until_ready(run(jnp.asarray(pack_query_inputs(c1, c2, noffs))))


class _Warmer:
    """One background thread compiling cold bucket runners FIFO.

    Single worker by design: concurrent compiles contend for the same
    host cores, and the serve loop must stay responsive while warms
    proceed.
    Deduplicates by runner key, skipping keys already warm or queued."""

    # a deterministically-failing compile must not monopolize the single
    # warmer forever (every cold chunk would re-queue it); after this many
    # failures the key is dropped and its bucket stays host-routed
    _MAX_FAILURES = 3

    def __init__(self):
        import queue

        self._q: "queue.Queue" = queue.Queue()
        self._pending: set = set()      # guarded by _CACHE_LOCK
        self._failures: dict = {}       # key -> failed attempt count
        self._active = None             # key mid-compile (guarded too)
        self._closing = False           # exit drain in progress
        self._t = None
        # long-lived serve processes wait longer for an in-flight compile at
        # exit (losing it costs the next cold hit a synchronous stall); a
        # one-shot CLI invocation loses nothing, so it bounds the wait low
        self.long_lived = False

    def submit(self, key, fn) -> bool:
        with _CACHE_LOCK:
            if (key in _WARM_KEYS or key in self._pending
                    or self._failures.get(key, 0) >= self._MAX_FAILURES
                    or self._closing):
                return False
            self._pending.add(key)
            if self._t is None:
                import atexit

                self._t = threading.Thread(target=self._run, daemon=True,
                                           name="psa-warmer")
                self._t.start()
                atexit.register(self._drain_at_exit)
        self._q.put((key, fn))
        return True

    def _run(self):
        import sys

        while True:
            key, fn = self._q.get()
            with _CACHE_LOCK:
                if self._closing:       # exit drain won the race: don't
                    self._pending.discard(key)   # start a new compile
                    continue
                self._active = key
            try:
                fn()
                with _CACHE_LOCK:
                    self._failures.pop(key, None)
            except Exception as e:  # noqa: BLE001 - warmup is best-effort
                with _CACHE_LOCK:
                    self._failures[key] = self._failures.get(key, 0) + 1
                    nfail = self._failures[key]
                tail = (" (giving up; the bucket stays on the host engine)"
                        if nfail >= self._MAX_FAILURES else "")
                print(f"warning: background bucket warmup failed "
                      f"(attempt {nfail}, {type(e).__name__}: {e}){tail}",
                      file=sys.stderr)
            finally:
                with _CACHE_LOCK:
                    self._active = None
                    self._pending.discard(key)

    def _drain_at_exit(self):
        """Interpreter-shutdown guard: tearing down the process while a
        compile RPC is mid-flight on the daemon thread can SIGABRT inside
        the PJRT client ('FATAL: exception not rethrown').  Drop queued
        warms and wait (bounded) for the active one to finish; a no-op in
        the common case of an idle warmer."""
        import os
        import queue
        import sys
        import time

        with _CACHE_LOCK:
            # set under the same lock the worker uses before starting a
            # compile: any worker past its _closing check has _active set,
            # so the wait below cannot miss a just-starting compile
            self._closing = True
            active = self._active
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if active is None:
            with _CACHE_LOCK:
                active = self._active
        if active is None:
            return
        # default bound: 1800 s for a serve process (the compile is worth
        # keeping — see mark_serve_process), 300 s for a one-shot CLI run
        # where losing it is harmless (the wait exists only to avoid
        # tearing down PJRT mid-RPC)
        default = "1800" if self.long_lived else "300"
        timeout = float(os.environ.get("PSA_WARMER_EXIT_TIMEOUT", default))
        print(f"[psa] waiting for the in-flight background compile of "
              f"bucket {active!r} before exit (bound: "
              f"PSA_WARMER_EXIT_TIMEOUT={timeout:.0f}s)",
              file=sys.stderr)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with _CACHE_LOCK:
                if self._active is None:
                    return
            time.sleep(0.1)

    def join(self, timeout: float = 600.0) -> bool:
        """Wait until every queued warmup completed (tests/shutdown);
        True when drained, False on timeout."""
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with _CACHE_LOCK:
                idle = not self._pending
            if idle and self._q.empty():
                return True
            time.sleep(0.01)
        return False


_WARMER = _Warmer()


def mark_serve_process() -> None:
    """Called by long-lived serve loops: at-exit waits for an in-flight
    background compile with the long (serve) default bound, because the
    compiled bucket would be reused; one-shot CLI runs keep a short bound."""
    _WARMER.long_lived = True


def warm_bucket_async(tables: ScoringTables, b: int, l1k: int, l2p: int,
                      interpret: bool | None = None, k: int | None = None,
                      mesh: Mesh | None = None,
                      shared_s1: bool = False) -> bool:
    """Queue a background compile of one bucket runner (dedup by key);
    True if newly queued."""
    interpret = resolve_interpret(interpret)
    if k is None:
        k = TOPK
    if mesh is None:
        key = _fused_runner_key(tables, b, l1k, l2p, bool(interpret), k,
                                shared_s1)
    else:
        key = _sharded_runner_key(tables, b, l1k, l2p, mesh, bool(interpret),
                                  k, shared_s1)
    return _WARMER.submit(
        key, lambda: warm_fused_runner(tables, b, l1k, l2p, interpret, k,
                                       mesh, shared_s1))


def warmup_join(timeout: float = 600.0) -> bool:
    """Block until background warmups drain (True) or timeout (False)."""
    return _WARMER.join(timeout)


TOPK = 32


def f32_band_epsilon(tables: ScoringTables, l2p: int) -> float:
    """Bound on |f32 keyed total - exact f64 total| for the in-graph ranking.

    counts <= l2p, weights/diffs bounded; the f32 dot performs ~6 roundings
    on values bounded by S = l2p*max|w| + max|diff|; 16x is headroom.  Any
    offset whose exact total ties the exact best lies within this band of
    the f32 best, so top-k + band-count makes the device ranking *checkably*
    exact: if more than k candidates fall in the band the host falls back.
    """
    max_w = float(np.max(np.abs(tables.w_signed)))
    max_d = float(np.max(np.abs(tables.diff_vals))) if tables.diff_vals.size else 0.0
    s = l2p * max_w + max_d
    return 16.0 * np.float32(np.finfo(np.float32).eps) * max(s, 1.0)


# Fixed operand length for the rank->diff table in the weights-generic
# runners: distinct diff values are bounded by the 29x29 pair table
# (<= 841), so every possible tables.diff_vals fits.  +1 slot preserves the
# empty-diff_vals gather (see keyed_f32_totals_ops).
NUM_RANKS_PAD = 896

_WOP_CACHE: dict = {}


def weights_operands(tables: ScoringTables):
    """The weight-dependent tables as fixed-shape runtime operands for the
    weights-generic runners: (code (32,32) int8, w32 (4,) f32,
    diff32 (NUM_RANKS_PAD+1,) f32 zero-padded).  Cached per (weights, mode)
    so repeat dispatches reuse the same arrays (and device transfers can be
    deduped by the runtime)."""
    key = (tuple(tables.weights.tolist()), tables.is_max)
    with _CACHE_LOCK:
        # locked like every other shared cache here: the serve loop, the
        # Finisher, and the background warmer all call this concurrently —
        # an unlocked get/clear/set could drop a just-inserted entry
        ops = _WOP_CACHE.get(key)
        if ops is not None:
            return ops
    diff32 = np.zeros(NUM_RANKS_PAD + 1, np.float32)
    nd = tables.diff_vals.size
    assert nd <= NUM_RANKS_PAD, nd
    diff32[:nd] = tables.diff_vals.astype(np.float32)
    ops = (np.asarray(tables.code), tables.w_signed.astype(np.float32),
           diff32)
    with _CACHE_LOCK:
        if len(_WOP_CACHE) > 4 * _RUNNER_CACHE_CAP:
            _WOP_CACHE.clear()       # unbounded weight diversity guard
        _WOP_CACHE[key] = ops
    return ops


def exact_topk_epilogue_rows_ops(stats5, w32, diff32, is_max: bool, noff,
                                 eps, k: int = TOPK):
    """`exact_topk_epilogue_rows` with the weight-dependent inputs as
    VALUES (w32/diff32 per keyed_f32_totals_ops; eps the f32 near-tie band
    half-width, a scalar operand) — the epilogue of the weights-generic
    runners."""
    from psa.ops.common import keyed_f32_totals_ops

    keyed, _ = keyed_f32_totals_ops(stats5[..., :4, :], stats5[..., 4, :],
                                    w32, diff32, is_max, noff,
                                    counts_axis=-2)
    best = jnp.max(keyed, axis=-1)
    near = jnp.sum(keyed >= best[..., None] - eps, axis=-1)
    _, topi = jax.lax.top_k(keyed, k)
    stats_k = jnp.take_along_axis(stats5, topi[..., None, :], axis=-1)
    return topi.astype(jnp.int32), stats_k, near, best


def exact_topk_epilogue_rows(stats5, tables: ScoringTables, noff, l2p: int,
                             k: int = TOPK):
    """Rows-layout checkable-exact epilogue (jittable, natively batched).

    stats5: (..., 5, NP) int32 — rows 0-3 class counts, row 4 maxrank, with
    the offset axis minor (the sweep kernel's output layout).

    Ranks by f32 keyed totals but returns the top-k candidates WITH their
    exact integer stats plus the f32 near-tie band population `near` — the
    host re-scores the candidates exactly and can DETECT (near > k) when
    the f32 ranking was insufficient, so no winner ever depends on f32
    rounding.  Returns (topi (..., k), stats_k (..., 5, k), near, best).
    """
    _, w32, diff32 = weights_operands(tables)
    return exact_topk_epilogue_rows_ops(
        stats5, w32, diff32, tables.is_max, noff,
        np.float32(f32_band_epsilon(tables, l2p)), k)


def epilogue_compact(noff_pad: int, l2p: int) -> bool:
    """True when the int16-pair epilogue packing is sound for a bucket:
    every packed value (top-k offsets < noff_pad, class counts <= l2p,
    maxrank in [-1, 255]) must fit a signed int16.  Static per compiled
    runner, so the packer and the host unpacker always agree."""
    return noff_pad < 32768 and l2p < 32768


def pack_epilogue_outputs(topi, stats_k, near, best, compact: bool = False):
    """Pack the epilogue outputs into ONE int32 array (B, 6k+2), or
    (B, 3k+2) with compact=True.

    One packed array = one device-to-host fetch, and compact mode halves
    the candidate block by packing int16 PAIRS per word (sound under
    `epilogue_compact`'s static gate).  Layout per row:
    [topi(k | k/2) | stats5(5k | 5k/2) | near | best_bits_f32].
    """
    b, k = topi.shape
    near_best = [near[:, None].astype(jnp.int32),
                 jax.lax.bitcast_convert_type(best.astype(jnp.float32),
                                              jnp.int32)[:, None]]
    if not compact:
        return jnp.concatenate(
            [topi, stats_k.reshape(b, 5 * k), *near_best], axis=1)
    assert k % 2 == 0

    def pk16(x):           # adjacent int16-range values -> one word each 2
        return (x[:, 0::2] & 0xFFFF) | (x[:, 1::2] << 16)

    return jnp.concatenate(
        [pk16(topi), pk16(stats_k.reshape(b, 5 * k)), *near_best], axis=1)


def unpack_epilogue_outputs(buf: np.ndarray, k: int, compact: bool = False):
    """Host-side inverse of `pack_epilogue_outputs` (numpy)."""
    if not compact:
        topi = buf[:, :k]
        stats_k = buf[:, k:6 * k].reshape(buf.shape[0], 5, k)
        near = buf[:, 6 * k]
        best = buf[:, 6 * k + 1].view(np.float32)
        return topi, stats_k, near, best

    def unpk16(words, n):  # little-endian int16 view restores pair order
        h = np.ascontiguousarray(words).view(np.int16)
        return h.reshape(words.shape[0], n).astype(np.int32)

    topi = unpk16(buf[:, : k // 2], k)
    stats_k = unpk16(buf[:, k // 2: 3 * k], 5 * k).reshape(
        buf.shape[0], 5, k)
    near = buf[:, 3 * k]
    best = buf[:, 3 * k + 1].view(np.float32)
    return topi, stats_k, near, best


_PACK = 6                 # codes per int32 word: 5 bits each (codes <= 28)


def _packed_words(n: int) -> int:
    return (n + _PACK - 1) // _PACK


def pack_code_rows(codes) -> np.ndarray:
    """(B, n) codes -> (B, ceil(n/6)) int32 words, 5 bits per code (host).

    THE upload wire format, shared by every path that ships sequences to
    the device (batch microbatches, the sharded single-query search)."""
    from psa.core.alphabet import PAD_CODE

    codes = np.asarray(codes)
    if codes.ndim == 2:
        try:
            from psa import native

            if native.available():
                # one C pass (codes are <= 28, so the int8 cast is exact);
                # the numpy shift/OR ladder was ~5 ms of the measured host
                # cost per 1024-query serve chunk
                return native.pack5_native(codes)
        except Exception:  # noqa: BLE001 - fast path is optional
            pass
    n = codes.shape[1]
    w = _packed_words(n)
    if w * _PACK != n:
        codes = np.pad(codes, ((0, 0), (0, w * _PACK - n)),
                       constant_values=PAD_CODE)
    out = codes[:, 0::_PACK].astype(np.int32)   # word i holds codes
    for j in range(1, _PACK):                   # [6i .. 6i+5]
        out |= codes[:, j::_PACK].astype(np.int32) << (5 * j)
    return out


def unpack_code_rows(words, n: int):
    """In-graph inverse of `pack_code_rows`: (B, w) words -> (B, n) int32."""
    parts = [jax.lax.shift_right_logical(words, 5 * j) & 31
             for j in range(_PACK)]
    full = jnp.stack(parts, axis=-1).reshape(words.shape[0], -1)
    return full[:, :n]


def pack_query_inputs(c1b, c2b, noffs) -> np.ndarray:
    """Pack a batch's inputs into ONE (B, w1 + w2 + 1) int32 array (host).

    Wire-size discipline: one host-to-device transfer per microbatch, and
    the fewest bytes per query.  Codes are <= 28 < 32, so 6 codes pack
    into one int32 at 5 bits each — 0.67 B/char on the wire instead of 1
    (int8) or 4 (raw int32).
    Layout per row: [c1 words (w1) | c2 words (w2) | noff].
    """
    b = np.asarray(c1b).shape[0]
    return np.concatenate(
        [pack_code_rows(c1b), pack_code_rows(c2b),
         np.asarray(noffs, np.int32).reshape(b, 1)], axis=1)


def unpack_query_inputs(inbuf, l1k: int, l2p: int):
    """In-graph inverse of `pack_query_inputs` (jittable shifts + masks)."""
    w1 = _packed_words(l1k)
    w2 = _packed_words(l2p)
    c1b = unpack_code_rows(inbuf[:, :w1], l1k)
    c2b = unpack_code_rows(inbuf[:, w1:w1 + w2], l2p)
    return c1b, c2b, inbuf[:, w1 + w2]


def pack_query_inputs_shared(c1_row, c2b, noffs):
    """Shared-Seq1 wire format: (inbuf (B, w2+1), c1w (w1,)) int32.

    The realistic serving pattern is many Seq2 reads against ONE Seq1
    reference; per-query Seq1 upload (1712 B at 2048x512) dominates the
    host-to-device bytes.  When every row of a microbatch shares Seq1, it
    ships once and every query's kernel program reads that one row: the
    upload drops from ~2.1 KB to ~0.7 KB per query.  Layout: inbuf row = [c2 words | noff]; c1w = the
    shared row's 5-bit code words."""
    b = np.asarray(c2b).shape[0]
    inbuf = np.concatenate(
        [pack_code_rows(c2b),
         np.asarray(noffs, np.int32).reshape(b, 1)], axis=1)
    return inbuf, pack_code_rows(np.asarray(c1_row)[None])[0]


def unpack_query_inputs_shared_row(inbuf, c1w, l1k: int, l2p: int):
    """In-graph inverse of `pack_query_inputs_shared` keeping Seq1 as the
    ONE uploaded row -> (c1_row (l1k,), c2b (B, l2p), noffs (B,)) — the
    shared-s1 runners feed the row straight to the dedup kernel, which
    never materializes B copies."""
    w2 = _packed_words(l2p)
    c2b = unpack_code_rows(inbuf[:, :w2], l2p)
    c1_row = unpack_code_rows(c1w[None], l1k)[0]
    return c1_row, c2b, inbuf[:, w2]


def make_batched_fused_runner(tables: ScoringTables, b: int, l1k: int,
                              l2p: int, interpret: bool, k: int = TOPK,
                              shared_s1: bool = False):
    """Single-kernel batch runner: the whole batch is one sweep-kernel grid
    (ops/pallas_sweep.sweep_stats5), then a batched checkable-exact top-k
    epilogue.  A single query is a batch of one.

    WEIGHTS-GENERIC: the compiled program is keyed on (mode, B, shapes)
    only — the code table, signed weights, rank-diff table, and near-tie
    epsilon are runtime operands (~5 KB per dispatch), so a query with
    never-seen weights on a known shape bucket costs ZERO compiles.  Cold
    buckets (the serving-tail hazard) arise only from new SHAPES.

    shared_s1=True selects the dedup-Seq1 wire variant: the runner takes
    (inbuf (B, w2+1), c1w (w1,)) — ONE uploaded Seq1 row that every
    query's kernel program reads — cutting per-query wire bytes ~3x for the
    many-reads-vs-one-reference serving pattern (see
    pack_query_inputs_shared).
    """
    key = _fused_runner_key(tables, b, l1k, l2p, interpret, k, shared_s1)
    run = _cache_get(_EXACT_RUNNERS, key)
    if run is None:
        import jax

        compact = epilogue_compact(l1k - l2p, l2p)
        is_max = tables.is_max

        def _pack(stats5, noffs, w32, diff32, eps):
            return pack_epilogue_outputs(
                *exact_topk_epilogue_rows_ops(stats5, w32, diff32, is_max,
                                              noffs, eps, k),
                compact)

        if shared_s1:
            @jax.jit
            def generic(inbuf, c1w, code_tab, w32, diff32, eps):
                # the one Seq1 row goes straight to the kernel — never
                # broadcast to (B, l1k)
                c1_row, c2b, noffs = unpack_query_inputs_shared_row(
                    inbuf, c1w, l1k, l2p)
                stats5 = _stats5(c1_row[None], c2b, code_tab, interpret)
                return _pack(stats5, noffs, w32, diff32, eps)
        else:
            @jax.jit
            def generic(inbuf, code_tab, w32, diff32, eps):
                c1b, c2b, noffs = unpack_query_inputs(inbuf, l1k, l2p)
                stats5 = _stats5(c1b, c2b, code_tab, interpret)
                return _pack(stats5, noffs, w32, diff32, eps)

        run = _cache_put(_EXACT_RUNNERS, key,
                         _mark_warm_after_first(generic, key))

    code_tab, w32, diff32 = weights_operands(tables)
    eps = np.float32(f32_band_epsilon(tables, l2p))
    if shared_s1:
        return lambda inbuf, c1w: run(inbuf, c1w, code_tab, w32, diff32,
                                      eps)
    return lambda inbuf: run(inbuf, code_tab, w32, diff32, eps)


def make_batched_fused_sharded_runner(tables: ScoringTables, b: int,
                                      l1k: int, l2p: int, mesh: Mesh,
                                      interpret: bool, k: int = TOPK,
                                      shared_s1: bool = False):
    """Mesh-data-parallel exact batch runner.

    The GLOBAL batch of b queries shards over the mesh's first axis; each
    device runs the fused whole-batch kernel + checkable-exact top-k
    epilogue on its b/ndev local queries — the serving analog of the
    reference's contiguous MPI offset blocks (cpu_funcs.c:128-133) with
    queries as the sharded axis.  Queries are independent, so there are NO
    collectives: the packed per-query outputs come back batch-sharded and
    the exact host selection is unchanged.

    Weights-generic like `make_batched_fused_runner`: the weight tables are
    replicated runtime operands, so the compiled shard_map program is keyed
    on (mode, batch, shapes, mesh) only.  shared_s1=True additionally
    ships ONE Seq1 row (replicated operand) instead of B copies — every
    local query's kernel program reads it.
    """
    axis = mesh.axis_names[0]
    ndev = mesh.devices.size
    key = _sharded_runner_key(tables, b, l1k, l2p, mesh, interpret, k,
                              shared_s1)
    run = _cache_get(_EXACT_RUNNERS, key)
    if run is None:
        assert b % ndev == 0, (b, ndev)
        compact = epilogue_compact(l1k - l2p, l2p)
        is_max = tables.is_max

        def _local_pack(stats5, noffs, w32, diff32, eps):
            return pack_epilogue_outputs(
                *exact_topk_epilogue_rows_ops(stats5, w32, diff32, is_max,
                                              noffs, eps, k),
                compact)

        if shared_s1:
            def local(inbuf, c1w, code_tab, w32, diff32, eps):
                # inbuf = [c2 words | noff] sharded on the batch axis; the
                # one Seq1 row is replicated
                c1_row, c2b, noffs = unpack_query_inputs_shared_row(
                    inbuf, c1w, l1k, l2p)
                stats5 = _stats5(c1_row[None], c2b, code_tab, interpret)
                return _local_pack(stats5, noffs, w32, diff32, eps)

            in_specs = (P(axis), P(), P(), P(), P(), P())
        else:
            def local(inbuf, code_tab, w32, diff32, eps):
                # ONE packed upload (5-bit code words + noff,
                # pack_query_inputs), sharded on the batch axis; unpacked
                # in-graph per shard; weight operands replicated
                c1b, c2b, noffs = unpack_query_inputs(inbuf, l1k, l2p)
                stats5 = _stats5(c1b, c2b, code_tab, interpret)
                return _local_pack(stats5, noffs, w32, diff32, eps)

            in_specs = (P(axis), P(), P(), P(), P())

        fn = jax.jit(shard_map(local, mesh=mesh,
                               in_specs=in_specs,
                               out_specs=P(axis),
                               check_vma=False))  # pallas_call: no vma
        run = _cache_put(_EXACT_RUNNERS, key,
                         _mark_warm_after_first(fn, key))

    code_tab, w32, diff32 = weights_operands(tables)
    eps = np.float32(f32_band_epsilon(tables, l2p))
    if shared_s1:
        return lambda inbuf, c1w: run(inbuf, c1w, code_tab, w32, diff32,
                                      np.asarray(eps))
    return lambda inbuf: run(inbuf, code_tab, w32, diff32,
                             np.asarray(eps))


def batched_search_exact_sharded_async(c1b, c2b, noffs, n2s,
                                       tables: ScoringTables, mesh: Mesh,
                                       interpret: bool | None = None,
                                       k: int = TOPK,
                                       micro_b: int | None = None,
                                       shared_s1: bool | None = None):
    """Async `batched_search_exact_sharded`: every microbatch dispatches up
    front, (handles, finish) returns — see `_dispatch_all_spans`.

    shared_s1 (None = auto-detect by row equality): ship the one shared
    Seq1 row as a replicated operand instead of B copies on the sharded
    batch axis — bit-identical either way."""
    interpret = resolve_interpret(interpret)
    c1b = np.asarray(c1b)
    c2b = np.asarray(c2b)
    noffs = np.asarray(noffs)
    n2s = np.asarray(n2s)
    b_n, l1k = c1b.shape
    l2p = c2b.shape[1]
    ndev = mesh.devices.size

    from psa.config import CONFIG

    mb = int(micro_b) if micro_b else CONFIG.micro_batch
    if shared_s1 is None:
        shared_s1 = bool((c1b == c1b[:1]).all())
    shared_s1 = bool(shared_s1 and b_n > 1)
    c1w_shared = (jnp.asarray(pack_code_rows(c1b[:1])[0]) if shared_s1
                  else None)
    results: list = [None] * b_n

    def dispatch(s: int, e: int):
        per = _round_batch(-(-(e - s) // ndev), mb)
        p1, p2, pn = _pad_batch_rows(c1b[s:e], c2b[s:e], noffs[s:e],
                                     per * ndev)
        run = make_batched_fused_sharded_runner(tables, per * ndev, l1k,
                                                l2p, mesh, bool(interpret),
                                                k, shared_s1=shared_s1)
        if shared_s1:
            inbuf, _ = pack_query_inputs_shared(c1b[0], p2, pn)
            return run(jnp.asarray(inbuf), c1w_shared)
        return run(jnp.asarray(pack_query_inputs(p1, p2, pn)))

    return _dispatch_all_spans(
        microbatch_spans(b_n, mb * ndev), dispatch,
        _make_finisher(results, c1b, c2b, noffs, n2s, tables, k), results)


def batched_search_exact_sharded(c1b, c2b, noffs, n2s,
                                 tables: ScoringTables, mesh: Mesh,
                                 interpret: bool | None = None,
                                 k: int = TOPK, micro_b: int | None = None,
                                 shared_s1: bool | None = None):
    """Bit-exact batched search with the batch axis sharded over a mesh.

    Same contract as `batched_search_exact` (list of SearchResult | None,
    reference-sequential winner semantics), but each mesh device sweeps an
    equal contiguous block of queries.  Like the non-sharded path, the
    workload streams through fixed-size microbatches (per-shard count
    power-of-two-padded up to config `micro_batch`, dummy all-PAD rows
    sliced off), all dispatched up front — one compiled program serves any
    workload size and each microbatch is ONE packed upload.
    """
    _, finish = batched_search_exact_sharded_async(
        c1b, c2b, noffs, n2s, tables, mesh, interpret, k, micro_b,
        shared_s1)
    return finish()


def microbatch_spans(b_n: int, mb: int) -> list:
    """Contiguous [start, end) spans covering [0, b_n) in steps of mb —
    the batched_search_exact pipeline's work partition."""
    return [(s, min(s + mb, b_n)) for s in range(0, b_n, mb)]


def _pad_batch_rows(p1, p2, pn, bpad: int):
    """Pad a microbatch with all-PAD dummy rows up to `bpad` queries.

    Dummy rows report no-mutation (maxrank -1 everywhere) and are sliced
    off in the finish stage; noff=1 keeps their sweep trivial."""
    n = p1.shape[0]
    if bpad == n:
        return p1, p2, pn
    from psa.core.alphabet import PAD_CODE

    p1 = np.concatenate(
        [p1, np.full((bpad - n, p1.shape[1]), PAD_CODE, p1.dtype)])
    p2 = np.concatenate(
        [p2, np.full((bpad - n, p2.shape[1]), PAD_CODE, p2.dtype)])
    pn = np.concatenate([pn, np.ones(bpad - n, pn.dtype)])
    return p1, p2, pn


_DISPATCH_WINDOW = 8


def _dispatch_all_spans(spans, dispatch, finish_one, results):
    """Dispatch microbatches ahead of the fetches, windowed.

    Uploads and device programs enqueue asynchronously (each dispatch is
    one packed upload + one program), so the device works through the
    stream back to back while `finish()` fetches + host-selects in order —
    host selection of batch i overlaps device compute of batches i+1.. .
    At most `_DISPATCH_WINDOW` microbatches are in flight (+1 transiently:
    the refill dispatches BEFORE blocking on the oldest fetch, so the new
    upload overlaps it): every enqueued input/output buffer stays alive
    until its program runs, so dispatching an UNBOUNDED workload up front
    would hold O(workload) device memory (a ~4M-query serve file is ~10 GB
    of simultaneously-live buffers); the window keeps it O(1) while still
    hiding dispatch latency.
    Returns (handles, finish): `handles` are the currently in-flight packed
    device outputs (pollable via `h.is_ready()` — the serving tier keeps
    draining client I/O while the device computes), `finish()` blocks and
    returns the completed results list."""
    spans = list(spans)
    pending = [((s, e), dispatch(s, e))
               for s, e in spans[:_DISPATCH_WINDOW]]

    def finish():
        nxt = len(pending)
        while pending:
            span, dev = pending.pop(0)
            if nxt < len(spans):            # refill the window first: the
                s, e = spans[nxt]           # new dispatch overlaps this
                pending.append((spans[nxt], dispatch(s, e)))  # fetch
                nxt += 1
            finish_one(span, dev)
        return results

    return [dev for _, dev in pending], finish


def _make_finisher(results: list, c1b, c2b, noffs, n2s,
                   tables: ScoringTables, k: int):
    """Shared finish stage: unpack one microbatch's packed device output
    and run the exact host selection into `results`."""
    compact = epilogue_compact(c1b.shape[1] - c2b.shape[1], c2b.shape[1])

    def finish(span, dev_out):
        s, e = span
        buf = np.asarray(dev_out)[: e - s]
        topi, stats_k, near, best = unpack_epilogue_outputs(buf, k, compact)
        stats_k = np.swapaxes(stats_k, 1, 2)   # (n, 5, k) -> (n, k, 5)
        results[s:e] = _host_select(c1b[s:e], c2b[s:e], noffs[s:e],
                                    n2s[s:e], tables, topi, stats_k, near,
                                    best, k)

    return finish


def _round_batch(n: int, cap: int) -> int:
    """Next power of two >= n, capped (so one compiled program per size
    bucket, not one per workload size).  Starts at 1: dummy rows are NOT
    free — each one sweeps its full padded shape, which for an oversized
    single query (a batch of one) would multiply device time."""
    r = 1
    while r < n:
        r *= 2
    return max(min(r, cap), n)


def batched_search_exact_async(c1b, c2b, noffs, n2s, tables: ScoringTables,
                               interpret: bool | None = None, k: int = TOPK,
                               micro_b: int | None = None,
                               shared_s1: bool | None = None):
    """Async `batched_search_exact`: every microbatch dispatches up front,
    (handles, finish) returns — see `_dispatch_all_spans`.

    shared_s1: use the dedup-Seq1 wire variant (Seq1 ships once per
    microbatch, broadcast on device — ~3x fewer upload bytes for the
    many-reads-vs-one-reference pattern).  None = auto-detect by row
    equality; results are bit-identical either way."""
    import jax

    from psa.config import CONFIG

    interpret = resolve_interpret(interpret)
    c1b = np.asarray(c1b)
    c2b = np.asarray(c2b)
    noffs = np.asarray(noffs)
    n2s = np.asarray(n2s)
    b_n, l1k = c1b.shape
    l2p = c2b.shape[1]
    mb = int(micro_b) if micro_b else CONFIG.micro_batch
    if shared_s1 is None:
        shared_s1 = bool((c1b == c1b[:1]).all())
    shared_s1 = bool(shared_s1 and b_n > 1)
    c1w_shared = (jnp.asarray(pack_code_rows(c1b[:1])[0]) if shared_s1
                  else None)
    results: list = [None] * b_n

    def dispatch(s: int, e: int):
        bpad = _round_batch(e - s, mb)
        p1, p2, pn = _pad_batch_rows(c1b[s:e], c2b[s:e], noffs[s:e], bpad)
        if shared_s1:
            # dummy pad rows share the real Seq1: their all-PAD c2 makes
            # every pair code inert (-> no-mutation), and they're sliced
            # off in finish regardless
            run = make_batched_fused_runner(tables, bpad, l1k, l2p,
                                            bool(interpret), k,
                                            shared_s1=True)
            inbuf, _ = pack_query_inputs_shared(c1b[0], p2, pn)
            return run(jnp.asarray(inbuf), c1w_shared)
        run = make_batched_fused_runner(tables, bpad, l1k, l2p,
                                        bool(interpret), k)
        # ONE packed upload (5-bit code words) + async dispatch; the output
        # is fetched later in the finish stage
        return run(jnp.asarray(pack_query_inputs(p1, p2, pn)))

    return _dispatch_all_spans(
        microbatch_spans(b_n, mb), dispatch,
        _make_finisher(results, c1b, c2b, noffs, n2s, tables, k), results)


def batched_search_exact(c1b, c2b, noffs, n2s, tables: ScoringTables,
                         interpret: bool | None = None, k: int = TOPK,
                         micro_b: int | None = None,
                         shared_s1: bool | None = None):
    """Bit-exact batched search: device top-k candidates -> host sequential
    re-scoring (same machinery as the single-query path, ops/select.py).

    Queries stream through the device in fixed-size microbatches (config
    `micro_batch`, padded up to a power of two), all dispatched before the
    first fetch, so host-side selection of batch i overlaps device compute
    of batches i+1.. and one compiled program serves any workload size.

    Returns a list of SearchResult | None (None = no mutation exists, the
    defined behavior for the reference's UB path, SURVEY.md Q3).  Queries
    whose f32 near-tie band exceeds k fall back to the exact single-query
    numpy path — rare (requires >k offsets within ~1e-5 of the best), and
    correctness never depends on the f32 ranking.
    """
    _, finish = batched_search_exact_async(c1b, c2b, noffs, n2s, tables,
                                           interpret, k, micro_b,
                                           shared_s1)
    return finish()


def _host_select(c1b, c2b, noffs, n2s, tables: ScoringTables, topi,
                 stats_k, near, best, k: int) -> list:
    """Bit-exact host selection for one microbatch -> list of results."""
    from psa.core.oracle import offset_stats_numpy
    from psa.core.result import NoMutationFound
    from psa.models.search import native_available
    from psa.ops.select import (candidate_epsilon, pick_from_candidates,
                                    select_best, totals_from_stats)

    b_n = c1b.shape[0]
    results: list = [None] * b_n
    nomut = np.isneginf(best)
    fallback = (~nomut) & (near > k)
    main = (~nomut) & (~fallback)

    if main.any():
        if native_available():
            _select_rows_vectorized(results, np.nonzero(main)[0], c1b, c2b,
                                    noffs, n2s, tables, topi, stats_k)
        else:
            for q in np.nonzero(main)[0]:
                noff, n2 = int(noffs[q]), int(n2s[q])
                c1 = c1b[q][: noff + n2 - 1]
                c2 = c2b[q][: n2]
                idx = topi[q]
                st = stats_k[q]
                keep = (idx < noff) & (st[:, 4] >= 0)
                idx, st = idx[keep], st[keep]
                order = np.argsort(idx, kind="stable")
                idx, st = idx[order], st[order]
                totals = totals_from_stats(st[:, :4], st[:, 4], tables)
                bq = totals.max() if tables.is_max else totals.min()
                cand = idx[np.abs(totals - bq) <= candidate_epsilon(tables, n2)]
                results[q] = pick_from_candidates(c1, c2, tables, cand)

    for q in np.nonzero(fallback)[0]:
        # rare exact fallback (>k offsets inside the f32 band): full host
        # stats; native engine when available (numpy is minutes at 1M-char
        # scale)
        noff, n2 = int(noffs[q]), int(n2s[q])
        c1 = c1b[q][: noff + n2 - 1]
        c2 = c2b[q][: n2]
        if native_available():
            from psa.native import offset_stats_native

            counts, maxrank = offset_stats_native(c1, c2, tables)
        else:
            counts, maxrank = offset_stats_numpy(c1, c2, tables)
        try:
            results[q] = select_best(counts, maxrank, tables, c1, c2)
        except NoMutationFound:
            results[q] = None
    return results


def _select_rows_vectorized(results: list, rows: np.ndarray, c1b, c2b,
                            noffs, n2s, tables: ScoringTables, topi,
                            stats_k):
    """Bit-exact winner selection for many queries with NO per-query Python.

    Same semantics as the per-query loop (totals -> epsilon band ->
    sequential re-score in ascending offset order -> first bit-equal best),
    but all numpy ops run on (rows, k) blocks and ALL candidates cross into
    the native re-scorer in one ctypes call (psa_rescore_multi) — the
    per-query overhead was ~190us/query, ~44% of exact batch wall time at
    B=1000.
    """
    from psa.core.result import SearchResult
    from psa.native import rescore_multi_native

    idx = topi[rows]                                       # (R, k)
    st = stats_k[rows]                                     # (R, k, 5)
    r_n, k = idx.shape
    valid = (idx < noffs[rows][:, None]) & (st[:, :, 4] >= 0)
    score = tables.score_from_counts(
        st[:, :, :4].reshape(-1, 4)).reshape(r_n, k)
    badv = -np.inf if tables.is_max else np.inf
    mr = st[:, :, 4]
    diffv = np.where(mr >= 0, tables.diff_vals[np.clip(mr, 0, None)], badv)
    totals = np.where(valid, score + diffv, badv)
    bq = totals.max(axis=1) if tables.is_max else totals.min(axis=1)

    from psa.ops.select import candidate_epsilon

    eps = candidate_epsilon(tables, n2s[rows])       # (R,) vectorized
    cmask = valid & (np.abs(totals - bq[:, None]) <= eps[:, None])

    ri, ci = np.nonzero(cmask)
    offs = idx[ri, ci].astype(np.int64)
    # group by query, ascending offsets within each group (the first
    # bit-equal best in this order is the is_swapable winner)
    order = np.lexsort((offs, ri))
    ri, offs = ri[order], offs[order]
    qidx = rows[ri].astype(np.int32)

    totals_seq, coffs, subs = rescore_multi_native(
        c1b, c2b, np.asarray(n2s, np.int32), tables, qidx, offs)
    ok = coffs >= 0
    totals_seq = np.where(ok, totals_seq, badv)

    # per-group winner: best total, first occurrence in ascending order
    starts = np.nonzero(np.r_[True, ri[1:] != ri[:-1]])[0]
    red = np.maximum if tables.is_max else np.minimum
    gbest = red.reduceat(totals_seq, starts)
    hit_pos = np.where(totals_seq == np.repeat(gbest, np.diff(
        np.r_[starts, ri.shape[0]])), np.arange(ri.shape[0]), ri.shape[0])
    win = np.minimum.reduceat(hit_pos, starts)
    for g, w in enumerate(win):
        q = int(rows[ri[starts[g]]])
        if not np.isfinite(gbest[g]):
            continue
        results[q] = SearchResult(offset=int(offs[w]),
                                  char_offset=int(coffs[w]),
                                  sub_code=int(subs[w]),
                                  score=float(totals_seq[w]))


def search_batch(queries, backend: str = "auto",
                 strict_alphabet: bool = True, mesh: Mesh | None = None):
    """Mixed-size multi-query search with bucketed padding.

    Queries (utils.io.Query) are grouped by (weights, mode, noff_pad, l2p)
    — the static-shape buckets of plan_shapes — and each bucket runs as ONE
    batched device scan (bit-exact selection via batched_search_exact) when
    the accelerator path pays off, else as a host-engine loop.  Results come
    back in input order; None marks a query with no legal mutation.

    mesh: optional 1-D device mesh — device buckets then shard their batch
    axis across it (batched_search_exact_sharded) instead of running
    single-device.
    """
    return _search_batch_impl(queries, backend, strict_alphabet, mesh,
                              defer=False)[1]()


def search_batch_async(queries, backend: str = "auto",
                       strict_alphabet: bool = True,
                       mesh: Mesh | None = None, cold_route: bool = False):
    """Async `search_batch` for the serving tier.

    Device buckets dispatch immediately (one packed upload + enqueued
    program per microbatch) and (handles, finish) returns: the caller keeps
    servicing client I/O while the device computes — `handles` are the
    in-flight packed device outputs, pollable via `h.is_ready()` — then
    `finish()` completes the fetches, the exact host selection, and any
    host-engine buckets, returning the results list (input order, None =
    no legal mutation).  A device failure at dispatch or fetch time
    raises; no bucket silently changes engine.

    cold_route=True additionally routes any bucket whose device runner is
    not yet COMPILED to the host engine for this call while a background
    thread compiles it (warm_bucket_async) — a reply must never wait out a
    compile.  Every such reply is still exact.  Subsequent calls hit the
    warm runner.
    """
    return _search_batch_impl(queries, backend, strict_alphabet, mesh,
                              defer=True, cold_route=cold_route)


def _host_engine_bucket(queries, idxs, results: list, w, is_max,
                        host_backend: str, strict_alphabet: bool) -> None:
    """Run one bucket on a host engine (one engine per bucket: the bucket
    key guarantees shared (weights, mode))."""
    from psa.core.result import NoMutationFound
    from psa.models.search import AlignmentSearchEngine

    eng = AlignmentSearchEngine(np.asarray(w), is_max, backend=host_backend,
                                strict_alphabet=strict_alphabet)
    for i in idxs:
        q = queries[i]
        try:
            results[i] = eng.search(q.seq1, q.seq2)
        except NoMutationFound:
            results[i] = None


def _search_batch_impl(queries, backend: str, strict_alphabet: bool,
                       mesh: Mesh | None, defer: bool,
                       cold_route: bool = False):
    """Shared body of search_batch / search_batch_async -> (handles, finish)."""
    from psa.core.alphabet import encode_batch_padded, validate_batch
    from psa.core.tables import build_tables_cached
    from psa.ops.common import plan_shapes

    if backend == "hybrid":
        # the hybrid split applies to ONE query's offset range
        # (cpu_funcs.c:144-150); batch throughput comes from the query axis
        raise ValueError("the hybrid backend applies to single-query "
                         "searches only — use backend='auto' or 'pallas' "
                         "for batches")
    results: list = [None] * len(queries)
    if strict_alphabet and queries:
        # one vectorized pass over the whole batch (per-query validate
        # overhead was a measurable share of serve host time)
        ok = (validate_batch([q.seq1 for q in queries])
              & validate_batch([q.seq2 for q in queries]))
        if not ok.all():
            from psa.core.alphabet import ALPHABET_ERROR

            raise ValueError(f"case {int(np.argmin(ok))}: {ALPHABET_ERROR}")
    buckets: dict = {}
    for i, q in enumerate(queries):
        _, noff_pad, l2p, l1k = plan_shapes(len(q.seq1), len(q.seq2))
        key = (tuple(float(w) for w in q.weights), q.is_max, l1k, l2p)
        buckets.setdefault(key, []).append(i)

    handles: list = []
    finishers: list = []
    for (w, is_max, l1k, l2p), idxs in buckets.items():
        if backend == "auto":
            # workload-aware per bucket, like the single-query crossover
            # (cpu_funcs.c:135-142): a small bucket is not worth a device
            # compile — run it on the host engine; the platform is checked
            # AFTER the threshold so small buckets never initialize JAX
            from psa.config import CONFIG
            from psa.ops.device import accelerator_present

            total_pe = sum(
                (len(queries[i].seq1) - len(queries[i].seq2) + 1)
                * len(queries[i].seq2) for i in idxs)
            use_device = (total_pe >= CONFIG.auto_threshold
                          and accelerator_present())
        else:
            use_device = backend == "pallas"
        # dedup-Seq1 wire variant when the whole bucket shares one Seq1
        # (the many-reads-vs-one-reference pattern); string equality
        # guarantees identical encoded rows, so the key prediction below
        # and the dispatcher's choice can't diverge
        s1_0 = queries[idxs[0]].seq1
        shared_s1 = (len(idxs) > 1
                     and all(queries[i].seq1 == s1_0 for i in idxs[1:]))
        if use_device and cold_route:
            # never block replies on a compile: a bucket whose runner is
            # not built yet answers from the host engine THIS call while
            # the single background warmer compiles it
            tables_cr = build_tables_cached(np.asarray(w), is_max)
            missing = [kk for kk in planned_runner_keys(
                tables_cr, len(idxs), l1k, l2p, mesh=mesh,
                shared_s1=shared_s1)
                if not runner_is_warm(kk)]
            if missing:
                for kk in missing:
                    warm_bucket_async(tables_cr, runner_key_batch(kk), l1k,
                                      l2p, mesh=mesh,
                                      shared_s1=kk[0].endswith("s1"))
                use_device = False
                with _CACHE_LOCK:
                    _COLD_ROUTED[0] += len(idxs)
        if use_device:
            tables = build_tables_cached(np.asarray(w), is_max)
            c1b = encode_batch_padded([queries[i].seq1 for i in idxs], l1k)
            c2b = encode_batch_padded([queries[i].seq2 for i in idxs], l2p)
            noffs = np.array([len(queries[i].seq1) - len(queries[i].seq2) + 1
                              for i in idxs], np.int32)
            n2s = np.array([len(queries[i].seq2) for i in idxs], np.int32)
            if mesh is not None:
                h, fin = batched_search_exact_sharded_async(
                    c1b, c2b, noffs, n2s, tables, mesh, shared_s1=shared_s1)
            else:
                h, fin = batched_search_exact_async(
                    c1b, c2b, noffs, n2s, tables, shared_s1=shared_s1)
            handles.extend(h)

            def fin_device(fin=fin, idxs=idxs):
                for i, r in zip(idxs, fin()):
                    results[i] = r

            finishers.append(fin_device)
        else:
            # "auto" would resolve a cold-routed bucket's large queries
            # straight back into the cold device path — force a host engine
            from psa.models.search import native_available

            host_backend = backend
            if backend in ("pallas", "auto"):
                host_backend = "native" if native_available() else "numpy"
            finishers.append(
                lambda idxs=idxs, w=w, is_max=is_max, hb=host_backend:
                _host_engine_bucket(queries, idxs, results, w, is_max, hb,
                                    strict_alphabet))
        if not defer:
            finishers.pop()()

    def finish():
        for fin in finishers:
            fin()
        return results

    return handles, finish


def batched_search_step(tables: ScoringTables, mesh: Mesh,
                        block: int = TILE_O):
    """Returns a jittable step: (c1b, c2b, noffs) -> (offsets, maxranks, totals)."""

    def step(c1b, c2b, noffs):
        stats = batched_sharded_stats(c1b, c2b, tables, mesh, block=block)
        return batched_device_winners(stats, tables, noffs)

    return step
