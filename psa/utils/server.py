"""Network serving front-end: TCP query server with cross-client batching.

The production tier above the stdin/stdout serve loop (utils/cli._main_serve).
The reference is a one-shot batch program (main.c:13-56); its natural serving
analog is a long-lived server that keeps compiled device programs warm
and fills device batches from MANY concurrent clients:

- one single-threaded `selectors` event loop owns every connection (the
  device dispatch is the bottleneck and is itself serial per chip, so client
  threads would only add locking);
- each readable socket drains into a per-connection buffer; complete lines
  join one FIFO across ALL connections, so concurrent low-rate clients
  coalesce into full device batches (continuous batching — the same
  coalescing the pipe server gets from select-drain, widened to N sockets);
- replies are routed back per connection in that connection's send order
  (the FIFO preserves arrival order, and search_batch returns in input
  order, so per-client ordering needs no sequence numbers);
- a malformed line yields an `error ...` reply on its own connection and
  the server keeps going; a vanished client is dropped without disturbing
  the batch (its replies are discarded at routing time).

Protocol per line: the 7 input-file tokens (4 weights, Seq1, Seq2, mode),
reply `<offset> <score%g> <mutant>` / `-1 <inf|-inf> <seq2>` / `error <msg>`
— identical to the pipe server, so anything speaking the stdin protocol can
speak TCP by pointing at host:port.
"""

from __future__ import annotations

import selectors
import signal
import socket
import sys
import time
from collections import deque


class PendingReplies:
    """One in-flight serve chunk: parse errors already resolved, device
    batches dispatched (uploads + programs enqueued), replies completed by
    `finish()` — which the serve loops run on the Finisher thread so client
    I/O keeps draining while the fetch RPC blocks."""

    __slots__ = ("_outputs", "_queries", "_slots", "_handles", "_finish",
                 "_t0", "_json")

    def __init__(self, outputs, queries, slots, handles, finish_fn,
                 t0: float, json_out: bool):
        self._outputs = outputs
        self._queries = queries
        self._slots = slots
        self._handles = handles     # in-flight device outputs (kept alive)
        self._finish = finish_fn
        self._t0 = t0
        self._json = json_out

    def finish(self):
        """Complete the chunk -> (outputs, n_queries, seconds); blocks until
        device results land, then formats replies in input order."""
        results = self._finish()
        dt = time.perf_counter() - self._t0
        for j, q, res in zip(self._slots, self._queries, results):
            if self._json:
                from psa.utils.cli import _result_json

                self._outputs[j] = _result_json(q, res)
            elif res is None:
                bad = float("-inf") if q.is_max else float("inf")
                self._outputs[j] = "-1 %g %s" % (bad, q.seq2)
            else:
                self._outputs[j] = "%d %g %s" % (res.offset, res.score,
                                                 res.mutant(q.seq2))
        return self._outputs, len(self._queries), dt


def cold_route_default(backend: str) -> bool:
    """Serving policy for models/batch's cold-bucket host routing: with an
    accelerator present a cold bucket means a compile inside the reply
    path, so route it to the host engine while the background warmer
    compiles; without one (tests, interpret mode) the device path is
    exercised directly.  PSA_COLD_ROUTE=0/1 overrides."""
    import os

    env = os.environ.get("PSA_COLD_ROUTE")
    if env is not None:
        return env.strip().lower() not in ("0", "", "false", "no", "off")
    if backend not in ("auto", "pallas"):
        return False
    from psa.ops.device import accelerator_present

    return accelerator_present()


def dispatch_query_lines(lines, *, backend: str, lenient: bool,
                         json_out: bool, mesh,
                         cold_route: bool | None = None) -> PendingReplies:
    """Async front half of one serve chunk: parse + validate every line,
    dispatch the device buckets (models/batch.search_batch_async), return
    a PendingReplies whose finish() yields the aligned reply lines.
    `outputs[j]` is the reply for `lines[j]` (None for blank lines, which
    get no reply)."""
    from psa.models.batch import search_batch_async
    from psa.utils.io import parse_query_lines

    if cold_route is None:
        cold_route = cold_route_default(backend)

    # parse + validate the whole chunk in one pass (native C scanner when
    # available, Python otherwise — identical semantics either way)
    outputs: list = [None] * len(lines)
    queries, slots = [], []
    for j, ent in enumerate(parse_query_lines(lines,
                                              check_alphabet=not lenient)):
        if ent is None:
            continue
        if isinstance(ent, str):
            outputs[j] = _error_json(ent) if json_out else f"error {ent}"
        else:
            queries.append(ent)
            slots.append(j)
    t0 = time.perf_counter()
    if queries:
        handles, finish_fn = search_batch_async(
            queries, backend=backend, strict_alphabet=False, mesh=mesh,
            cold_route=cold_route)
    else:
        handles, finish_fn = [], (lambda: [])
    return PendingReplies(outputs, queries, slots, handles, finish_fn, t0,
                          json_out)


def process_query_lines(lines, *, backend: str, lenient: bool,
                        json_out: bool, mesh):
    """One synchronous serve chunk: query lines -> aligned reply lines.

    Returns (outputs, n_queries, seconds).  Shared by the stdin serve loop
    and the TCP server so both speak byte-identical protocol from one
    implementation (dispatch_query_lines + finish)."""
    return dispatch_query_lines(lines, backend=backend, lenient=lenient,
                                json_out=json_out, mesh=mesh).finish()


def _error_json(msg: str) -> str:
    import json

    return json.dumps({"error": msg})


class Finisher:
    """One background thread completing PendingReplies in dispatch order.

    `finish()` blocks on the device fetch RPC — which releases the GIL —
    so running it off-loop lets the serve loops parse/encode/drain the
    NEXT chunk while the oldest batch's results travel: overlapped,
    per-chunk wall approaches max(fetch, host).  Results come back strictly FIFO (one worker), so
    reply ordering is unchanged.  Exceptions from finish() re-raise on
    the collecting thread."""

    def __init__(self):
        import queue
        import threading

        self._in: "queue.Queue" = queue.Queue()
        self._out: "queue.Queue" = queue.Queue()
        self._n = 0              # submitted, not yet collected
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="psa-finisher")
        self._t.start()

    def _run(self):
        while True:
            item = self._in.get()
            if item is None:
                return
            tag, pending = item
            try:
                self._out.put(("ok", tag, pending.finish()))
            except BaseException as e:  # noqa: BLE001 - re-raised by collect
                self._out.put(("err", tag, e))

    def submit(self, pending, tag=None) -> None:
        self._n += 1
        self._in.put((tag, pending))

    @property
    def inflight(self) -> int:
        return self._n

    def collect(self, timeout: float | None):
        """(tag, (outputs, nq, dt)) of the oldest batch; None if nothing
        completes within `timeout` (0 = non-blocking, None = wait)."""
        import queue

        try:
            kind, tag, payload = self._out.get(
                block=timeout != 0, timeout=timeout or None)
        except queue.Empty:
            return None
        self._n -= 1
        if kind == "err":
            raise payload
        return tag, payload

    def close(self, wait: bool = True) -> None:
        """Stop the worker once queued batches drain.  wait=False abandons
        in-flight work instead (the broken-pipe exit: nobody will read the
        replies, and a slow fetch must not stall the exit — the daemon
        thread dies with the process)."""
        self._in.put(None)
        if wait:
            self._t.join(timeout=10)


class _Conn:
    """Per-connection state: input line buffer, reply outbox, lifecycle."""

    __slots__ = ("sock", "inbuf", "outbuf", "read_eof", "npending",
                 "interest")

    def __init__(self, sock):
        self.sock = sock
        self.inbuf = bytearray()
        self.outbuf = bytearray()
        self.read_eof = False       # client finished sending (FIN)
        self.npending = 0           # its lines still waiting in the FIFO
        self.interest = 0           # current selector event mask

    def take_lines(self, out: deque) -> None:
        """Move complete lines from inbuf into the shared FIFO."""
        while True:
            nl = self.inbuf.find(b"\n")
            if nl < 0:
                break
            out.append((self, self.inbuf[: nl + 1].decode("utf-8", "replace")))
            self.npending += 1
            del self.inbuf[: nl + 1]

    def flush_tail(self, out: deque) -> None:
        """On EOF, a final unterminated line is still a query (the pipe
        server honors it too — _ServeLineReader's tail rule)."""
        if self.inbuf:
            out.append((self, self.inbuf.decode("utf-8", "replace")))
            self.npending += 1
            self.inbuf.clear()

    def done(self) -> bool:
        return self.read_eof and not self.outbuf and self.npending == 0


class TCPQueryServer:
    """Single-threaded batching TCP server over `process_query_lines`.

    `port=0` binds an ephemeral port; the bound address is announced on
    stderr as `[serve] listening on HOST:PORT` (machine-parseable — tests
    and launchers read it).  SIGINT/SIGTERM request a clean stop: the loop
    finishes the in-flight batch, flushes outboxes, and returns 0.
    """

    # selector timeout while idle: bounds signal-reaction latency (PEP 475
    # retries select after the handler runs, so a plain blocking select
    # would absorb the wakeup)
    _IDLE_TICK = 0.25
    # selector timeout while a batch is in flight on the device: the loop
    # keeps draining sockets and polls the finisher thread between
    # selects, so this bounds added reply latency, not throughput
    _POLL_TICK = 0.002
    # dispatched-but-uncollected batches (device pipeline depth at the
    # server level): the finisher thread blocks on the oldest fetch while
    # this loop drains/parses/dispatches the next, so 2 overlaps the
    # RPC-expensive fetch with both device compute AND host serve work;
    # PSA_SERVE_INFLIGHT raises it for deployments whose per-fetch
    # latency dominates
    @property
    def _MAX_INFLIGHT(self):
        from psa.config import CONFIG

        return max(1, CONFIG.serve_inflight)

    def __init__(self, host: str, port: int, *, backend: str, lenient: bool,
                 json_out: bool, mesh, max_batch: int, quiet: bool):
        self._addr = (host, port)
        self._backend = backend
        self._lenient = lenient
        self._json = json_out
        self._mesh = mesh
        self._max_batch = max(1, max_batch)
        self._quiet = quiet
        self._stop = False
        self._served = 0
        self._fin: Finisher | None = None   # set for run()'s lifetime
        self.bound_addr: tuple | None = None

    def request_stop(self, *_a) -> None:
        self._stop = True

    def _log(self, msg: str) -> None:
        if not self._quiet:
            print(msg, file=sys.stderr, flush=True)

    def run(self) -> int:
        sel = selectors.DefaultSelector()
        try:
            lsock = socket.create_server(self._addr, backlog=64)
        except OSError as e:
            print(f"error: cannot listen on "
                  f"{self._addr[0]}:{self._addr[1]}: {e}", file=sys.stderr)
            return 2
        lsock.setblocking(False)
        self.bound_addr = lsock.getsockname()[:2]
        # always announced, even under --quiet: launchers and tests parse
        # this line to learn the ephemeral port (the one piece of stderr
        # output that is protocol, not progress)
        print(f"[serve] listening on "
              f"{self.bound_addr[0]}:{self.bound_addr[1]}",
              file=sys.stderr, flush=True)
        sel.register(lsock, selectors.EVENT_READ, None)

        old_int = signal.signal(signal.SIGINT, self.request_stop)
        old_term = signal.signal(signal.SIGTERM, self.request_stop)
        fifo: deque = deque()       # (conn, line) across every connection
        self._fin = fin = Finisher()
        try:
            while not self._stop:
                # zero timeout ONLY when a dispatch can actually happen this
                # pass; a full pipeline waits on the poll tick instead — a
                # 0-timeout spin would hog the GIL and starve the device
                # client's own I/O threads (measured: TCP throughput 4x
                # worse than the pipe loop until this rule)
                n0 = len(fifo)
                can_dispatch = fin.inflight < self._MAX_INFLIGHT
                if fifo and can_dispatch:
                    timeout = 0
                elif fifo or fin.inflight:
                    timeout = self._POLL_TICK
                else:
                    timeout = self._IDLE_TICK
                events = sel.select(timeout)
                for key, mask in events:
                    if key.data is None:
                        self._accept(sel, lsock)
                    else:
                        self._handle(sel, key.data, mask, fifo)
                # route every batch the finisher thread completed (it blocks
                # on the oldest fetch in the background — the RPC releases
                # the GIL — while this loop keeps draining and dispatching)
                while True:
                    got = fin.collect(timeout=0)
                    if got is None:
                        break
                    self._route(sel, fifo, got[0], got[1])
                # dispatch only a FULL batch, or a partial one once input is
                # quiescent (no new line arrived this pass) — the socket
                # analog of the pipe reader's drain phase.  Without this,
                # one recv per connection per pass yields small odd-sized
                # dispatches, each paying a device round trip (and, for a
                # new padded size, a compile).
                if (fifo and fin.inflight < self._MAX_INFLIGHT
                        and (len(fifo) >= self._max_batch
                             or len(fifo) == n0)):
                    self._dispatch(sel, fifo)
            # clean stop: finish in-flight batches, drop unprocessed lines,
            # flush what was answered
            while fin.inflight:
                got = fin.collect(timeout=None)
                self._route(sel, fifo, got[0], got[1])
            self._drain_outboxes(sel)
        finally:
            fin.close()
            self._fin = None
            signal.signal(signal.SIGINT, old_int)
            signal.signal(signal.SIGTERM, old_term)
            for key in list(sel.get_map().values()):
                try:
                    key.fileobj.close()
                except OSError:
                    pass
            sel.close()
        self._log(f"[serve] stopped ({self._served} queries served)")
        return 0

    def _accept(self, sel, lsock) -> None:
        try:
            sock, peer = lsock.accept()
        except OSError:
            return
        sock.setblocking(False)
        conn = _Conn(sock)
        conn.interest = selectors.EVENT_READ
        sel.register(sock, conn.interest, conn)

    def _sync_interest(self, sel, conn: _Conn, fifo: deque) -> None:
        """Keep the selector registration equal to what the connection can
        actually progress on: READ until the client's FIN (an EOF socket is
        readable forever — leaving READ interest would spin the loop and
        defeat the quiescence test), WRITE only while replies are queued.
        A conn with neither (EOF, replies still being computed) parks
        unregistered until _dispatch gives it output."""
        if conn.sock.fileno() < 0:
            return
        want = 0
        if not conn.read_eof:
            want |= selectors.EVENT_READ
        if conn.outbuf:
            want |= selectors.EVENT_WRITE
        if want == conn.interest:
            return
        if not want:
            sel.unregister(conn.sock)
        elif not conn.interest:
            sel.register(conn.sock, want, conn)
        else:
            sel.modify(conn.sock, want, conn)
        conn.interest = want

    def _handle(self, sel, conn: _Conn, mask: int, fifo: deque) -> None:
        if mask & selectors.EVENT_READ and not conn.read_eof:
            # drain the socket until it would block (or this connection
            # alone can fill the dispatch pipeline plus the next batch —
            # per-client backpressure: the rest stays in the kernel buffer
            # until its lines are routed)
            while conn.npending < self._max_batch * (self._MAX_INFLIGHT + 1):
                try:
                    data = conn.sock.recv(1 << 16)
                except BlockingIOError:
                    break
                except OSError:
                    self._close(sel, conn, fifo)
                    return
                if data:
                    conn.inbuf += data
                    conn.take_lines(fifo)
                else:
                    conn.read_eof = True
                    conn.flush_tail(fifo)
                    if conn.done():
                        self._close(sel, conn, fifo)
                        return
                    break
        if mask & selectors.EVENT_WRITE:
            self._write(sel, conn, fifo)
            return                  # _write already synced interest/closed
        self._sync_interest(sel, conn, fifo)

    def _write(self, sel, conn: _Conn, fifo: deque) -> None:
        if conn.outbuf:
            try:
                n = conn.sock.send(conn.outbuf)
                del conn.outbuf[:n]
            except BlockingIOError:
                return
            except OSError:
                self._close(sel, conn, fifo)
                return
        if not conn.outbuf and conn.done():
            self._close(sel, conn, fifo)
        else:
            self._sync_interest(sel, conn, fifo)

    def _close(self, sel, conn: _Conn, fifo: deque) -> None:
        if conn.interest:
            try:
                sel.unregister(conn.sock)
            except (KeyError, ValueError):
                pass
            conn.interest = 0
        try:
            conn.sock.close()
        except OSError:
            pass
        conn.read_eof = True
        conn.outbuf.clear()
        if conn.npending:
            # drop its queued lines so a dead client can't occupy the batch
            remaining = [(c, ln) for c, ln in fifo if c is not conn]
            fifo.clear()
            fifo.extend(remaining)
            conn.npending = 0

    def _dispatch(self, sel, fifo: deque) -> None:
        """Take up to max_batch lines (FIFO across clients), dispatch ONE
        batched search asynchronously, hand it to the finisher thread;
        replies route when it completes (_route) — the event loop keeps
        draining sockets in the meantime."""
        take = min(len(fifo), self._max_batch)
        batch = [fifo.popleft() for _ in range(take)]
        lines = [ln for _, ln in batch]
        pending = dispatch_query_lines(
            lines, backend=self._backend, lenient=self._lenient,
            json_out=self._json, mesh=self._mesh)
        self._fin.submit(pending, tag=batch)

    def _route(self, sel, fifo: deque, batch, payload) -> None:
        """Route one completed batch's replies (main thread: this touches
        the selector and connection state, which the finisher must not)."""
        outputs, nq, dt = payload
        nconns = len({id(c) for c, _ in batch})
        for (conn, _), out in zip(batch, outputs):
            conn.npending = max(0, conn.npending - 1)
            if conn.sock.fileno() < 0:      # vanished mid-batch
                continue
            if out is not None:
                conn.outbuf += out.encode("utf-8", "replace") + b"\n"
            if not conn.outbuf and conn.done():
                self._close(sel, conn, fifo)
            else:
                self._sync_interest(sel, conn, fifo)
        self._served += nq
        if nq:
            self._log(f"[serve] {nq} queries from {nconns} conn(s) in "
                      f"{dt*1e3:.1f} ms ({self._served} total)")

    def _drain_outboxes(self, sel, deadline_s: float = 5.0) -> None:
        """Best-effort flush of answered replies before shutdown."""
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < deadline_s:
            conns = [k.data for k in sel.get_map().values()
                     if k.data is not None and k.data.outbuf]
            if not conns:
                return
            for conn in conns:
                self._write(sel, conn, deque())
            time.sleep(0.01)


def serve_tcp(listen: str, *, backend: str, lenient: bool, json_out: bool,
              mesh, max_batch: int, quiet: bool) -> int:
    """CLI entry: parse HOST:PORT (PORT alone binds 127.0.0.1) and run."""
    host, sep, port_s = listen.rpartition(":")
    if not sep:
        host, port_s = "127.0.0.1", listen
    try:
        port = int(port_s)
    except ValueError:
        print(f"error: bad --listen address {listen!r} "
              "(expected HOST:PORT or PORT)", file=sys.stderr)
        return 2
    server = TCPQueryServer(host or "127.0.0.1", port, backend=backend,
                            lenient=lenient, json_out=json_out, mesh=mesh,
                            max_batch=max_batch, quiet=quiet)
    return server.run()
