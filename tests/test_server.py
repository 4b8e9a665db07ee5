"""TCP serving front-end (psa --serve --listen): protocol, routing,
cross-client batching, failure isolation.

The server is a real subprocess (native backend — no JAX startup); clients
are raw sockets.  Reply correctness is anchored to the single-query engine.
"""

import signal
import socket
import subprocess
import sys
import threading

import pytest

from psa.models.search import AlignmentSearchEngine
from psa.utils.generator import random_sequences

from conftest import GOLDEN_INPUT


class _Server:
    def __init__(self, *extra_args):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "psa.utils.cli", "--serve",
             "--listen", "127.0.0.1:0", "--backend", "native", *extra_args],
            stderr=subprocess.PIPE, text=True)
        line = self.proc.stderr.readline()
        assert "listening on" in line, line
        self.port = int(line.rsplit(":", 1)[1])

    def stop(self) -> int:
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout=20)
        self.proc.stderr.close()
        return rc

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            try:
                self.stop()
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def _roundtrip(port: int, lines, shutdown_wr: bool = True):
    """Send lines, read every reply line until the server closes."""
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    payload = "\n".join(lines)
    if shutdown_wr:
        payload += "\n"
    s.sendall(payload.encode())
    if shutdown_wr:
        s.shutdown(socket.SHUT_WR)
    buf = b""
    while True:
        d = s.recv(1 << 16)
        if not d:
            break
        buf += d
    s.close()
    return buf.decode().splitlines()


def _expected_line(wline: str) -> str:
    toks = wline.split()
    w = [float(t) for t in toks[:4]]
    s1, s2, mode = toks[4], toks[5], toks[6]
    eng = AlignmentSearchEngine(w, mode == "maximum", backend="native")
    res = eng.search(s1, s2)
    return "%d %g %s" % (res.offset, res.score, res.mutant(s2))


def test_tcp_golden_error_and_order():
    toks = open(GOLDEN_INPUT).read().split()
    q = " ".join(toks[:7])
    with _Server() as srv:
        replies = _roundtrip(srv.port, [q, "not a query", q])
        assert len(replies) == 3
        assert replies[0] == replies[2] == _expected_line(q)
        assert replies[1].startswith("error ")
        assert srv.stop() == 0


def test_tcp_concurrent_clients_routing_and_order():
    """Many interleaved clients: every reply lands on the right connection
    in that connection's send order (distinct per-client queries)."""
    queries = {}
    for c in range(4):
        s1, s2 = random_sequences(120 + 13 * c, 17 + c, seed=100 + c)
        queries[c] = f"1 3 4 2 {s1} {s2} minimum"
    expected = {c: _expected_line(q) for c, q in queries.items()}

    with _Server("--quiet") as srv:
        results = {}

        def run(c):
            n = 3 + c
            results[c] = (_roundtrip(srv.port, [queries[c]] * n), n)

        threads = [threading.Thread(target=run, args=(c,)) for c in queries]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for c, (replies, n) in results.items():
            assert replies == [expected[c]] * n, (c, replies[:2])


def test_tcp_unterminated_tail_is_answered():
    toks = open(GOLDEN_INPUT).read().split()
    q = " ".join(toks[:7])
    with _Server("--quiet") as srv:
        # no trailing newline: FIN flushes the tail as a query
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=30)
        s.sendall(q.encode())
        s.shutdown(socket.SHUT_WR)
        buf = b""
        while True:
            d = s.recv(1 << 16)
            if not d:
                break
            buf += d
        s.close()
        assert buf.decode().splitlines() == [_expected_line(q)]


def test_tcp_client_vanishing_does_not_kill_server():
    toks = open(GOLDEN_INPUT).read().split()
    q = " ".join(toks[:7])
    with _Server("--quiet") as srv:
        # client A connects, sends, and slams the connection shut
        a = socket.create_connection(("127.0.0.1", srv.port), timeout=30)
        a.sendall((q + "\n").encode())
        a.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     b"\x01\x00\x00\x00\x00\x00\x00\x00")  # RST on close
        a.close()
        # client B is served normally afterwards
        assert _roundtrip(srv.port, [q]) == [_expected_line(q)]
        assert srv.stop() == 0


def test_tcp_json_replies():
    import json

    toks = open(GOLDEN_INPUT).read().split()
    q = " ".join(toks[:7])
    with _Server("--quiet", "--json") as srv:
        replies = _roundtrip(srv.port, [q, "bad"])
        assert len(replies) == 2
        obj = json.loads(replies[0])
        assert obj["mutation_found"] and obj["offset"] == 6132
        assert "error" in json.loads(replies[1])


@pytest.mark.parametrize("addr", ["not-a-port", "host:port"])
def test_tcp_bad_listen_address(addr):
    proc = subprocess.run(
        [sys.executable, "-m", "psa.utils.cli", "--serve", "--listen",
         addr, "--backend", "native"],
        capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2
    assert "bad --listen" in proc.stderr


def test_tcp_port_in_use():
    blocker = socket.create_server(("127.0.0.1", 0))
    port = blocker.getsockname()[1]
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "psa.utils.cli", "--serve",
             "--listen", f"127.0.0.1:{port}", "--backend", "native"],
            capture_output=True, text=True, timeout=60)
        assert proc.returncode == 2
        assert "cannot listen" in proc.stderr
    finally:
        blocker.close()


def test_tcp_adversarial_inputs_do_not_kill_server():
    """Binary garbage, NUL bytes, a multi-megabyte line, and invalid UTF-8
    must each produce an error reply on their own connection while the
    server keeps serving correct answers to everyone else."""
    with _Server() as srv:
        garbage = [
            b"\x00\x01\x02\xff\xfe binary\n",
            b"1 3 4 2 " + b"A" * (2 << 20) + b" ABC minimum\n",  # 2 MB line
            "1 3 4 2 SéQ ABC minimum\n".encode(),           # non-ASCII
            b"\n\n\n",                                           # blanks
        ]
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=60)
        for g in garbage:
            s.sendall(g)
        s.shutdown(socket.SHUT_WR)
        buf = b""
        while True:
            d = s.recv(1 << 16)
            if not d:
                break
            buf += d
        s.close()
        replies = buf.decode().splitlines()
        # 3 non-blank adversarial lines -> 3 replies, every one an error
        # EXCEPT the 2 MB one, which is a structurally valid query with a
        # huge seq1 — either a real answer or an error is acceptable, it
        # just must not kill the server
        assert len(replies) == 3
        assert replies[0].startswith("error")
        assert replies[2].startswith("error")
        # a fresh well-formed client still gets the right answer
        want = _expected_line("1 3 4 2 ABCDEFGHIJ ABC minimum")
        got = _roundtrip(srv.port, ["1 3 4 2 ABCDEFGHIJ ABC minimum"])
        assert got == [want]
        assert srv.stop() == 0
