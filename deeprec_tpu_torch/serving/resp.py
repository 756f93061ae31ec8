"""Dependency-free Redis wire protocol (RESP2) client and test server.

Port of ``deeprec_tpu/serving/resp.py``, byte for byte on the wire (it
imports the standard library only; the port keeps its own copy so that
it never imports the JAX package):

  * :class:`RespClient`: a minimal RESP2 client (SET/GET/MGET/DEL/PING/
    SELECT/SCAN and pipelining) that speaks to any Redis server;
    :class:`~deeprec_tpu_torch.serving.feature_store.RedisFeatureStore`
    uses it when the ``redis`` package is absent.
  * :class:`MiniRedisServer`: an in-process RESP2 server implementing
    the command subset the feature store needs, so the Redis path runs
    end to end without a Redis server.

Scope: binary-safe bulk strings, single-threaded per connection,
several databases through SELECT, SCAN that returns every match in one
page with cursor 0 (a legal server behaviour clients must handle).
"""

from __future__ import annotations

import fnmatch
import socket
import socketserver
import threading
from typing import Dict, Iterable, List, Optional


# ---------------------------------------------------------------------------
# Wire encoding
# ---------------------------------------------------------------------------

def encode_command(*args: bytes) -> bytes:
    """RESP array of bulk strings — the client->server command form."""
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        if isinstance(a, str):
            a = a.encode()
        out.append(b"$%d\r\n%s\r\n" % (len(a), a))
    return b"".join(out)


class _Reader:
    """Buffered RESP reply reader over a socket."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = b""

    def _fill(self):
        chunk = self._sock.recv(65536)
        if not chunk:
            raise ConnectionError("redis connection closed")
        self._buf += chunk

    def _line(self) -> bytes:
        while b"\r\n" not in self._buf:
            self._fill()
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _exactly(self, n: int) -> bytes:
        while len(self._buf) < n + 2:
            self._fill()
        data, self._buf = self._buf[:n], self._buf[n + 2:]
        return data

    def read(self):
        line = self._line()
        t, body = line[:1], line[1:]
        if t == b"+":
            return body
        if t == b"-":
            raise RedisError(body.decode())
        if t == b":":
            return int(body)
        if t == b"$":
            n = int(body)
            return None if n == -1 else self._exactly(n)
        if t == b"*":
            n = int(body)
            return None if n == -1 else [self.read() for _ in range(n)]
        raise RedisError(f"bad RESP type byte {t!r}")


class RedisError(Exception):
    pass


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------

class RespClient:
    """Minimal RESP2 client, API-compatible with the ``redis`` package
    calls :mod:`feature_store` makes (mget/set/delete/scan_iter/ping +
    pipeline)."""

    def __init__(self, host: str = "localhost", port: int = 6379,
                 db: int = 0):
        self._sock = socket.create_connection((host, port), timeout=30)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._reader = _Reader(self._sock)
        self._lock = threading.Lock()
        if db:
            self.execute("SELECT", str(db))

    @classmethod
    def from_url(cls, url: str) -> "RespClient":
        """redis://host[:port][/db]"""
        body = url.split("://", 1)[-1]
        db = 0
        if "/" in body:
            body, db_s = body.rsplit("/", 1)
            db = int(db_s or 0)
        host, _, port = body.partition(":")
        return cls(host or "localhost", int(port or 6379), db)

    def execute(self, *args):
        with self._lock:
            self._sock.sendall(encode_command(*args))
            return self._reader.read()

    def execute_many(self, commands: Iterable[tuple]) -> List:
        """Pipelined round trip: send every command, then read every
        reply (the reference's redis pipeline for bulk puts)."""
        commands = list(commands)
        with self._lock:
            self._sock.sendall(
                b"".join(encode_command(*c) for c in commands))
            return [self._reader.read() for _ in commands]

    # redis-package-compatible surface -----------------------------------
    def ping(self) -> bool:
        return self.execute("PING") == b"PONG"

    def set(self, key, value) -> bool:
        return self.execute("SET", key, value) == b"OK"

    def get(self, key) -> Optional[bytes]:
        return self.execute("GET", key)

    def mget(self, keys) -> List[Optional[bytes]]:
        if not keys:
            return []
        return self.execute("MGET", *keys)

    def delete(self, *keys) -> int:
        return self.execute("DEL", *keys) if keys else 0

    def scan_iter(self, match: str):
        cursor = b"0"
        while True:
            cur, page = self.execute("SCAN", cursor, "MATCH", match,
                                     "COUNT", "1000")
            yield from page
            cursor = cur
            if cursor == b"0":
                return

    def pipeline(self) -> "_Pipeline":
        return _Pipeline(self)

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


class _Pipeline:
    def __init__(self, client: RespClient):
        self._c = client
        self._cmds: List[tuple] = []

    def set(self, key, value):
        self._cmds.append(("SET", key, value))
        return self

    def execute(self):
        cmds, self._cmds = self._cmds, []
        return self._c.execute_many(cmds)


# ---------------------------------------------------------------------------
# In-process server double
# ---------------------------------------------------------------------------

class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        reader = _Reader(self.request)
        dbs: Dict[int, Dict[bytes, bytes]] = self.server.dbs
        lock = self.server.lock
        db = 0
        while True:
            try:
                cmd = reader.read()
            except (ConnectionError, OSError):
                return
            if not isinstance(cmd, list) or not cmd:
                self._send(b"-ERR protocol error\r\n")
                return
            name = cmd[0].upper()
            args = cmd[1:]
            try:
                with lock:
                    table = dbs.setdefault(db, {})
                    if name == b"PING":
                        self._send(b"+PONG\r\n")
                    elif name == b"SELECT":
                        db = int(args[0])
                        self._send(b"+OK\r\n")
                    elif name == b"SET":
                        table[args[0]] = args[1]
                        self._send(b"+OK\r\n")
                    elif name == b"GET":
                        self._send(self._bulk(table.get(args[0])))
                    elif name == b"MGET":
                        out = [b"*%d\r\n" % len(args)]
                        out += [self._bulk(table.get(k)) for k in args]
                        self._send(b"".join(out))
                    elif name == b"DEL":
                        n = sum(1 for k in args if table.pop(k, None)
                                is not None)
                        self._send(b":%d\r\n" % n)
                    elif name == b"SCAN":
                        match = b"*"
                        if b"MATCH" in [a.upper() for a in args]:
                            i = [a.upper() for a in args].index(b"MATCH")
                            match = args[i + 1]
                        keys = [k for k in table
                                if fnmatch.fnmatchcase(
                                    k.decode("latin1"),
                                    match.decode("latin1"))]
                        out = [b"*2\r\n$1\r\n0\r\n",
                               b"*%d\r\n" % len(keys)]
                        out += [self._bulk(k) for k in keys]
                        self._send(b"".join(out))
                    elif name == b"FLUSHDB":
                        table.clear()
                        self._send(b"+OK\r\n")
                    elif name == b"DBSIZE":
                        self._send(b":%d\r\n" % len(table))
                    else:
                        self._send(b"-ERR unknown command '%s'\r\n"
                                   % name)
            except (IndexError, ValueError) as e:
                self._send(b"-ERR %s\r\n" % str(e).encode())

    @staticmethod
    def _bulk(v: Optional[bytes]) -> bytes:
        return b"$-1\r\n" if v is None else b"$%d\r\n%s\r\n" % (len(v), v)

    def _send(self, data: bytes):
        self.request.sendall(data)


class MiniRedisServer:
    """In-process RESP2 server; ``with MiniRedisServer() as url: ...``."""

    def __init__(self, port: int = 0):
        self._srv = socketserver.ThreadingTCPServer(
            ("127.0.0.1", port), _Handler)
        self._srv.daemon_threads = True
        self._srv.dbs = {}
        self._srv.lock = threading.RLock()
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True)

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    @property
    def url(self) -> str:
        return f"redis://127.0.0.1:{self.port}/0"

    def start(self) -> "MiniRedisServer":
        self._thread.start()
        return self

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
