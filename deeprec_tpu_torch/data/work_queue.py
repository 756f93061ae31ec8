"""WorkQueue: elastic data sharding across workers.

Port of ``deeprec_tpu/data/work_queue.py``, a copy of the whole module
(it is stdlib-only, but the port imports nothing of the JAX package): a
global queue of work items (file names, table slices) that workers
``take()`` from, so fast workers consume more input than stragglers; the
queue state is saveable, so a restore resumes the remaining work (the
reference's ``python/ops/work_queue.py``, ``docs/WorkQueue.md``).

Two deployments:
  * ``WorkQueue`` — in-process (single host, N consumer threads).
  * ``WorkQueueServer``/``RemoteWorkQueue`` — a trivial length-prefixed
    TCP protocol for multi-host jobs (plays the PS-resource role; the
    coordinator typically runs on host 0).  stdlib-only, no RPC stack —
    the data plane here is host metadata, not tensors.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
from typing import List, Optional, Sequence


class WorkQueue:
    """Thread-safe, saveable work-item queue with epochs."""

    def __init__(self, items: Sequence[str], num_epochs: int = 1,
                 shuffle: bool = False, seed: int = 0):
        self._all = list(items)
        self._lock = threading.Lock()
        self._num_epochs = num_epochs
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self._pending: List[str] = []
        self._refill()

    def _refill(self):
        if self._epoch >= self._num_epochs:
            return
        items = list(self._all)
        if self._shuffle:
            import random

            random.Random(self._seed + self._epoch).shuffle(items)
        self._pending = items
        self._epoch += 1

    def take(self) -> Optional[str]:
        """Next work item, or None when all epochs are exhausted."""
        with self._lock:
            if not self._pending:
                self._refill()
            if not self._pending:
                return None
            return self._pending.pop(0)

    def add(self, items: Sequence[str]):
        with self._lock:
            self._pending.extend(items)

    # -- saveable state (restores remaining work, reference behavior) ----
    def state(self) -> dict:
        with self._lock:
            return {"pending": list(self._pending), "epoch": self._epoch,
                    "all": list(self._all)}

    def restore_state(self, state: dict):
        """In-place restore (the checkpoint-aux path: an Estimator's
        manager calls this when a checkpoint carries queue state)."""
        with self._lock:
            self._all = list(state["all"])
            self._pending = list(state["pending"])
            self._epoch = state["epoch"]

    @classmethod
    def from_state(cls, state: dict, num_epochs: int = 1,
                   shuffle: bool = False, seed: int = 0) -> "WorkQueue":
        q = cls(state["all"], num_epochs=num_epochs, shuffle=shuffle,
                seed=seed)
        q._pending = list(state["pending"])
        q._epoch = state["epoch"]
        return q

    def __iter__(self):
        while True:
            item = self.take()
            if item is None:
                return
            yield item


def _send_msg(sock: socket.socket, obj):
    data = json.dumps(obj).encode()
    sock.sendall(len(data).to_bytes(4, "big") + data)


def _recv_msg(sock: socket.socket):
    head = b""
    while len(head) < 4:
        chunk = sock.recv(4 - len(head))
        if not chunk:
            return None
        head += chunk
    n = int.from_bytes(head, "big")
    data = b""
    while len(data) < n:
        chunk = sock.recv(n - len(data))
        if not chunk:
            return None
        data += chunk
    return json.loads(data.decode())


class WorkQueueServer:
    """Serve a WorkQueue to remote workers (run on the coordinator)."""

    def __init__(self, queue: WorkQueue, host: str = "0.0.0.0",
                 port: int = 0):
        q = queue

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    msg = _recv_msg(self.request)
                    if msg is None:
                        return
                    if msg.get("op") == "take":
                        _send_msg(self.request, {"item": q.take()})
                    elif msg.get("op") == "state":
                        _send_msg(self.request, {"state": q.state()})
                    else:
                        _send_msg(self.request, {"error": "bad op"})

        self._server = socketserver.ThreadingTCPServer((host, port),
                                                       Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def shutdown(self):
        self._server.shutdown()


class RemoteWorkQueue:
    """Client side: same ``take()`` interface as WorkQueue."""

    def __init__(self, host: str, port: int):
        self._sock = socket.create_connection((host, port))
        self._lock = threading.Lock()

    def take(self) -> Optional[str]:
        with self._lock:
            _send_msg(self._sock, {"op": "take"})
            resp = _recv_msg(self._sock)
        return None if resp is None else resp.get("item")

    def __iter__(self):
        while True:
            item = self.take()
            if item is None:
                return
            yield item

    def close(self):
        self._sock.close()
