"""Kafka consumer-group coordination: partition rebalance, group offsets.

Port of ``deeprec_tpu/data/kafka_group.py`` (the reference's
``KafkaGroupIODataset``, ``docs/KafkaDataset.md``): several
online-learning workers share one topic set; partitions rebalance over
the live workers and committed offsets survive worker churn, so each
record trains once per group. The data plane is the port's wire client
(``kafka_protocol.py``); the coordination plane is a small socket
service of its own (the ``WorkQueue`` pattern, ``data/work_queue.py``)
speaking join, heartbeat, leave and commit.

Semantics:
  * membership by heartbeat: a member silent for ``session_timeout``
    seconds is dropped and its partitions rebalance;
  * assignment: round-robin of (topic, partition) over the members
    sorted by id (deterministic; the reference's RangeAssignor role);
  * a rebalance bumps the GENERATION; a consumer sees the bump at its
    next heartbeat, seeks newly assigned partitions to the group's
    committed offsets and drops revoked ones;
  * offsets commit after every batch delivered to the trainer
    (at-least-once across ungraceful deaths, exactly-once under a
    graceful leave, as Kafka groups).

Departure from the reference, on purpose (its fault: a fenced member
moves the group's offsets): ``GroupCoordinator.commit`` takes the
member's generation and refuses, leaving the offsets as they were, a
commit from a member that is not in the group or whose generation is
not the current one, as Kafka's OffsetCommit answers
ILLEGAL_GENERATION. The JAX package's coordinator takes any member's
offsets (``deeprec_tpu/data/kafka_group.py:106-113``), so a member a
rebalance has fenced can still move the offsets of partitions another
member now owns. ``KafkaGroupDataset`` sends its generation with every
commit and, on a refusal, adopts the coordinator's new view before it
commits again.
"""

from __future__ import annotations

import socket
import socketserver
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from deeprec_tpu_torch.data import kafka_protocol
from deeprec_tpu_torch.data.work_queue import _recv_msg, _send_msg

# Commits a member tries before it gives up: each refusal means a
# rebalance happened since its last view, and a stable group takes the
# second.
_COMMIT_TRIES = 5


class GroupCoordinator:
    """In-process coordinator state (wrap with
    :class:`GroupCoordinatorServer` for cross-worker use)."""

    def __init__(self, partitions: Sequence[Tuple[str, int]],
                 session_timeout: float = 10.0):
        self._partitions = sorted(partitions)
        self._timeout = session_timeout
        self._members: Dict[str, float] = {}     # id -> last heartbeat
        self._generation = 0
        self._offsets: Dict[Tuple[str, int], int] = {}
        # RLock: state() reads committed() under the same lock.
        self._lock = threading.RLock()

    # -- membership -------------------------------------------------------
    def _expire(self, now: float):
        dead = [m for m, t in self._members.items()
                if now - t > self._timeout]
        for m in dead:
            del self._members[m]
        if dead:
            self._generation += 1

    def _assignment(self, member: str) -> List[Tuple[str, int]]:
        members = sorted(self._members)
        return [tp for i, tp in enumerate(self._partitions)
                if members and members[i % len(members)] == member]

    def join(self, member: str) -> dict:
        with self._lock:
            now = time.time()
            self._expire(now)
            if member not in self._members:
                self._generation += 1
            self._members[member] = now
            return self._view(member)

    def heartbeat(self, member: str) -> dict:
        with self._lock:
            now = time.time()
            if member not in self._members:
                # Expired (or never joined): rejoin.
                self._expire(now)
                self._generation += 1
            self._members[member] = now
            self._expire(now)
            return self._view(member)

    def leave(self, member: str) -> dict:
        with self._lock:
            if self._members.pop(member, None) is not None:
                self._generation += 1
            return {"generation": self._generation}

    def _view(self, member: str) -> dict:
        asg = self._assignment(member)
        return {
            "generation": self._generation,
            "assigned": [[t, p] for t, p in asg],
            "offsets": {f"{t}:{p}": self._offsets.get((t, p), 0)
                        for t, p in asg},
        }

    # -- offsets ----------------------------------------------------------
    def commit(self, member: str, offsets: Dict[str, int],
               generation: Optional[int]) -> dict:
        """Take ``member``'s offsets (each partition's moves forward
        only) if the member is in the group at ``generation``, the
        current one; else refuse and leave the offsets unchanged (see
        the module docstring). Returns ``ok`` and the current
        generation."""
        with self._lock:
            self._expire(time.time())
            if member not in self._members or generation != self._generation:
                return {"ok": False, "generation": self._generation}
            for key, off in offsets.items():
                t, _, p = key.rpartition(":")
                tp = (t, int(p))
                self._offsets[tp] = max(self._offsets.get(tp, 0),
                                        int(off))
            return {"ok": True, "generation": self._generation}

    def committed(self) -> Dict[str, int]:
        with self._lock:
            return {f"{t}:{p}": off
                    for (t, p), off in self._offsets.items()}

    # -- checkpointing (saveable-resource pattern) -------------------------
    def state(self) -> dict:
        with self._lock:
            return {"offsets": self.committed()}

    def restore_state(self, state: dict):
        with self._lock:
            self._offsets = {}
            for key, off in state.get("offsets", {}).items():
                t, _, p = key.rpartition(":")
                self._offsets[(t, int(p))] = int(off)


class GroupCoordinatorServer:
    """Socket front for :class:`GroupCoordinator` (the WorkQueueServer
    pattern) so workers on other hosts/processes can join."""

    def __init__(self, coord: GroupCoordinator, host: str = "0.0.0.0",
                 port: int = 0):
        c = coord

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    try:
                        msg = _recv_msg(self.request)
                    except (ConnectionError, OSError):
                        return
                    if msg is None:
                        return
                    op = msg.get("op")
                    if op == "join":
                        _send_msg(self.request, c.join(msg["member"]))
                    elif op == "heartbeat":
                        _send_msg(self.request,
                                  c.heartbeat(msg["member"]))
                    elif op == "leave":
                        _send_msg(self.request, c.leave(msg["member"]))
                    elif op == "commit":
                        _send_msg(self.request, c.commit(
                            msg["member"], msg["offsets"],
                            msg.get("generation")))
                    else:
                        _send_msg(self.request, {"error": "bad op"})

        self._srv = socketserver.ThreadingTCPServer((host, port),
                                                    Handler)
        self._srv.daemon_threads = True
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    def shutdown(self):
        self._srv.shutdown()
        self._srv.server_close()


class _CoordClient:
    def __init__(self, host: str, port: int):
        self._sock = socket.create_connection((host, port), timeout=30)

    def call(self, **msg) -> dict:
        _send_msg(self._sock, msg)
        out = _recv_msg(self._sock)
        if out is None:
            raise ConnectionError("coordinator closed")
        return out

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


class KafkaGroupDataset:
    """Group-coordinated streaming consumer: the
    ``KafkaGroupIODataset`` analog.

    Fetches ONLY the partitions the coordinator assigns to this member,
    re-seeks to the group's committed offsets whenever the generation
    changes (worker joined/left/died), and commits consumed offsets
    after every delivered batch.
    """

    def __init__(self, topics: Sequence[str], member_id: str,
                 bootstrap_servers: str, coordinator: Tuple[str, int],
                 batch_size: int, parse: Callable[[list], dict],
                 poll_timeout: float = 0.2,
                 heartbeat_interval: float = 1.0,
                 max_batches: Optional[int] = None):
        self._topics = list(topics)
        self._member = member_id
        self._consumer = kafka_protocol.NativeKafkaConsumer(
            bootstrap_servers, client_id=member_id)
        self._consumer.subscribe(self._topics)
        self._coord = _CoordClient(*coordinator)
        self._batch_size = batch_size
        self._parse = parse
        self._poll_timeout = poll_timeout
        self._hb_interval = heartbeat_interval
        self._max_batches = max_batches
        self._generation = -1
        self._assigned: List[Tuple[str, int]] = []
        self._apply(self._coord.call(op="join", member=self._member))

    @property
    def assigned(self) -> List[Tuple[str, int]]:
        return list(self._assigned)

    def _apply(self, view: dict):
        """Adopt a coordinator view: restrict the consumer's fetch set
        to the assigned partitions at the group's committed offsets."""
        if view["generation"] == self._generation:
            return
        self._generation = view["generation"]
        old = set(self._assigned)
        old_pos = self._consumer.position()
        self._assigned = [tuple(tp) for tp in view["assigned"]]
        offsets = {}
        for k, off in view["offsets"].items():
            t, _, p = k.rpartition(":")
            tp = (t, int(p))
            # Partitions RETAINED across the rebalance keep their local
            # position when it is ahead of the group commit (avoids
            # re-training the current partial batch on every membership
            # change); newly ASSIGNED ones start at the group commit.
            offsets[tp] = (max(int(off), old_pos.get(tp, 0))
                           if tp in old else int(off))
        self._consumer._offsets = dict(offsets)
        self._consumer._positions = dict(offsets)
        # Drop fetched-not-consumed messages: revoked ones are stale,
        # retained ones re-fetch from the kept position (offsets ==
        # positions again, so no record is skipped or duplicated).
        self._consumer._buffer = []

    def _heartbeat(self):
        self._apply(self._coord.call(op="heartbeat",
                                     member=self._member))

    def _commit(self):
        """Commit the delivered positions at this member's generation; a
        refused commit (the member was fenced by a rebalance) adopts the
        new view, which drops the revoked partitions, and commits again
        what the member still owns."""
        for _ in range(_COMMIT_TRIES):
            pos = self._consumer.position()
            out = self._coord.call(op="commit", member=self._member,
                                   generation=self._generation,
                                   offsets={f"{t}:{p}": off
                                            for (t, p), off in pos.items()})
            if out["ok"]:
                return
            self._heartbeat()
        raise RuntimeError(f"member {self._member}: {_COMMIT_TRIES} commits "
                           f"refused in a row (the group keeps rebalancing)")

    def __iter__(self):
        buf: list = []
        emitted = 0
        idle = 0
        last_hb = 0.0
        while True:
            now = time.time()
            if now - last_hb >= self._hb_interval:
                self._heartbeat()
                last_hb = now
            if not self._assigned:
                time.sleep(self._poll_timeout)
                idle += 1
                if self._max_batches is not None and idle >= 20:
                    return
                continue
            msg = self._consumer.poll(self._poll_timeout)
            if msg is None or msg.error():
                idle += 1
                if self._max_batches is not None and idle >= 3:
                    # Drained: deliver the partial tail batch so a
                    # bounded run trains every record it consumed.
                    if buf:
                        yield self._parse(buf)
                        buf = []
                        self._commit()
                    return
                continue
            idle = 0
            buf.append(msg.value())
            if len(buf) == self._batch_size:
                batch = self._parse(buf)
                buf = []
                yield batch
                self._commit()
                emitted += 1
                if (self._max_batches is not None
                        and emitted >= self._max_batches):
                    return

    def close(self, graceful: bool = True):
        if graceful:
            try:
                self._coord.call(op="leave", member=self._member)
            except (ConnectionError, OSError):
                pass
        self._coord.close()
        self._consumer.close()


def coordinator_for_topics(bootstrap_servers: str,
                           topics: Sequence[str],
                           session_timeout: float = 10.0,
                           port: int = 0):
    """Convenience: discover partitions from the broker and start a
    coordinator server.  Returns (coordinator, server)."""
    host, _, bport = bootstrap_servers.partition(":")
    client = kafka_protocol.KafkaProtocolClient(host, int(bport or 9092),
                                                "coordinator")
    try:
        meta = client.metadata(list(topics))
    finally:
        client.close()
    parts = [(t, p) for t, ps in meta.items() for p in ps]
    coord = GroupCoordinator(parts, session_timeout=session_timeout)
    return coord, GroupCoordinatorServer(coord, port=port)
