"""Minimal Kafka wire protocol (v0) client and in-process broker.

Port of ``deeprec_tpu/data/kafka_protocol.py``, copied from the
reference module (stdlib-only: socket, struct, zlib; the port imports
nothing of the JAX package). The wire format is byte for byte the
reference copy's, so this client talks to the JAX package's broker and
the JAX client to this broker.

The reference consumes Kafka through librdkafka
(``core/kernels/data/kafka_dataset_op.cc``, ``docs/KafkaDataset.md``);
its cluster-free test strategy is in-process servers speaking the real
protocol (``distributed_runtime/rpc/grpc_testlib.h``). This module is
both at once: a dependency-free client speaking the Kafka binary
protocol over TCP (Metadata/Produce/Fetch, message-set v0 with CRC
checks), and ``MiniKafkaBroker``, an in-process broker for tests and
offline use (its fetch encodes only the messages a reply holds; the
reply's bytes are the reference broker's). ``KafkaDataset``
(``data/kafka.py``) uses this client when ``confluent_kafka`` is
absent.

Scope: consumer-group coordination (JoinGroup/SyncGroup/OffsetCommit)
is not in the wire client. The consumer assigns itself every partition
of the subscribed topics and tracks offsets client-side; the group
plane is ``data/kafka_group.py``'s own coordinator.
"""

from __future__ import annotations

import io
import itertools
import socket
import socketserver
import struct
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

API_PRODUCE = 0
API_FETCH = 1
API_METADATA = 3

_ERR_NONE = 0
_ERR_UNKNOWN_TOPIC = 3
_ERR_OFFSET_OUT_OF_RANGE = 1


class MessageTooLarge(ValueError):
    """A fetch returned bytes but no complete message: the first record
    at the requested offset exceeds the client's ``max_bytes``.  The
    consumer reacts by growing its fetch size (librdkafka's
    ``fetch.message.max.bytes`` adaptation); surfacing it beats the
    silent forever-retry loop a naive client falls into."""


# ---------------------------------------------------------------- wire


class _Writer:
    def __init__(self):
        self._b = io.BytesIO()

    def i8(self, v):
        self._b.write(struct.pack(">b", v))

    def i16(self, v):
        self._b.write(struct.pack(">h", v))

    def i32(self, v):
        self._b.write(struct.pack(">i", v))

    def i64(self, v):
        self._b.write(struct.pack(">q", v))

    def string(self, s: Optional[str]):
        if s is None:
            self.i16(-1)
        else:
            raw = s.encode()
            self.i16(len(raw))
            self._b.write(raw)

    def bytes_(self, raw: Optional[bytes]):
        if raw is None:
            self.i32(-1)
        else:
            self.i32(len(raw))
            self._b.write(raw)

    def raw(self, data: bytes):
        self._b.write(data)

    def value(self) -> bytes:
        return self._b.getvalue()


class _Reader:
    def __init__(self, data: bytes):
        self._b = memoryview(data)
        self._o = 0

    def _take(self, n) -> memoryview:
        v = self._b[self._o:self._o + n]
        if len(v) != n:
            raise EOFError("short kafka frame")
        self._o += n
        return v

    def i8(self):
        return struct.unpack(">b", self._take(1))[0]

    def i16(self):
        return struct.unpack(">h", self._take(2))[0]

    def i32(self):
        return struct.unpack(">i", self._take(4))[0]

    def i64(self):
        return struct.unpack(">q", self._take(8))[0]

    def string(self) -> Optional[str]:
        n = self.i16()
        return None if n < 0 else bytes(self._take(n)).decode()

    def bytes_(self) -> Optional[bytes]:
        n = self.i32()
        return None if n < 0 else bytes(self._take(n))

    def remaining(self) -> int:
        return len(self._b) - self._o


def encode_message_set(records: Sequence[Tuple[Optional[bytes], bytes]],
                       base_offset: int = 0) -> bytes:
    """v0 message set: [offset i64, size i32, crc i32, magic, attrs,
    key bytes, value bytes]*  — crc covers magic..value."""
    w = _Writer()
    for i, (key, value) in enumerate(records):
        m = _Writer()
        m.i8(0)          # magic v0
        m.i8(0)          # attributes (no compression)
        m.bytes_(key)
        m.bytes_(value)
        body = m.value()
        crc = zlib.crc32(body) & 0xFFFFFFFF
        w.i64(base_offset + i)
        w.i32(4 + len(body))
        w.raw(struct.pack(">I", crc))
        w.raw(body)
    return w.value()


def decode_message_set(data: bytes) -> List[Tuple[int, Optional[bytes],
                                                  bytes]]:
    """-> [(offset, key, value)].  Tolerates a trailing partial message
    (brokers truncate at max_bytes)."""
    out = []
    r = _Reader(data)
    while r.remaining() >= 12:
        offset = r.i64()
        size = r.i32()
        if r.remaining() < size:
            break  # partial trailing message
        crc = struct.unpack(">I", r._take(4))[0]
        body = bytes(r._take(size - 4))
        # CRC is verified BEFORE parsing fields so a corrupted length
        # can't turn into a confusing short-frame error.
        if (zlib.crc32(body) & 0xFFFFFFFF) != crc:
            raise ValueError("kafka message CRC mismatch")
        br = _Reader(body)
        magic = br.i8()
        br.i8()  # attributes
        key = br.bytes_()
        value = br.bytes_()
        if magic != 0:
            raise ValueError(f"unsupported message magic {magic}")
        out.append((offset, key, value if value is not None else b""))
    return out


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack(">i", len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("kafka peer closed")
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket) -> bytes:
    (n,) = struct.unpack(">i", _recv_exact(sock, 4))
    return _recv_exact(sock, n)


# --------------------------------------------------------------- client


class KafkaProtocolClient:
    """Blocking single-connection Kafka v0 client (metadata, produce,
    fetch).  One instance per broker connection; thread-compatible when
    externally serialized (the consumer below owns one)."""

    def __init__(self, host: str, port: int, client_id: str = "deeprec",
                 timeout: float = 30.0):
        self._sock = socket.create_connection((host, port), timeout)
        self._client_id = client_id
        self._corr = 0
        self._lock = threading.Lock()

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass

    def _request(self, api_key: int, body: bytes) -> _Reader:
        with self._lock:
            self._corr += 1
            corr = self._corr
            w = _Writer()
            w.i16(api_key)
            w.i16(0)  # api_version 0
            w.i32(corr)
            w.string(self._client_id)
            w.raw(body)
            _send_frame(self._sock, w.value())
            r = _Reader(_recv_frame(self._sock))
        got = r.i32()
        if got != corr:
            raise ValueError(f"correlation id mismatch {got} != {corr}")
        return r

    def metadata(self, topics: Sequence[str]) -> Dict[str, List[int]]:
        """-> {topic: [partition ids]} (errors raise)."""
        w = _Writer()
        w.i32(len(topics))
        for t in topics:
            w.string(t)
        r = self._request(API_METADATA, w.value())
        for _ in range(r.i32()):  # brokers
            r.i32(), r.string(), r.i32()
        out: Dict[str, List[int]] = {}
        for _ in range(r.i32()):  # topics
            err = r.i16()
            name = r.string()
            parts = []
            for _ in range(r.i32()):
                r.i16()          # partition error
                parts.append(r.i32())
                r.i32()          # leader
                for _ in range(r.i32()):
                    r.i32()      # replicas
                for _ in range(r.i32()):
                    r.i32()      # isr
            if err not in (_ERR_NONE,):
                raise ValueError(f"metadata error {err} for topic {name}")
            out[name] = sorted(parts)
        return out

    def produce(self, topic: str, partition: int,
                records: Sequence[Tuple[Optional[bytes], bytes]]) -> int:
        """-> base offset assigned by the broker."""
        mset = encode_message_set(records)
        w = _Writer()
        w.i16(1)   # required_acks
        w.i32(10_000)
        w.i32(1)   # one topic
        w.string(topic)
        w.i32(1)   # one partition
        w.i32(partition)
        w.i32(len(mset))
        w.raw(mset)
        r = self._request(API_PRODUCE, w.value())
        r.i32()        # topic count
        r.string()
        r.i32()        # partition count
        r.i32()
        err = r.i16()
        base = r.i64()
        if err != _ERR_NONE:
            raise ValueError(f"produce error {err}")
        return base

    def fetch(self, topic: str, partition: int, offset: int,
              max_bytes: int = 1 << 20, max_wait_ms: int = 100,
              ) -> Tuple[List[Tuple[int, Optional[bytes], bytes]], int]:
        """-> ([(offset, key, value)], high_watermark)."""
        w = _Writer()
        w.i32(-1)  # replica_id
        w.i32(max_wait_ms)
        w.i32(1)   # min_bytes
        w.i32(1)   # one topic
        w.string(topic)
        w.i32(1)
        w.i32(partition)
        w.i64(offset)
        w.i32(max_bytes)
        r = self._request(API_FETCH, w.value())
        r.i32()        # topic count
        r.string()
        r.i32()        # partition count
        r.i32()
        err = r.i16()
        hwm = r.i64()
        mset = r.bytes_() or b""
        if err == _ERR_OFFSET_OUT_OF_RANGE:
            return [], hwm
        if err != _ERR_NONE:
            raise ValueError(f"fetch error {err}")
        records = decode_message_set(mset)
        if not records and len(mset) > 0:
            raise MessageTooLarge(
                f"first message at {topic}:{partition}@{offset} exceeds "
                f"max_bytes={max_bytes}")
        return records, hwm


class NativeKafkaConsumer:
    """confluent_kafka.Consumer-shaped facade over the protocol client
    (subscribe/poll/close), self-assigning all partitions."""

    class _Msg:
        __slots__ = ("_value", "_topic", "_partition", "_offset")

        def __init__(self, value, topic, partition, offset):
            self._value, self._topic = value, topic
            self._partition, self._offset = partition, offset

        def value(self):
            return self._value

        def topic(self):
            return self._topic

        def partition(self):
            return self._partition

        def offset(self):
            return self._offset

        def error(self):
            return None

    def __init__(self, bootstrap_servers: str, start_at: str = "earliest",
                 client_id: str = "deeprec"):
        host, _, port = bootstrap_servers.partition(":")
        self._client = KafkaProtocolClient(host, int(port or 9092),
                                           client_id)
        self._start_at = start_at
        # _offsets = next offset to FETCH (internal, runs ahead of the
        # app); _positions = next offset the APP has not yet received
        # from poll().  Checkpoint state must use _positions: persisting
        # fetch offsets would skip every record sitting in _buffer at
        # save time.
        self._offsets: Dict[Tuple[str, int], int] = {}
        self._positions: Dict[Tuple[str, int], int] = {}
        self._buffer: List[NativeKafkaConsumer._Msg] = []
        self._topics: List[str] = []
        self._rr = 0                      # round-robin fetch start
        self._max_bytes = 1 << 20         # grows on MessageTooLarge

    def subscribe(self, topics: Sequence[str]):
        self._topics = list(topics)
        meta = self._client.metadata(self._topics)
        for t, parts in meta.items():
            for p in parts:
                self._offsets.setdefault((t, p), 0)
                self._positions.setdefault((t, p), 0)

    def poll(self, timeout: float = 1.0):
        if self._buffer:
            msg = self._buffer.pop(0)
            self._positions[(msg.topic(), msg.partition())] = \
                msg.offset() + 1
            return msg
        wait_ms = max(1, int(timeout * 1000))
        # True round-robin: rotate the starting partition across polls
        # so a partition with steady backlog cannot starve the others.
        parts = list(self._offsets.items())
        if not parts:
            return None
        start = self._rr % len(parts)
        order = parts[start:] + parts[:start]
        for i, ((t, p), off) in enumerate(order):
            while True:
                try:
                    records, _ = self._client.fetch(
                        t, p, off, max_bytes=self._max_bytes,
                        max_wait_ms=wait_ms)
                    break
                except MessageTooLarge:
                    # Grow the fetch budget until the record fits;
                    # caps at 1 GiB to keep a corrupt size field from
                    # ballooning memory.
                    if self._max_bytes >= (1 << 30):
                        raise
                    self._max_bytes *= 2
            for roff, _key, value in records:
                self._buffer.append(self._Msg(value, t, p, roff))
            if records:
                self._offsets[(t, p)] = records[-1][0] + 1
                # Next poll starts at the partition AFTER this one.
                self._rr = (start + i + 1) % len(parts)
                break  # drain one partition per poll
        if not self._buffer:
            return None
        msg = self._buffer.pop(0)
        self._positions[(msg.topic(), msg.partition())] = msg.offset() + 1
        return msg

    def position(self) -> Dict[Tuple[str, int], int]:
        """Next offset the application has NOT yet consumed, per
        partition — the resume point a checkpoint must record."""
        return dict(self._positions)

    def seek(self, topic: str, partition: int, offset: int):
        self._offsets[(topic, partition)] = offset
        self._positions[(topic, partition)] = offset
        # Fetched-not-consumed messages for this partition are stale.
        self._buffer = [m for m in self._buffer
                        if (m.topic(), m.partition()) != (topic, partition)]

    def close(self):
        self._client.close()


# --------------------------------------------------------------- broker


class _PartitionLog:
    def __init__(self):
        self.records: List[Tuple[Optional[bytes], bytes]] = []

    def append(self, recs) -> int:
        base = len(self.records)
        self.records.extend(recs)
        return base


class MiniKafkaBroker:
    """In-process single-node Kafka broker speaking protocol v0
    (Metadata/Produce/Fetch) — the test-harness double for the real
    cluster, mirroring the reference's in-process server approach
    (``grpc_testlib``).  Topics auto-create with ``num_partitions``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 num_partitions: int = 2):
        self._logs: Dict[Tuple[str, int], _PartitionLog] = {}
        self._topics: Dict[str, int] = {}
        self._num_partitions = num_partitions
        self._lock = threading.Lock()
        broker = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        frame = _recv_frame(self.request)
                        resp = broker._handle(frame)
                        _send_frame(self.request, resp)
                except (ConnectionError, EOFError, OSError):
                    pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def bootstrap(self) -> str:
        return f"{self.host}:{self.port}"

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()

    def _topic(self, name: str) -> List[int]:
        with self._lock:
            if name not in self._topics:
                self._topics[name] = self._num_partitions
                for p in range(self._num_partitions):
                    self._logs[(name, p)] = _PartitionLog()
            return list(range(self._topics[name]))

    def _handle(self, frame: bytes) -> bytes:
        r = _Reader(frame)
        api_key = r.i16()
        r.i16()             # api_version (only 0 served)
        corr = r.i32()
        r.string()          # client_id
        w = _Writer()
        w.i32(corr)
        if api_key == API_METADATA:
            self._metadata(r, w)
        elif api_key == API_PRODUCE:
            self._produce(r, w)
        elif api_key == API_FETCH:
            self._fetch(r, w)
        else:
            raise ValueError(f"unsupported api_key {api_key}")
        return w.value()

    def _metadata(self, r: _Reader, w: _Writer):
        n = r.i32()
        topics = [r.string() for _ in range(n)]
        if not topics:
            topics = list(self._topics)
        w.i32(1)                       # brokers
        w.i32(0)
        w.string(self.host)
        w.i32(self.port)
        w.i32(len(topics))
        for t in topics:
            parts = self._topic(t)
            w.i16(_ERR_NONE)
            w.string(t)
            w.i32(len(parts))
            for p in parts:
                w.i16(_ERR_NONE)
                w.i32(p)
                w.i32(0)               # leader = this broker
                w.i32(1), w.i32(0)     # replicas [0]
                w.i32(1), w.i32(0)     # isr [0]

    def _produce(self, r: _Reader, w: _Writer):
        r.i16()  # required_acks
        r.i32()  # timeout
        results = []
        for _ in range(r.i32()):
            topic = r.string()
            for _ in range(r.i32()):
                part = r.i32()
                size = r.i32()
                mset = bytes(r._take(size))
                recs = [(k, v) for _off, k, v in decode_message_set(mset)]
                self._topic(topic)
                with self._lock:
                    base = self._logs[(topic, part)].append(recs)
                results.append((topic, part, base))
        w.i32(len(results))
        for topic, part, base in results:
            w.string(topic)
            w.i32(1)
            w.i32(part)
            w.i16(_ERR_NONE)
            w.i64(base)

    def _fetch(self, r: _Reader, w: _Writer):
        r.i32()  # replica_id
        r.i32()  # max_wait
        r.i32()  # min_bytes
        req = []
        for _ in range(r.i32()):
            topic = r.string()
            for _ in range(r.i32()):
                part = r.i32()
                offset = r.i64()
                max_bytes = r.i32()
                req.append((topic, part, offset, max_bytes))
        w.i32(len(req))
        for topic, part, offset, max_bytes in req:
            self._topic(topic)
            with self._lock:
                recs = self._logs[(topic, part)].records
                hwm = len(recs)
                # Whole messages up to max_bytes (26 bytes of framing
                # each: offset, size, crc, magic, attributes and the two
                # lengths), encoded alone, rather than the whole tail of
                # the log cut after: the same bytes, at the cost of the
                # reply.
                taken = size = 0
                for key, value in itertools.islice(recs, offset, None):
                    size += 26 + len(key or b"") + len(value)
                    if size > max_bytes:
                        break
                    taken += 1
                chunk = recs[offset:offset + max(taken, 1)]
            mset = encode_message_set(chunk, base_offset=offset)
            if not taken:
                # The first message alone exceeds max_bytes: real Kafka
                # sends a PARTIAL message (the client sees bytes but
                # decodes zero records and grows its fetch size).
                # Sending an empty set instead would make the consumer
                # spin at this offset forever.
                mset = mset[:max_bytes]
            w.string(topic)
            w.i32(1)
            w.i32(part)
            w.i16(_ERR_NONE)
            w.i64(hwm)
            w.i32(len(mset))
            w.raw(mset)
