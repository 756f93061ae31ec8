"""KafkaDataset: streaming online-learning input.

Port of ``deeprec_tpu/data/kafka.py`` (the reference's KafkaDataset /
KafkaGroupIODataset, ``core/kernels/data/kafka_dataset_op.cc``,
``docs/KafkaDataset.md``): consume training samples from Kafka topics
for online learning.

Client: ``confluent_kafka`` (librdkafka) where it is installed, else
the port's dependency-free wire client (``data/kafka_protocol.py``),
which the tests drive against ``MiniKafkaBroker``. ``ReplayStream``
gives the same interface over a file, for offline replay.

``parse`` is the caller's: the dataset yields whatever it returns for a
list of raw message values. Online training of a ``bench.py`` model
passes one that parses the lines with ``native.parse_criteo``, builds
``data.criteo.batch_np_dict`` and packs it onto the step's device.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

from deeprec_tpu_torch.data import kafka_protocol

try:  # environment probe
    import confluent_kafka  # type: ignore

    HAVE_KAFKA = True
except ImportError:
    confluent_kafka = None
    HAVE_KAFKA = False


class KafkaDataset:
    """Iterate messages from Kafka topics; ``parse`` maps a list of
    ``batch_size`` raw message values to one batch.

    Offsets are exposed through ``state()``/``restore_state()`` so an
    online-learning job resumes its stream position from a checkpoint
    (the saveable-resource pattern of the reference's
    ``work_queue.py:113``); native client only, as librdkafka keeps group
    offsets on the broker.
    """

    def __init__(self, topics: Sequence[str], group_id: str,
                 bootstrap_servers: str, batch_size: int,
                 parse: Callable[[list], dict],
                 poll_timeout: float = 1.0,
                 max_batches: Optional[int] = None,
                 use_native: Optional[bool] = None):
        native = (not HAVE_KAFKA) if use_native is None else use_native
        if native:
            self._consumer = kafka_protocol.NativeKafkaConsumer(
                bootstrap_servers, client_id=group_id)
        else:
            if confluent_kafka is None:
                raise ImportError("use_native=False needs confluent_kafka, "
                                  "which is not installed")
            self._consumer = confluent_kafka.Consumer({
                "bootstrap.servers": bootstrap_servers,
                "group.id": group_id,
                "auto.offset.reset": "earliest",
            })
        self._native = native
        self._consumer.subscribe(list(topics))
        self._batch_size = batch_size
        self._parse = parse
        self._poll_timeout = poll_timeout
        self._max_batches = max_batches

    def state(self) -> Dict[str, int]:
        """``{"topic:partition": next offset not yet delivered}``."""
        if not self._native:
            raise NotImplementedError("state() requires the native client")
        return {f"{t}:{p}": off
                for (t, p), off in self._consumer.position().items()}

    def restore_state(self, state: Dict[str, int]) -> None:
        if not self._native:
            raise NotImplementedError(
                "restore_state() requires the native client")
        for key, off in state.items():
            topic, _, part = key.rpartition(":")
            self._consumer.seek(topic, int(part), int(off))

    def close(self):
        self._consumer.close()

    def __iter__(self) -> Iterator[dict]:
        buf = []
        # (topic, partition) -> offset of the first message in ``buf``
        # from that partition. Messages polled into a partial batch were
        # taken from the client but never delivered; on exit the
        # consumer is rewound to them, so ``state()`` (and iterating
        # again) skips no record at a boundary that is not a batch's.
        inflight: Dict[Tuple[str, int], int] = {}
        emitted = 0
        idle = 0
        try:
            while True:
                msg = self._consumer.poll(self._poll_timeout)
                if msg is None or msg.error():
                    idle += 1
                    # A bounded run (``max_batches``) stops once the
                    # stream is drained.
                    if self._max_batches is not None and idle >= 3:
                        return
                    continue
                idle = 0
                buf.append(msg.value())
                if self._native:
                    inflight.setdefault(
                        (msg.topic(), msg.partition()), msg.offset())
                if len(buf) == self._batch_size:
                    batch = self._parse(buf)
                    buf = []
                    inflight.clear()
                    yield batch
                    emitted += 1
                    if (self._max_batches is not None
                            and emitted >= self._max_batches):
                        return
        finally:
            if self._native:
                for (t, p), off in inflight.items():
                    self._consumer.seek(t, p, off)


class ReplayStream:
    """File-backed stand-in with the KafkaDataset interface (one raw
    record per line), for tests and offline replay of online jobs."""

    def __init__(self, path: str, batch_size: int,
                 parse: Callable[[list], dict], loop: bool = False):
        self._path = path
        self._batch_size = batch_size
        self._parse = parse
        self._loop = loop

    def __iter__(self) -> Iterator[dict]:
        while True:
            buf = []
            with open(self._path, "rb") as f:
                for line in f:
                    buf.append(line.rstrip(b"\n"))
                    if len(buf) == self._batch_size:
                        yield self._parse(buf)
                        buf = []
            if not self._loop:
                return
