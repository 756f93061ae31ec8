"""Port parity: the Kafka wire client, broker and ``KafkaDataset``.

* Message sets: the port's codec writes the JAX codec's bytes, each
  decodes the other's, CRC and truncation handled alike.
* Wire interop, both directions: the port's ``KafkaProtocolClient``
  against the JAX package's ``MiniKafkaBroker`` and the JAX client
  against the port's broker (metadata, produce offsets, fetch from an
  offset, a fetch cut at ``max_bytes``, ``MessageTooLarge``); the
  port's ``NativeKafkaConsumer`` against the JAX broker.
* ``KafkaDataset``: batches equal to the JAX ``KafkaDataset``'s on the
  same topic; a partial batch rewound on exit and ``state()`` resumed in
  a new dataset; ``ReplayStream``; the ``confluent_kafka`` gate.
* Online learning: a small WDL (B = 64, dim 8) trained 6 steps from a
  topic (native parse, ``batch_np_dict``, pack) equals, bit for bit,
  the same lines read through ``criteo_file_batches``, and again with a
  ``state()``/``restore_state()`` stop after step 3. The port's run
  alone: the JAX training of ``tests/test_kafka.py`` is not repeated.
"""

import os

import numpy as np
import pytest
import torch

from deeprec_tpu.data import kafka as jkafka
from deeprec_tpu.data import kafka_protocol as jkp
from deeprec_tpu_torch.data import kafka as tkafka
from deeprec_tpu_torch.data import kafka_protocol as tkp

torch.set_num_threads(1)

POLL = 0.05


@pytest.fixture()
def jbroker():
    b = jkp.MiniKafkaBroker(num_partitions=2)
    yield b
    b.shutdown()


@pytest.fixture()
def tbroker():
    b = tkp.MiniKafkaBroker(num_partitions=2)
    yield b
    b.shutdown()


RECORD_SETS = [
    [(None, b"v0"), (b"k1", b"v1"), (b"", b"")],
    [(None, bytes(range(256)) * 3)],
    [(b"key", f"value {i}".encode()) for i in range(50)],
    [],
]


@pytest.mark.parametrize("i", range(len(RECORD_SETS)))
@pytest.mark.parametrize("base", [0, 7, 2**40])
def test_message_sets_byte_equal(i, base):
    recs = RECORD_SETS[i]
    blob = tkp.encode_message_set(recs, base_offset=base)
    assert blob == jkp.encode_message_set(recs, base_offset=base)
    assert tkp.decode_message_set(blob) == jkp.decode_message_set(blob)
    if blob:
        # A trailing partial message is dropped alike; a flipped byte
        # fails both CRC checks.
        assert tkp.decode_message_set(blob[:-3]) == \
            jkp.decode_message_set(blob[:-3])
        bad = bytearray(blob)
        bad[-1] ^= 0xFF
        for codec in (tkp, jkp):
            with pytest.raises(ValueError, match="CRC"):
                codec.decode_message_set(bytes(bad))


def _wire_roundtrip(client_mod, broker):
    c = client_mod.KafkaProtocolClient(broker.host, broker.port)
    try:
        assert c.metadata(["clicks"]) == {"clicks": [0, 1]}
        assert c.produce("clicks", 0, [(None, b"a"), (b"k", b"b")]) == 0
        assert c.produce("clicks", 0, [(None, b"c")]) == 2
        records, hwm = c.fetch("clicks", 0, 0)
        got = [(o, k, v) for o, k, v in records]
        assert got == [(0, None, b"a"), (1, b"k", b"b"), (2, None, b"c")]
        assert hwm == 3
        assert [v for _, _, v in c.fetch("clicks", 0, 2)[0]] == [b"c"]
        assert c.fetch("clicks", 1, 0) == ([], 0)
        c.produce("big", 0, [(None, bytes(100)) for _ in range(50)])
        seen, off = 0, 0
        while seen < 50:
            recs, hwm = c.fetch("big", 0, off, max_bytes=500)
            assert 0 < len(recs) < 50 and hwm == 50
            seen += len(recs)
            off = recs[-1][0] + 1
        c.produce("huge", 0, [(None, bytes(4096))])
        with pytest.raises(ValueError, match="exceeds"):
            c.fetch("huge", 0, 0, max_bytes=1024)
    finally:
        c.close()


def test_port_client_against_jax_broker(jbroker):
    _wire_roundtrip(tkp, jbroker)


def test_jax_client_against_port_broker(tbroker):
    _wire_roundtrip(jkp, tbroker)


def test_port_consumer_against_jax_broker(jbroker):
    prod = jkp.KafkaProtocolClient(jbroker.host, jbroker.port)
    prod.produce("t", 0, [(None, f"p0-{i}".encode()) for i in range(3)])
    prod.produce("t", 1, [(None, f"p1-{i}".encode()) for i in range(2)])
    prod.close()
    cons = tkp.NativeKafkaConsumer(jbroker.bootstrap)
    cons.subscribe(["t"])
    got = set()
    for _ in range(20):
        msg = cons.poll(POLL)
        if msg is not None:
            got.add(msg.value())
        if len(got) == 5:
            break
    assert got == {b"p0-0", b"p0-1", b"p0-2", b"p1-0", b"p1-1"}
    assert cons.position() == {("t", 0): 3, ("t", 1): 2}
    cons.seek("t", 1, 0)
    assert cons.poll(POLL).value() == b"p1-0"
    cons.close()


def _parse_ints(msgs):
    return {"x": np.array([int(m) for m in msgs])}


def _produce(broker, topic, values, parts=1):
    c = tkp.KafkaProtocolClient(broker.host, broker.port)
    try:
        c.metadata([topic])
        for p in range(parts):
            mine = values[p::parts]
            if mine:
                c.produce(topic, p, [(None, v) for v in mine])
    finally:
        c.close()


@pytest.mark.parametrize("broker_kind", ["port", "jax"])
def test_kafka_dataset_batches_equal_jax(broker_kind, jbroker, tbroker):
    broker = tbroker if broker_kind == "port" else jbroker
    _produce(broker, "s", [str(i).encode() for i in range(26)], parts=2)
    got = []
    for mod in (tkafka, jkafka):
        ds = mod.KafkaDataset(["s"], "g", broker.bootstrap, batch_size=4,
                              parse=_parse_ints, poll_timeout=POLL,
                              max_batches=100)
        got.append(([b["x"].tolist() for b in ds], ds.state()))
        ds.close()
    assert got[0] == got[1]
    batches, state = got[0]
    assert len(batches) == 6
    assert len(set(sum(batches, []))) == 24
    # 2 records were polled into a partial batch and rewound.
    assert sum(state.values()) == 24


def test_kafka_dataset_partial_batch_rewind_and_resume(tbroker):
    _produce(tbroker, "pb", [str(i).encode() for i in range(6)])
    ds = tkafka.KafkaDataset(["pb"], "g", tbroker.bootstrap, batch_size=4,
                             parse=_parse_ints, poll_timeout=POLL,
                             max_batches=2)
    batches = list(ds)        # one full batch; 2 polled into a partial
    assert [b["x"].tolist() for b in batches] == [[0, 1, 2, 3]]
    state = ds.state()
    assert state == {"pb:0": 4, "pb:1": 0}
    ds.close()
    _produce(tbroker, "pb", [b"6", b"7"])
    ds2 = tkafka.KafkaDataset(["pb"], "g", tbroker.bootstrap, batch_size=4,
                              parse=_parse_ints, poll_timeout=POLL,
                              max_batches=1)
    ds2.restore_state(state)
    assert [b["x"].tolist() for b in ds2] == [[4, 5, 6, 7]]
    assert ds2.state() == {"pb:0": 8, "pb:1": 0}
    ds2.close()


def test_replay_stream(tmp_path):
    p = tmp_path / "replay.txt"
    p.write_bytes(b"1\n2\n3\n4\n5\n")
    parse = lambda ms: [int(m) for m in ms]  # noqa: E731
    got = list(tkafka.ReplayStream(str(p), batch_size=2, parse=parse))
    assert got == list(jkafka.ReplayStream(str(p), batch_size=2,
                                           parse=parse)) == [[1, 2], [3, 4]]
    loop = iter(tkafka.ReplayStream(str(p), 2, parse, loop=True))
    assert [next(loop) for _ in range(3)] == [[1, 2], [3, 4], [1, 2]]


def test_confluent_kafka_gate(tbroker):
    if tkafka.HAVE_KAFKA:
        pytest.fail("this environment is not expected to have "
                    "confluent_kafka")
    with pytest.raises(ImportError, match="confluent_kafka"):
        tkafka.KafkaDataset(["t"], "g", tbroker.bootstrap, 4, _parse_ints,
                            use_native=False)


# -- online learning ----------------------------------------------------------

B = 64
STEPS = 6
STOP = 3


def _trainer():
    from deeprec_tpu_torch.feature_column.feature_column import (
        EmbeddingGroup)
    from deeprec_tpu_torch.layers.core import init_dense
    from deeprec_tpu_torch.models import wdl
    from deeprec_tpu_torch.optimizers import dense, sparse
    from deeprec_tpu_torch.train import loop, losses

    group = EmbeddingGroup(wdl.criteo_columns(embedding_dim=8,
                                              capacity=1 << 12),
                           coalesce=True)
    model = wdl.WDL(wdl.input_width(group), hidden=(16, 8),
                    dtype=torch.float32, device="cpu")
    init_dense(model, torch.Generator().manual_seed(0))
    sopt, dopt = sparse.SparseAdagrad(0.05), dense.Adagrad(0.05)
    ts = loop.create_train_state(group, model.state_dict(), dopt, sopt,
                                 "cpu")
    step = loop.make_train_step(
        group, wdl.apply_fn(model, group),
        lambda o, b: losses.bce_with_logits(o, b["label"]), sopt, dopt)
    return group, ts, step


def _train(group, ts, step, raws):
    from deeprec_tpu_torch.train import loop
    ts = loop.clone_state(ts)
    out = []
    for raw in raws:
        ts, m = step(ts, group.pack_batch_np(raw, "cpu"))
        out.append(float(m["loss"]))
        assert int(m["n_overflow"]) == 0
    return out, ts


def _parse_criteo(msgs):
    from deeprec_tpu_torch import native
    from deeprec_tpu_torch.data import criteo
    rows, labels, dense, cats, _ = native.parse_criteo(
        b"\n".join(msgs) + b"\n", len(msgs))
    assert rows == len(msgs)
    return criteo.batch_np_dict(labels, dense, cats)


def test_online_training_from_kafka_equals_file(tbroker, tmp_path):
    from deeprec_tpu_torch import bench
    from deeprec_tpu_torch.data import criteo
    from deeprec_tpu_torch.embedding import variable as ev

    path = os.path.join(tmp_path, "criteo.tsv")
    bench.write_tsv(path, STEPS * B, criteo.SyntheticCriteo(
        B, vocab=1000, seed=7))
    with open(path, "rb") as f:
        lines = f.read().splitlines()
    _produce(tbroker, "train", lines)
    group, ts0, step = _trainer()
    file_raws = list(criteo.criteo_file_batches(path, B, as_numpy=True))
    want, want_ts = _train(group, ts0, step, file_raws)

    def stream(max_batches, state=None):
        ds = tkafka.KafkaDataset(["train"], "online", tbroker.bootstrap,
                                 batch_size=B, parse=_parse_criteo,
                                 poll_timeout=POLL, max_batches=max_batches)
        if state is not None:
            ds.restore_state(state)
        raws = list(ds)
        return raws, ds

    raws, ds = stream(STEPS)
    ds.close()
    got, got_ts = _train(group, ts0, step, raws)
    first, ds = stream(STOP)
    state = ds.state()
    ds.close()
    assert state == {"train:0": STOP * B, "train:1": 0}
    rest, ds = stream(STEPS - STOP, state)
    ds.close()
    resumed, res_ts = _train(group, ts0, step, first + rest)
    assert got == want and resumed == want, (got, resumed, want)
    for t, cfg in group.tables.items():
        w = ev.export_arrays(cfg, want_ts.ev[t])
        for other in (got_ts, res_ts):
            g = ev.export_arrays(cfg, other.ev[t])
            np.testing.assert_array_equal(g["keys"], w["keys"])
            np.testing.assert_array_equal(g["values"], w["values"])
    for k, v in want_ts.params.items():
        assert torch.equal(got_ts.params[k], v)
        assert torch.equal(res_ts.params[k], v)
