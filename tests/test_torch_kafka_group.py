"""Port parity: Kafka consumer-group coordination (``data/kafka_group.py``).

* ``GroupCoordinator``: assignment, generations and the session timeout
  (short timeouts, as ``tests/test_kafka_group.py``), and the offsets'
  checkpoint round trip: every view equal to the JAX package's
  coordinator's for the same call sequence.
* ``KafkaGroupDataset`` over the port's broker and coordinator server:
  two members read disjoint streams whose union is the topic, each
  member the records the JAX package's classes give it; after one
  member leaves, the other resumes its partitions from the committed
  offsets, so the group trains every record once.
* The generation fence (fault 3.4 of ROADMAP.md §3, a fault of the
  reference): a member fenced by a rebalance commits at its old
  generation; the JAX coordinator takes the offsets, the port's refuses
  and leaves them unchanged, and so it refuses a member that has left.
  A fenced ``KafkaGroupDataset`` adopts the new view and commits again
  only what it still owns.
"""

import time

import pytest
import torch

from deeprec_tpu.data import kafka_group as jkg
from deeprec_tpu_torch.data import kafka_group as tkg
from deeprec_tpu_torch.data import kafka_protocol as tkp

torch.set_num_threads(1)

PARTS = [("t", p) for p in range(4)]


def _pair(parts=PARTS, timeout=60.0):
    return (tkg.GroupCoordinator(parts, session_timeout=timeout),
            jkg.GroupCoordinator(parts, session_timeout=timeout))


def _both(pair, op, *args):
    """``op`` on both coordinators; their answers must be equal."""
    got, want = (getattr(c, op)(*args) for c in pair)
    assert got == want, (op, args, got, want)
    return got


def test_assignment_and_generations_equal_jax():
    pair = _pair()
    v = _both(pair, "join", "a")
    assert len(v["assigned"]) == 4 and v["generation"] == 1
    _both(pair, "join", "b")
    a = _both(pair, "heartbeat", "a")
    b = _both(pair, "heartbeat", "b")
    assert a["generation"] == b["generation"] == 2
    got_a = {tuple(tp) for tp in a["assigned"]}
    got_b = {tuple(tp) for tp in b["assigned"]}
    assert got_a | got_b == set(PARTS) and not got_a & got_b
    _both(pair, "join", "c")
    for m in ("a", "b", "c"):
        _both(pair, "heartbeat", m)
    _both(pair, "leave", "b")
    _both(pair, "leave", "b")            # a second leave changes nothing
    assert len(_both(pair, "heartbeat", "a")["assigned"]) == 2
    _both(pair, "leave", "c")
    assert _both(pair, "heartbeat", "a")["generation"] == 5
    _both(pair, "heartbeat", "z")        # never joined: a heartbeat joins
    assert len(_both(pair, "heartbeat", "a")["assigned"]) == 2


def test_session_timeout_equal_jax():
    pair = _pair([("t", 0), ("t", 1)], timeout=0.0)
    _both(pair, "join", "dead")
    time.sleep(0.01)
    v = _both(pair, "join", "live")      # joining expires the dead member
    assert len(v["assigned"]) == 2
    time.sleep(0.01)
    _both(pair, "heartbeat", "dead")     # expired members rejoin


def test_offsets_checkpoint_roundtrip_equal_jax():
    pair = _pair([("t", 0), ("t", 1)])
    v = _both(pair, "join", "a")
    t, j = pair
    assert t.commit("a", {"t:0": 7, "t:1": 3}, v["generation"])["ok"]
    j.commit("a", {"t:0": 7, "t:1": 3})
    assert t.commit("a", {"t:0": 5}, v["generation"])["ok"]   # no rewind
    j.commit("a", {"t:0": 5})
    _both(pair, "committed")
    st = _both(pair, "state")
    pair2 = _pair([("t", 0), ("t", 1)])
    for c in pair2:
        c.restore_state(st)
    assert _both(pair2, "join", "a")["offsets"] == {"t:0": 7, "t:1": 3}


def test_fenced_commit_is_refused():
    """Fault 3.4: the JAX coordinator takes a fenced member's offsets."""
    pair = _pair()
    t, j = pair
    old = _both(pair, "join", "a")["generation"]
    new = _both(pair, "join", "b")["generation"]
    assert new == old + 1
    # "a" has not seen the rebalance: its view still owns ("t", 1),
    # which "b" now owns.
    offsets = {"t:1": 9, "t:0": 4}
    j.commit("a", offsets)
    assert j.committed() == offsets              # the reference's fault
    assert t.commit("a", offsets, old) == {"ok": False, "generation": new}
    assert t.committed() == {}
    assert t.commit("a", offsets, None)["ok"] is False
    # At the current generation the commit is taken.
    assert t.heartbeat("a")["generation"] == new
    assert t.commit("a", {"t:0": 4}, new) == {"ok": True,
                                               "generation": new}
    assert t.committed() == {"t:0": 4}
    # A member that left is not in the group.
    t.leave("a")
    gen = t.heartbeat("b")["generation"]
    assert t.commit("a", {"t:0": 8}, gen)["ok"] is False
    assert t.committed() == {"t:0": 4}


# -- datasets over a broker ---------------------------------------------------

def _produce(broker, topic, values, parts=4):
    c = tkp.KafkaProtocolClient(broker.host, broker.port)
    try:
        c.metadata([topic])
        for i, v in enumerate(values):
            c.produce(topic, i % parts, [(None, v)])
    finally:
        c.close()


def _parse(raw):
    return [int(v) for v in raw]


@pytest.fixture()
def broker():
    b = tkp.MiniKafkaBroker(num_partitions=4)
    yield b
    b.shutdown()


def _members(mod, broker, names, max_batches):
    coord, srv = mod.coordinator_for_topics(broker.bootstrap, ["clicks"],
                                            session_timeout=60)
    ep = ("127.0.0.1", srv.port)
    ds = [mod.KafkaGroupDataset(["clicks"], f"worker-{n}", broker.bootstrap,
                                ep, batch_size=4, parse=_parse,
                                max_batches=m)
          for n, m in zip(names, max_batches)]
    for d in ds:                 # every member adopts the last generation
        d._heartbeat()
    return coord, srv, ds


@pytest.mark.parametrize("mod", [tkg, jkg], ids=["port", "jax"])
def test_two_members_read_disjoint_streams(broker, mod):
    _produce(broker, "clicks", [str(i).encode() for i in range(40)])
    _, srv, (da, db) = _members(mod, broker, "ab", (100, 100))
    try:
        assert da.assigned == [("clicks", 0), ("clicks", 2)]
        assert db.assigned == [("clicks", 1), ("clicks", 3)]
        seen_a = [x for b in da for x in b]
        seen_b = [x for b in db for x in b]
        assert sorted(seen_a) == [i for i in range(40) if i % 2 == 0]
        assert sorted(seen_a + seen_b) == list(range(40))
        da.close()
        db.close()
    finally:
        srv.shutdown()


@pytest.mark.parametrize("mod", [tkg, jkg], ids=["port", "jax"])
def test_rebalance_resumes_from_committed_offsets(broker, mod):
    _produce(broker, "clicks", [str(i).encode() for i in range(48)])
    coord, srv, (da, db) = _members(mod, broker, "ab", (3, 100))
    try:
        seen_a = [x for b in da for x in b]   # 3 batches, each committed
        assert len(seen_a) == 12
        assert sum(coord.committed().values()) == 12
        da.close(graceful=True)               # a rebalance
        seen_b = [x for b in db for x in b]
        db.close()
        assert sorted(seen_a + seen_b) == list(range(48))
        assert coord.committed() == {f"clicks:{p}": 12 for p in range(4)}
    finally:
        srv.shutdown()


def test_fenced_dataset_adopts_the_new_view_before_committing(broker):
    """Fault 3.4 at the dataset: a member fenced between a batch and its
    commit commits only the partitions the new view leaves it."""
    _produce(broker, "clicks", [str(i).encode() for i in range(16)])
    coord, srv = tkg.coordinator_for_topics(broker.bootstrap, ["clicks"],
                                            session_timeout=60)
    try:
        da = tkg.KafkaGroupDataset(
            ["clicks"], "worker-a", broker.bootstrap, ("127.0.0.1", srv.port),
            batch_size=4, parse=_parse, heartbeat_interval=3600,
            max_batches=2)
        it = iter(da)
        first = next(it)                      # generation 1: all four
        assert len(da.assigned) == 4
        gen = coord.join("worker-b")["generation"]
        second = next(it)                     # commits batch 1, fenced
        assert da._generation == gen and da.assigned == [("clicks", 0),
                                                         ("clicks", 2)]
        committed = coord.committed()
        assert set(committed) <= {"clicks:0", "clicks:2"}
        assert sum(committed.values()) == sum(
            1 for x in first if x % 4 in (0, 2))
        assert len(first) == len(second) == 4
        da.close()
    finally:
        srv.shutdown()
