"""Port parity: the RESP2 wire code, the feature stores, publishing and
remote serving (``deeprec_tpu_torch/serving/{resp,feature_store}.py``).

* ``encode_command`` and the server double's replies are byte-equal to
  the JAX package's ``resp.py``; the port's ``RespClient`` works against
  the JAX ``MiniRedisServer`` and the JAX client against the port's.
* ``publish_sparse`` on a model trained by the JAX package and restored
  in the port (an EV table and a 64-bucket static table) writes the same
  keys and bit-equal rows as the JAX package's, in full and as a delta
  (``min_version``).
* ``RemoteServingModel`` over a ``RedisFeatureStore``, with and without
  the cache, scores as the JAX one does (rtol 1e-5, atol 1e-6) and as
  the port's own eval step does.

The sharded publish (the fault the port fixes) is held on two gloo ranks
in ``tests/test_torch_serving_mesh.py``.
"""

import socket

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu.feature_column import feature_column as jfc
from deeprec_tpu.optimizers import sparse as jsopt
from deeprec_tpu.serving import feature_store as jfs
from deeprec_tpu.serving import resp as jresp
from deeprec_tpu.train import loop as jloop
from deeprec_tpu.train import losses as jlosses
from deeprec_tpu.train.checkpoint import CheckpointManager as JCkpt
from deeprec_tpu_torch.feature_column import feature_column as tfc
from deeprec_tpu_torch.serving import feature_store as tfs
from deeprec_tpu_torch.serving import resp as tresp
from deeprec_tpu_torch.train import loop as tloop
from deeprec_tpu_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)

COMMANDS = [("PING",), ("SET", "k", b"\x00\x01bin\xff\r\n"), ("GET", "k"),
            ("GET", "missing"), ("MGET", "k", "missing", "k"),
            ("SET", "t/a/1", b"1"), ("SET", "t/a/2", b""),
            ("SCAN", "0", "MATCH", "t/a/*", "COUNT", "1000"),
            ("DBSIZE",), ("DEL", "t/a/1", "nope"), ("SELECT", "2"),
            ("GET", "k"), ("NOPE", "x"), ("SET", "only-key"),
            ("FLUSHDB",), ("DBSIZE",)]


@pytest.fixture(scope="module")
def servers():
    with jresp.MiniRedisServer() as js, tresp.MiniRedisServer() as ts:
        yield js, ts


def test_encode_command_byte_equal():
    for cmd in COMMANDS + [(), ("SET", "é", "ü" * 300)]:
        assert tresp.encode_command(*cmd) == jresp.encode_command(*cmd)


def _raw_replies(port: int) -> bytes:
    """Every command of COMMANDS in one pipelined write, then the raw
    reply bytes up to the closing PING's."""
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(b"".join(jresp.encode_command(*c) for c in COMMANDS)
                  + jresp.encode_command("PING"))
        data = b""
        while not data.endswith(b"+OK\r\n:0\r\n+PONG\r\n"):
            chunk = s.recv(65536)
            assert chunk, data
            data += chunk
    return data


def test_server_replies_byte_equal(servers):
    js, ts = servers
    got, want = _raw_replies(ts.port), _raw_replies(js.port)
    assert got == want
    assert b"-ERR unknown command 'NOPE'" in got


@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port")])
def test_client_against_the_other_server(servers, client, server):
    srv = servers[0] if server == "jax" else servers[1]
    mod = tresp if client == "port" else jresp
    c = mod.RespClient.from_url(srv.url.replace("/0", "/5"))
    assert c.ping()
    assert c.set("k1", b"\x00\x01binary\xff")
    assert c.get("k1") == b"\x00\x01binary\xff"
    assert c.get("missing") is None
    assert c.mget(["k1", "missing"]) == [b"\x00\x01binary\xff", None]
    p = c.pipeline()
    for i in range(5):
        p.set(f"t/{client}/{i}", bytes([i]))
    assert p.execute() == [b"OK"] * 5
    assert sorted(c.scan_iter(f"t/{client}/*")) == [
        f"t/{client}/{i}".encode() for i in range(5)]
    assert c.delete(f"t/{client}/0", f"t/{client}/1") == 2
    assert c.get(f"t/{client}/0") is None
    with pytest.raises(mod.RedisError):
        c.execute("NOPE")
    c.close()


# -- publishing and remote serving ----------------------------------------------

def _columns(fc):
    return [fc.EmbeddingColumn("c0", dim=4, capacity=1 << 8),
            fc.EmbeddingColumn("c1", dim=4, capacity=1 << 8,
                               static_bucket=True, num_buckets=64)]


def _raw(rng, B=32):
    ids = rng.integers(0, 500, (B, 1)).astype(np.int64)
    return {"c0": ids, "c1": ids * 7 + 1,
            "label": (ids[:, 0] % 2).astype(np.float32)}


def _jax_apply(p, e, b):
    return jnp.sum(jnp.concatenate([e["c0"], e["c1"]], axis=1) * p["w"],
                   axis=1)


def _port_apply(p, e, b):
    return (torch.cat([e["c0"], e["c1"]], dim=1) * p["w"]).sum(dim=1)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """JAX: a step, a full save (step 1), another step, a delta save
    (step 2); the state at 2, and the port's restore of full and delta."""
    d = str(tmp_path_factory.mktemp("fs_ckpt"))
    group = jfc.EmbeddingGroup(_columns(jfc))
    opt, tx = jsopt.SparseSGD(0.5), optax.sgd(0.2)
    ts = jloop.create_train_state(group, {"w": jnp.ones((8,))}, tx, opt)
    step = jloop.make_train_step(
        group, _jax_apply,
        lambda o, b: jlosses.bce_with_logits(o, b["label"]), opt, tx,
        donate=False)
    rng = np.random.default_rng(0)
    raws = [_raw(rng), _raw(rng)]
    mgr = JCkpt(d, group)
    ts1, _ = step(ts, group.pack_batch_np(raws[0]))
    mgr.save(ts1)
    ts2, _ = step(ts1, group.pack_batch_np(raws[1]))
    mgr.save(ts2, incremental=True, since_step=1)
    tg = tfc.EmbeddingGroup(_columns(tfc))
    tmpl = tloop.create_train_state(tg, {"w": torch.ones(8)}, device="cpu")
    mgr_t = CheckpointManager(d, tg)
    return {"jgroup": group, "jts": ts2, "tgroup": tg,
            "tts": mgr_t.restore(tmpl), "raw": raws[1]}


def _dump(store, tables):
    """{table: {key: row bytes}} of an in-memory store."""
    return {t: {k: r.tobytes() for k, r in store._tables.get(t, {}).items()}
            for t in tables}


@pytest.mark.parametrize("min_version", [None, 1])
def test_publish_sparse_matches_jax(trained, min_version):
    jstore, tstore = jfs.InMemoryFeatureStore(), tfs.InMemoryFeatureStore()
    jn = jfs.publish_sparse(trained["jts"], trained["jgroup"], jstore,
                            min_version=min_version)
    tn = tfs.publish_sparse(trained["tts"], trained["tgroup"], tstore,
                            min_version=min_version)
    assert tn == jn and tn["c1"] == 64
    tables = list(trained["tgroup"].tables)
    assert _dump(tstore, tables) == _dump(jstore, tables)
    if min_version is not None:
        full = tfs.export_sparse(trained["tts"], trained["tgroup"])
        assert 0 < tn["c0"] < full["c0"][0].size


@pytest.fixture(scope="module")
def redis_server():
    with tresp.MiniRedisServer() as srv:
        yield srv


@pytest.mark.parametrize("cache", [False, True])
def test_remote_predict_matches_jax(trained, redis_server, cache):
    prefix = f"remote{int(cache)}"
    jts, tts = trained["jts"], trained["tts"]
    jstore = jfs.RedisFeatureStore(redis_server.url, prefix=prefix + "j")
    tstore = tfs.RedisFeatureStore(redis_server.url, prefix=prefix + "t")
    jfs.publish_sparse(jts, trained["jgroup"], jstore)
    tfs.publish_sparse(tts, trained["tgroup"], tstore)
    raw = trained["raw"]
    jb = {c: jfc.SparseIds.from_numpy(raw[c]) for c in ("c0", "c1")}
    jremote = jfs.RemoteServingModel(
        trained["jgroup"], _jax_apply, jts.params, jstore,
        cache=jfs.InMemoryFeatureStore() if cache else None)
    want = np.asarray(jremote.predict(jb))
    tcache = tfs.InMemoryFeatureStore() if cache else None
    tremote = tfs.RemoteServingModel(trained["tgroup"], _port_apply,
                                     tts.params, tstore, cache=tcache)
    batch = trained["tgroup"].pack_batch_np(raw, "cpu")
    got = tremote.predict(batch).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    local = tloop.make_eval_step(trained["tgroup"], _port_apply)(tts, batch)
    np.testing.assert_allclose(got, local.numpy(), **TOL)
    if cache:
        assert tcache.num_rows("c0") > 0     # the misses filled the cache
        again = tremote.predict(
            {c: tfc.SparseIds.from_numpy(raw[c], "cpu")
             for c in ("c0", "c1")}).numpy()  # per-column batch, cached
        np.testing.assert_array_equal(again, got)
