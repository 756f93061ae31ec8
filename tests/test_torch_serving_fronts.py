"""Port parity: the KServe v2 front, warmup and the Python SDK.

The JAX package trains a small WDL and writes a checkpoint; its
``KServeFrontend`` and the port's, each over its package's
``ServingModel`` restored from that checkpoint, run side by side:

* ``/v2``, the health and ready paths and the model metadata answer the
  same;
* ``infer`` scores equal the JAX front's within rtol 1e-5, atol 1e-6,
  and the sigmoid of the port's in-process logits bit for bit;
* the same malformed requests get the same codes (400, 404);
* ``id_str`` inputs hash to ``deeprec_tpu.native.hash_bytes``'s ids
  (signed, before ``key_offset``), through ``data/criteo._hash_token``;
* ``warmup`` returns a positive time and leaves the version as it was;
* the port's SDK ``Client`` against the port's ``HttpScorer``.
"""

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu import native as jnative
from deeprec_tpu.feature_column import feature_column as jfc
from deeprec_tpu.models import wdl as jwdl
from deeprec_tpu.optimizers import sparse as jsopt
from deeprec_tpu.serving.kserve import KServeFrontend as JFront
from deeprec_tpu.serving.kserve import TensorSpec as JSpec
from deeprec_tpu.serving.processor import ServingModel as JServingModel
from deeprec_tpu.train import loop as jloop
from deeprec_tpu.train import losses as jlosses
from deeprec_tpu.train.checkpoint import CheckpointManager as JCkpt
from deeprec_tpu_torch.feature_column import feature_column as tfc
from deeprec_tpu_torch.models import wdl as twdl
from deeprec_tpu_torch.serving import kserve
from deeprec_tpu_torch.serving.processor import HttpScorer, ServingModel
from deeprec_tpu_torch.serving.sdk import Client, ServingError
from deeprec_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
B = 8
STEPS = 4
TOKEN_OFFSET = 5


def _columns(fc):
    return [fc.NumericColumn("x1"), fc.NumericColumn("x2"),
            fc.EmbeddingColumn("C1", dim=5, capacity=256),
            fc.EmbeddingColumn("C2", dim=5, capacity=256),
            fc.EmbeddingColumn("C3", dim=9, capacity=128)]


def _specs(spec):
    return [spec("x1", "numeric"), spec("x2", "numeric"),
            spec("C1", "id", dims=(2,)), spec("C2", "id_str",
                                              key_offset=TOKEN_OFFSET),
            spec("C3", "id")]


TOKENS = ["a", "", "ünïcode", "12345", "abc" * 30, "x", "y", "a"]


def _raw(i):
    r = np.random.default_rng(400 + i)
    toks = [TOKENS[j] for j in r.integers(0, len(TOKENS), B)]
    return {"x1": r.normal(size=B).astype(np.float32),
            "x2": r.normal(size=B).astype(np.float32),
            "C1": r.integers(0, 60, size=(B, 2)).astype(np.int64),
            "C2": (jnative.hash_bytes(toks)[:, None] + TOKEN_OFFSET),
            "C3": r.integers(0, 60, size=(B, 1)).astype(np.int64),
            "label": (r.random(B) < 0.5).astype(np.float32),
            "tokens": toks}


def _request(raw, rid="req-1"):
    return {"id": rid, "inputs": [
        {"name": "x1", "shape": [B], "datatype": "FP32",
         "data": raw["x1"].tolist()},
        {"name": "x2", "shape": [B], "datatype": "FP32",
         "data": raw["x2"].tolist()},
        {"name": "C1", "shape": [B, 2], "datatype": "INT64",
         "data": raw["C1"].reshape(-1).tolist()},
        {"name": "C2", "shape": [B], "datatype": "BYTES",
         "data": raw["tokens"]},
        {"name": "C3", "shape": [B, 1], "datatype": "INT64",
         "data": raw["C3"].reshape(-1).tolist()}]}


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


@pytest.fixture(scope="module")
def fronts(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("fronts_ckpt"))
    group = jfc.EmbeddingGroup(_columns(jfc))
    model = jwdl.WDL(hidden=(16,))
    raw0 = {k: v for k, v in _raw(0).items() if k != "tokens"}
    b0 = group.pack_batch_np(raw0)
    embs0 = {c.name: jnp.zeros((B, c.dim)) for c in group.embedding}
    params = model.init(jax.random.key(0), embs0,
                        group.numeric_features(b0))["params"]
    opt, tx = jsopt.SparseAdagrad(learning_rate=0.2), optax.adagrad(0.05)
    ts = jloop.create_train_state(group, params, tx, opt)
    afn = jwdl.apply_fn(model, group)
    step = jloop.make_train_step(
        group, afn, lambda o, b: jlosses.bce_with_logits(o, b["label"]),
        opt, tx, donate=False)
    for i in range(STEPS):
        raw = {k: v for k, v in _raw(i).items() if k != "tokens"}
        ts, _ = step(ts, group.pack_batch_np(raw))
    JCkpt(ckpt, group).save(ts)
    jserv = JServingModel(group, afn, ts, ckpt)
    jserv.full_update()

    tg = tfc.EmbeddingGroup(_columns(tfc))
    tmodel = twdl.WDL(twdl.input_width(tg), hidden=(16,), device="cpu")
    tts = tloop.create_train_state(tg, tmodel.state_dict(), device="cpu")
    serving = ServingModel(tg, twdl.apply_fn(tmodel, tg), tts, ckpt)
    serving.full_update()
    jf = JFront(jserv, "wdl", inputs=_specs(JSpec), host="127.0.0.1")
    tf = kserve.KServeFrontend(serving, "wdl", inputs=_specs(
        kserve.TensorSpec))
    jf.start()
    tf.start()
    yield {"jax": f"http://127.0.0.1:{jf.port}",
           "port": f"http://127.0.0.1:{tf.port}", "serving": serving,
           "group": tg, "front": tf}
    jf.stop()
    tf.stop()


@pytest.mark.parametrize("path", ["/v2", "/v2/health/live", "/v2/health/ready",
                                  "/v2/models/wdl", "/v2/models/wdl/ready",
                                  "/v2/models/other", "/v2/nope"])
def test_metadata_health_and_ready_match_jax(fronts, path):
    got, want = _get(fronts["port"] + path), _get(fronts["jax"] + path)
    assert got[0] == want[0]
    if want[0] == 200:
        assert got == want
    if path == "/v2/models/wdl":
        assert got[1]["versions"] == [str(STEPS)]


@pytest.mark.parametrize("i", [10, 11])
def test_infer_matches_jax_front(fronts, i):
    raw = _raw(i)
    code, got = _post(fronts["port"] + "/v2/models/wdl/infer", _request(raw))
    jcode, want = _post(fronts["jax"] + "/v2/models/wdl/infer", _request(raw))
    assert code == jcode == 200
    assert {k: v for k, v in got.items() if k != "outputs"} == {
        k: v for k, v in want.items() if k != "outputs"}
    (out,), (jout,) = got["outputs"], want["outputs"]
    assert out["shape"] == jout["shape"] == [B]
    np.testing.assert_allclose(out["data"], jout["data"], **TOL)
    # The same eval path as an in-process predict on the packed batch.
    batch = fronts["group"].pack_batch_np(
        {k: v for k, v in raw.items() if k != "tokens"}, "cpu")
    local = kserve.sigmoid_scores(fronts["serving"].predict(batch))
    assert out["data"] == local.tolist()


BAD = [
    ("/v2/models/wdl/infer", {"inputs": [{"name": "x1", "shape": [2],
                                           "data": [0.1, 0.2]}]}),
    ("/v2/models/wdl/infer", {"inputs": [{"name": "nope", "shape": [1],
                                           "data": [1]}]}),
    ("/v2/models/wdl/infer", "inconsistent"),
    ("/v2/models/wdl/infer", {"inputs": [{"name": "C1", "shape": [3, 2],
                                           "data": [1, 2, 3]}]}),
    ("/v2/models/wdl/infer", ["not", "a", "dict"]),
    ("/v2/models/other/infer", {"inputs": []}),
    ("/v2/models/wdl", {"inputs": []}),
]


@pytest.mark.parametrize("path,body", BAD)
def test_bad_requests_rejected_as_jax(fronts, path, body):
    if body == "inconsistent":
        body = _request(_raw(1))
        body["inputs"][0]["data"] = body["inputs"][0]["data"][:3]
        body["inputs"][0]["shape"] = [3]
    code, got = _post(fronts["port"] + path, body)
    jcode, _ = _post(fronts["jax"] + path, body)
    assert code == jcode and code in (400, 404)
    assert "error" in got


def test_id_str_hash_equals_native_hash_bytes():
    toks = TOKENS + ["\x00", "é" * 64, "0x1f"]
    np.testing.assert_array_equal(kserve.hash_tokens(toks),
                                  jnative.hash_bytes(toks))
    assert (kserve.hash_tokens(toks) < 0).any()   # the signed view
    spec = kserve.TensorSpec("t", "id_str", key_offset=TOKEN_OFFSET)
    ids = kserve._decode_input(spec, {"data": toks + [None]})
    want = np.concatenate([jnative.hash_bytes(toks),
                           jnative.hash_bytes([""])]) + TOKEN_OFFSET
    got = tfc.SparseIds.from_numpy(want[:, None], "cpu")
    assert torch.equal(ids.hi, got.hi) and torch.equal(ids.lo, got.lo)


def test_warmup_times_and_keeps_the_version(fronts):
    serving = fronts["serving"]
    before = serving.version
    batches = [fronts["group"].pack_batch_np(
        {k: v for k, v in _raw(i).items() if k != "tokens"}, "cpu")
        for i in (20, 21)]
    assert serving.warmup(batches) > 0
    assert serving.version == before == STEPS


def test_sdk_client_against_http_scorer(fronts):
    group, serving = fronts["group"], fronts["serving"]

    def parse(req):
        inst = req["instances"]
        batch = {k: np.asarray([r[k] for r in inst], np.float32)
                 for k in ("x1", "x2")}
        for c in ("C1", "C2", "C3"):
            batch[c] = np.asarray([r[c] for r in inst], np.int64)
        return group.pack_batch_np(batch, "cpu")

    scorer = HttpScorer(serving, parse)
    scorer.start()
    try:
        c = Client(f"http://127.0.0.1:{scorer.port}")
        assert c.health() == {"status": "ok", "version": STEPS}
        assert c.model_version() == STEPS
        raw = _raw(30)
        inst = [{"x1": float(raw["x1"][r]), "x2": float(raw["x2"][r]),
                 "C1": raw["C1"][r].tolist(), "C2": [int(raw["C2"][r, 0])],
                 "C3": raw["C3"][r].tolist()} for r in range(B)]
        want = kserve.sigmoid_scores(serving.predict(parse(
            {"instances": inst})))
        np.testing.assert_allclose(c.predict(inst), want, **TOL)
        np.testing.assert_allclose(c.batch_predict(inst, max_batch=3), want,
                                   **TOL)
        with pytest.raises(ServingError) as e:
            c.predict([{"x1": 1.0}])
        assert e.value.status == 400
    finally:
        scorer.stop()
