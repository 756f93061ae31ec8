"""Port parity: the serving path end to end.

The JAX package trains a small WDL and writes full and incremental
checkpoints; the port's ServingModel restores them from the same
directory and must score as the JAX package does (float32, rtol 1e-5)
after the full update, a delta update and a rollback. Also: the HTTP
scorer, the worker process, and that the port never imports JAX.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu.feature_column import feature_column as jfc
from deeprec_tpu.models import wdl as jwdl
from deeprec_tpu.optimizers import sparse as sopt
from deeprec_tpu.serving.processor import ServingModel as JServingModel
from deeprec_tpu.train import loop as jloop
from deeprec_tpu.train import losses
from deeprec_tpu.train.checkpoint import CheckpointManager as JCkpt
from deeprec_tpu_torch.data.criteo import SyntheticCriteo
from deeprec_tpu_torch.embedding import variable as tev
from deeprec_tpu_torch.feature_column import feature_column as tfc
from deeprec_tpu_torch.models import wdl as twdl
from deeprec_tpu_torch.serving import wdl_entry
from deeprec_tpu_torch.serving.processor import (HttpScorer, ModelWatcher,
                                                 ServingModel)
from deeprec_tpu_torch.train import loop as tloop
from deeprec_tpu_torch.train.checkpoint import CheckpointManager
from deeprec_tpu_torch.utils import keys as tkeys
from deeprec_tpu_torch.utils import stateless_random as tsr

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)
B = 16


def _columns(fc):
    return [fc.NumericColumn("x1"), fc.NumericColumn("x2"),
            fc.EmbeddingColumn("C1", dim=5, capacity=256),
            fc.EmbeddingColumn("C2", dim=5, capacity=256),
            fc.EmbeddingColumn("C3", dim=9, capacity=128)]


def _raw(i):
    r = np.random.default_rng(200 + i)
    batch = {"x1": r.normal(size=B).astype(np.float32),
             "x2": r.normal(size=B).astype(np.float32),
             "label": (r.random(B) < 0.5).astype(np.float32)}
    for c in ("C1", "C2", "C3"):
        batch[c] = r.integers(0, 60, size=(B, 1)).astype(np.int64)
    return batch


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """JAX side: train, save full@5, keep the v5 and v8 states."""
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    group = jfc.EmbeddingGroup(_columns(jfc), coalesce=True)
    model = jwdl.WDL(hidden=(16,))
    b0 = group.pack_batch_np(_raw(0))
    embs0 = {c.name: jnp.zeros((B, c.dim)) for c in group.embedding}
    params = model.init(jax.random.key(0), embs0,
                        group.numeric_features(b0))["params"]
    opt = sopt.SparseAdagrad(learning_rate=0.2)
    tx = optax.adagrad(0.05)
    ts = jloop.create_train_state(group, params, tx, opt)
    afn = jwdl.apply_fn(model, group)
    step = jloop.make_train_step(
        group, afn, lambda o, b: losses.bce_with_logits(o, b["label"]),
        opt, tx, donate=False)
    states = {}
    for i in range(8):
        ts, _ = step(ts, group.pack_batch_np(_raw(i)))
        if i + 1 == 5:
            states[5] = ts
    states[8] = ts
    mgr = JCkpt(ckpt, group)
    mgr.save(states[5])
    jserv = JServingModel(group, afn, states[5], ckpt)
    return dict(ckpt=ckpt, group=group, afn=afn, mgr=mgr, states=states,
                jserv=jserv, params=params)


def _port_serving(ckpt):
    group = tfc.EmbeddingGroup(_columns(tfc), coalesce=True)
    model = twdl.WDL(twdl.input_width(group), hidden=(16,), device="cpu")
    ts = tloop.create_train_state(group, model.state_dict(), device="cpu")
    return group, ServingModel(group, twdl.apply_fn(model, group), ts, ckpt)


def test_full_delta_update_and_rollback(trained):
    tg, serving = _port_serving(trained["ckpt"])
    jg, jserv = trained["group"], trained["jserv"]
    raw = _raw(77)
    assert serving.full_update() == 5
    assert jserv.full_update() == 5
    ref5 = np.asarray(jserv.predict(jg.pack_batch_np(raw)))
    np.testing.assert_allclose(
        serving.predict(tg.pack_batch_np(raw, "cpu")).numpy(), ref5, **TOL)

    # A delta written by the JAX package is applied without a reload.
    trained["mgr"].save(trained["states"][8], incremental=True, since_step=5)
    ModelWatcher(serving).poll_once()
    assert serving.version == 8
    ref8 = np.asarray(jloop.make_eval_step(jg, trained["afn"])(
        trained["states"][8], jg.pack_batch_np(raw)))
    assert not np.allclose(ref8, ref5)
    np.testing.assert_allclose(
        serving.predict(tg.pack_batch_np(raw, "cpu")).numpy(), ref8, **TOL)

    # Rollback to version 5.
    assert serving.full_update(step=5) == 5
    np.testing.assert_allclose(
        serving.predict(tg.pack_batch_np(raw, "cpu")).numpy(), ref5, **TOL)


def test_http_scorer(trained):
    tg, serving = _port_serving(trained["ckpt"])
    serving.full_update(step=5)

    def parse(req):
        inst = req["instances"]
        batch = {k: np.asarray([r[k] for r in inst], np.float32)
                 for k in ("x1", "x2")}
        for c in ("C1", "C2", "C3"):
            batch[c] = np.asarray([[r[c]] for r in inst], np.int64)
        return tg.pack_batch_np(batch, "cpu")

    scorer = HttpScorer(serving, parse, host="127.0.0.1")
    scorer.start()
    try:
        url = f"http://127.0.0.1:{scorer.port}"
        with urllib.request.urlopen(url + "/healthz") as r:
            health = json.loads(r.read())
        assert health == {"status": "ok", "version": 5}
        inst = [{"x1": 0.5, "x2": -1.0, "C1": 3, "C2": 4, "C3": 5},
                {"x1": -0.25, "x2": 2.0, "C1": 7, "C2": 999, "C3": 1}]
        req = urllib.request.Request(
            url + "/v1/predict", data=json.dumps({"instances": inst}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as r:
            preds = json.loads(r.read())["predictions"]
        want = torch.sigmoid(serving.predict(parse({"instances": inst})))
        np.testing.assert_allclose(preds, want.numpy(), **TOL)
        assert all(0.0 < p < 1.0 for p in preds)
        bad = urllib.request.Request(url + "/v1/predict", data=b"{}")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad)
        assert e.value.code == 400
    finally:
        scorer.stop()


def _worker_env(config):
    env = dict(os.environ, DEEPREC_MODEL_CONFIG=json.dumps(config),
               OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _worker_cmd():
    return [sys.executable, "-m", "deeprec_tpu_torch.serving.worker",
            "deeprec_tpu_torch.serving.wdl_entry"]


def test_worker_process_serves_port_checkpoint(tmp_path):
    config = {"checkpoint_dir": str(tmp_path), "device": "cpu", "dim": 4,
              "capacity": 256, "hidden": [16, 8], "dtype": "float32"}
    parts = wdl_entry.build(config)
    group, ts = parts["group"], parts["ts_template"]
    data = SyntheticCriteo(32, vocab=50, seed=4)
    raw = data.next_batch_np(wide=False)
    for tname, cfg in group.tables.items():
        keys = np.unique(np.concatenate([
            tkeys.join_ids(*group.transform_ids_np(c, raw[c.name])).ravel()
            for c in group.embedding if group.physical_table_of(c) == tname]))
        hi, lo = tkeys.split_ids(keys)
        vals = tsr.init_rows(cfg.initializer, torch.from_numpy(hi),
                             torch.from_numpy(lo), cfg.dim, cfg.init_scale,
                             salt=group.salts[tname])
        tev.import_arrays(cfg, ts.ev[tname], {
            "keys": keys, "values": vals.numpy(),
            "freqs": np.ones(keys.size, np.int32),
            "versions": np.zeros(keys.size, np.int32)})
    CheckpointManager(str(tmp_path), group).save(ts.replace(step=3))
    serving = ServingModel(group, parts["apply_fn"], ts, str(tmp_path))
    assert serving.full_update() == 3
    inst = [{**{f"I{i}": float(raw[f"I{i}"][r]) for i in range(1, 14)},
             **{f"C{i}": int(raw[f"C{i}"][r, 0]) for i in range(1, 27)}}
            for r in range(5)]
    want = torch.sigmoid(serving.predict(parts["parse_request"](
        {"instances": inst}))).numpy()

    proc = subprocess.Popen(_worker_cmd(), env=_worker_env(config), cwd=REPO,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True)
    try:
        line = []
        reader = threading.Thread(
            target=lambda: line.append(proc.stdout.readline()), daemon=True)
        reader.start()
        reader.join(timeout=120)
        assert line and line[0].startswith("PORT "), line
        url = f"http://127.0.0.1:{int(line[0].split()[1])}"
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["version"] == 3
        req = urllib.request.Request(
            url + "/v1/predict", data=json.dumps({"instances": inst}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            got = json.loads(r.read())["predictions"]
        np.testing.assert_allclose(got, want, **TOL)
    finally:
        proc.stdin.close()
        proc.wait(timeout=60)
    assert proc.returncode == 0


def test_worker_refuses_missing_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    config = {"checkpoint_dir": str(tmp_path), "device": "cuda"}
    proc = subprocess.run(_worker_cmd(), env=_worker_env(config), cwd=REPO,
                          input="", capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import deeprec_tpu_torch.serving.worker, "
        "deeprec_tpu_torch.models.wdl, deeprec_tpu_torch.serving.processor, "
        "deeprec_tpu_torch.serving.wdl_entry, deeprec_tpu_torch.convert, "
        "deeprec_tpu_torch.data.criteo, deeprec_tpu_torch.ops.kernels.gather, "
        "deeprec_tpu_torch.ops.kernels.sparse_apply, deeprec_tpu_torch.bench, "
        "deeprec_tpu_torch.train.checkpoint, deeprec_tpu_torch.train.loop, "
        "deeprec_tpu_torch.optimizers.dense, deeprec_tpu_torch.native, "
        "deeprec_tpu_torch.data.prefetch, "
        "deeprec_tpu_torch.ops.kernels.hash_probe, "
        "deeprec_tpu_torch.ops.kernels.init_rows, "
        "deeprec_tpu_torch.embedding.hash_table, "
        "deeprec_tpu_torch.optimizers.sparse, "
        "deeprec_tpu_torch.feature_column.feature_column, "
        "deeprec_tpu_torch.embedding.lookup, "
        "deeprec_tpu_torch.embedding.variable, "
        "deeprec_tpu_torch.train.estimator, deeprec_tpu_torch.train.metrics, "
        "deeprec_tpu_torch.data.work_queue, deeprec_tpu_torch.ops.fused, "
        "deeprec_tpu_torch.layers.core, deeprec_tpu_torch.models.deepfm, "
        "deeprec_tpu_torch.models.dlrm, deeprec_tpu_torch.models.multitask, "
        "deeprec_tpu_torch.models.din, deeprec_tpu_torch.models.dien, "
        "deeprec_tpu_torch.models.bst, deeprec_tpu_torch.models.dssm, "
        "deeprec_tpu_torch.models.structured, "
        "deeprec_tpu_torch.models.registry, "
        "deeprec_tpu_torch.data.behavior, deeprec_tpu_torch.train.losses, "
        "deeprec_tpu_torch.config, deeprec_tpu_torch.utils.keys, "
        "deeprec_tpu_torch.utils.stateless_random\n"
        "deeprec_tpu_torch.native.parse_criteo(b'1\\t2\\n', 1)\n"
        "sys.path.insert(0, 'tools')\n"
        "import train_zoo_torch, train_wdl_torch, profile_train_torch\n"
        "import zoo_auc_torch, zoo_delta_torch, model_benchmark_torch, "
        "write_bench_zoo_torch, serving_benchmark_torch, "
        "step_breakdown_torch, kernel_benchmark_torch, env_collect_torch, "
        "chip_smoke\n"
        "env_collect_torch.collect(touch_device=False)\n"
        "train_zoo_torch.columns(train_zoo_torch.parse_args(\n"
        "    ['wdl', '--ev', '--cbf', '--filter_freq', '2']))\n"
        "for m in train_zoo_torch.COLUMN_KWARGS:\n"
        "    train_zoo_torch.check_ported(train_zoo_torch.parse_args([m]))\n"
        "    train_zoo_torch.columns(train_zoo_torch.parse_args([m]))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'deeprec_tpu')]\n"
        "assert 'jax' not in sys.modules and not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=_worker_env({}), timeout=120)
