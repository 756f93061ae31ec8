"""Port parity: serving from sharded tables, and remote mode on a mesh.

The JAX package trains a small model (``tests/torch_mesh_cases.py``'s
serving model: an EV bag, a 64-bucket static column and an EV column)
on one device and writes a full checkpoint at step 3 and a delta at 5.
Two gloo ranks (the ``serving`` case, one launch) serve it through the
port's ``ServingModel(mesh=)``, the EV bag and the static table
row-sharded and the third table replicated, each rank on its half of a
16-row global batch:

* restored at step 3, after ``delta_update`` (both ranks at 5) and from
  a checkpoint the ranks wrote at S = 2, the ranks' logits concatenated
  equal the JAX package's ``ServingModel(mesh=data_mesh(2))`` on the
  global batch within rtol 1e-5, atol 1e-6;
* ``ServingModel.settle`` gives every rank the least of their steps;
* each rank publishes its shards into one Redis store
  (``MiniRedisServer``): the static table's keys are its global slots
  ``local_row * 2 + shard``, every key is written by one rank only (the
  replicated table by rank 0), and a ``RemoteServingModel`` over that
  store scores the global batch as the ranks did.

Note: the JAX package's ``publish_sparse`` publishes every shard of a
row-sharded static table under the shard's local rows ``0..N/S-1``
(ADVICE.md, round 5), so its shards overwrite each other. This test
asserts the corrected behaviour, not parity with it.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_mesh_cases as mc
from deeprec_tpu.feature_column import feature_column as jfc
from deeprec_tpu.optimizers import sparse as jsopt
from deeprec_tpu.parallel.mesh import data_mesh
from deeprec_tpu.serving.processor import ServingModel as JServingModel
from deeprec_tpu.train import loop as jloop
from deeprec_tpu.train import losses as jlosses
from deeprec_tpu.train.checkpoint import CheckpointManager as JCkpt
from deeprec_tpu_torch.feature_column import feature_column as tfc
from deeprec_tpu_torch.serving.feature_store import (RedisFeatureStore,
                                                     RemoteServingModel,
                                                     export_sparse)
from deeprec_tpu_torch.serving.resp import MiniRedisServer
from deeprec_tpu_torch.train import checkpoint as tckpt
from deeprec_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

S = 2
TOL = dict(rtol=1e-5, atol=1e-6)


def _jax_apply(p, e, b):
    h = jnp.concatenate([e["a"], e["s"], e["r"]], axis=1)
    return jnp.sum(h * p["w"], axis=1) + b["x"] * p["v"]


def _jax_params():
    return {k: jnp.asarray(v.numpy()) for k, v in mc.serve_params().items()}


def _jax_train(ckpt: str):
    """Train on one device; full checkpoint at step 3, delta at 5."""
    group = mc.serve_group(jfc)
    opt, tx = jsopt.SparseSGD(0.5), optax.sgd(0.2)
    ts = jloop.create_train_state(group, _jax_params(), tx, opt)
    step = jloop.make_train_step(
        group, _jax_apply,
        lambda o, b: jlosses.bce_with_logits(o, b["label"]), opt, tx,
        donate=False)
    mgr = JCkpt(ckpt, group)
    for i in range(mc.SERVE_STEPS[1]):
        ts, _ = step(ts, group.pack_batch_np(mc.serve_raw(i)))
        if i + 1 == mc.SERVE_STEPS[0]:
            mgr.save(ts)
    mgr.save(ts, incremental=True, since_step=mc.SERVE_STEPS[0])


def _jax_mesh_logits(ckpt: str, step=None):
    group = mc.serve_group(jfc, S)
    tmpl = jloop.create_train_state(group, _jax_params(), optax.sgd(0.2),
                                    jsopt.SparseSGD(0.5))
    model = JServingModel(group, _jax_apply, tmpl, ckpt,
                          mesh=data_mesh(S))
    model.full_update(step=step)
    return np.asarray(model.predict(group.pack_batch_np(mc.serve_raw(99))))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serving_mesh")
    ckpt, ckpt_s2 = str(tmp / "ckpt"), str(tmp / "ckpt_s2")
    _jax_train(ckpt)
    with MiniRedisServer() as srv:
        mc.launch("serving", S, tmp, ckpt=ckpt, ckpt_s2=ckpt_s2,
                  redis_url=srv.url)
        ranks = [mc.result("serving", tmp, r) for r in range(S)]
        # Remote mode over what the ranks published, on one process.
        group = mc.serve_group(tfc)
        tmpl = tloop.create_train_state(group, mc.serve_params(),
                                        device="cpu")
        ts = tckpt.CheckpointManager(ckpt, group).restore(tmpl)
        remote = RemoteServingModel(
            group, mc.serve_apply, ts.params,
            RedisFeatureStore(srv.url, prefix="mesh"))
        remote_logits = remote.predict(
            group.pack_batch_np(mc.serve_raw(99), "cpu")).numpy()
    return {"ranks": ranks, "ckpt": ckpt, "remote": remote_logits,
            "single": (group, ts),
            "jax3": _jax_mesh_logits(ckpt, mc.SERVE_STEPS[0]),
            "jax5": _jax_mesh_logits(ckpt)}


def _cat(runs, key):
    return np.concatenate([r[key] for r in runs["ranks"]])


@pytest.mark.parametrize("key,want", [("s1/logits", "jax3"),
                                      ("delta/logits", "jax5"),
                                      ("s2/logits", "jax5")])
def test_mesh_serving_matches_jax_mesh(runs, key, want):
    assert not np.allclose(runs["jax3"], runs["jax5"])
    np.testing.assert_allclose(_cat(runs, key), runs[want], **TOL)


def test_updates_settle_on_one_version(runs):
    for r in runs["ranks"]:
        assert int(r["version/s1"]) == mc.SERVE_STEPS[0]
        assert int(r["version/delta"]) == mc.SERVE_STEPS[1]
        assert int(r["version/none"]) == -1
        assert int(r["version/s2"]) == mc.SERVE_STEPS[1]
        # Rank r offered step 5 - 2r: both take the least.
        assert int(r["settled"]) == mc.SERVE_STEPS[1] - 2 * (S - 1)
        # A timer thread per rank would run updates out of step.
        assert int(r["watcher_refused"]) == 1


def test_sharded_publish_writes_global_keys_once(runs):
    """The fault fix (see the module's note): global slots, no key
    twice, a replicated table from rank 0 only."""
    group, ts = runs["single"]
    want = {t: np.sort(keys) for t, (keys, _) in
            export_sparse(ts, group).items()}
    ranks = runs["ranks"]
    static = [t for t, c in group.tables.items() if c.static_buckets]
    assert static
    for t in group.tables:
        per_rank = [r.get(f"publish/{t}", np.zeros(0, np.int64))
                    for r in ranks]
        cat = np.concatenate(per_rank)
        assert np.unique(cat).size == cat.size, t  # no key twice
        np.testing.assert_array_equal(np.sort(cat), want[t])
        if t in static:
            for shard, keys in enumerate(per_rank):
                np.testing.assert_array_equal(np.sort(keys),
                                              np.arange(shard, 64, S))
        if t == "r":
            assert f"publish/{t}" not in ranks[1] and per_rank[0].size
    # A mesh group published without its rank is refused.
    with pytest.raises(ValueError, match="mesh="):
        export_sparse(ts, mc.serve_group(tfc, S))


def test_remote_scores_match_mesh_serving(runs):
    np.testing.assert_allclose(runs["remote"], _cat(runs, "delta/logits"),
                               **TOL)
