"""Port parity: training checkpoints, optimizer state included, across
the two packages.

Each direction trains two steps in one package and saves a full
checkpoint; the other package restores it into a fresh template and
both take a third step on the same batch. The losses must agree, and
the checkpoints both then write must hold the same files and leaves
(the JAX package's key names: ``slot/['accum']``,
``scalar/['beta1_power']``, ``['dense_opt']/[0]/.sum_of_squares/...``)
with equal keys, freqs and versions and, key by key, values within
rtol 1e-5, atol 1e-6 (float32 sums in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu.feature_column import feature_column as jfc
from deeprec_tpu.models import wdl as jwdl
from deeprec_tpu.optimizers import sparse as jsopt
from deeprec_tpu.train import loop as jloop
from deeprec_tpu.train import losses as jlosses
from deeprec_tpu.train.checkpoint import CheckpointManager as JCkpt
from deeprec_tpu_torch import convert
from deeprec_tpu_torch.feature_column import feature_column as tfc
from deeprec_tpu_torch.models import wdl as twdl
from deeprec_tpu_torch.optimizers import dense as tdense
from deeprec_tpu_torch.optimizers import sparse as tsopt
from deeprec_tpu_torch.train import loop as tloop
from deeprec_tpu_torch.train import losses as tlosses
from deeprec_tpu_torch.train.checkpoint import CheckpointManager as TCkpt

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
B = 16
HIDDEN = (16, 8)


def _columns(fc):
    return [fc.NumericColumn("x1"), fc.NumericColumn("x2"),
            fc.EmbeddingColumn("C1", dim=5, capacity=256),
            fc.EmbeddingColumn("C2", dim=5, capacity=256),
            fc.EmbeddingColumn("C3", dim=9, capacity=128)]


def _raw(i):
    r = np.random.default_rng(300 + i)
    batch = {"x1": r.normal(size=B).astype(np.float32),
             "x2": r.normal(size=B).astype(np.float32),
             "label": (r.random(B) < 0.5).astype(np.float32)}
    for c in ("C1", "C2", "C3"):
        batch[c] = r.integers(0, 60, size=(B, 1)).astype(np.int64)
    return batch


class _Jax:
    def __init__(self, opt_name):
        self.group = jfc.EmbeddingGroup(_columns(jfc), coalesce=True)
        model = jwdl.WDL(hidden=HIDDEN)
        b0 = self.group.pack_batch_np(_raw(0))
        embs0 = {c.name: jnp.zeros((B, c.dim)) for c in self.group.embedding}
        self.params = model.init(jax.random.key(0), embs0,
                                 self.group.numeric_features(b0))["params"]
        self.opt = (jsopt.SparseAdagrad(0.2) if opt_name == "adagrad"
                    else jsopt.SparseAdam(0.01))
        self.tx = optax.adagrad(0.05)
        self.step_fn = jloop.make_train_step(
            self.group, jwdl.apply_fn(model, self.group),
            lambda o, b: jlosses.bce_with_logits(o, b["label"]), self.opt,
            self.tx, donate=False)

    def template(self):
        return jloop.create_train_state(self.group, self.params, self.tx,
                                        self.opt)

    def step(self, ts, i):
        ts, m = self.step_fn(ts, self.group.pack_batch_np(_raw(i)))
        return ts, float(m["loss"])


class _Port:
    def __init__(self, opt_name, params):
        self.group = tfc.EmbeddingGroup(_columns(tfc), coalesce=True)
        model = twdl.WDL(twdl.input_width(self.group), hidden=HIDDEN,
                         device="cpu")
        self.params = convert.wdl_params_from_numpy(
            jax.tree.map(np.asarray, params))
        self.opt = (tsopt.SparseAdagrad(0.2) if opt_name == "adagrad"
                    else tsopt.SparseAdam(0.01))
        self.dopt = tdense.Adagrad(0.05)
        self.step_fn = tloop.make_train_step(
            self.group, twdl.apply_fn(model, self.group),
            lambda o, b: tlosses.bce_with_logits(o, b["label"]), self.opt,
            self.dopt)

    def template(self):
        return tloop.create_train_state(
            self.group, {k: v.clone() for k, v in self.params.items()},
            self.dopt, self.opt, device="cpu")

    def step(self, ts, i):
        ts, m = self.step_fn(ts, self.group.pack_batch_np(_raw(i), "cpu"))
        return ts, float(m["loss"])


def _load(path):
    """{file: {leaf: array}} of one checkpoint directory, table rows
    sorted by key."""
    out = {}
    for fn in sorted(os.listdir(path)):
        if not fn.endswith(".npz"):
            continue
        with np.load(os.path.join(path, fn)) as z:
            arrs = dict(z)
        if "keys" in arrs:
            order = np.argsort(arrs["keys"])
            arrs = {k: (v[order] if k == "keys" or k.startswith("slot/")
                        or k in ("values", "freqs", "versions") else v)
                    for k, v in arrs.items()}
        out[fn] = arrs
    return out


def _assert_same_checkpoint(path_a, path_b):
    a, b = _load(path_a), _load(path_b)
    assert set(a) == set(b)
    for fn in a:
        assert set(a[fn]) == set(b[fn]), fn
        for k, v in a[fn].items():
            if v.dtype.kind in "iu":
                np.testing.assert_array_equal(b[fn][k], v, err_msg=k)
            else:
                np.testing.assert_allclose(b[fn][k], v, err_msg=k, **TOL)


@pytest.fixture(scope="module", params=["adagrad", "adam"])
def sides(request):
    jx = _Jax(request.param)
    return request.param, jx, _Port(request.param, jx.params)


def test_jax_checkpoint_restores_in_port(sides, tmp_path):
    opt_name, jx, port = sides
    jts = jx.template()
    for i in range(2):
        jts, _ = jx.step(jts, i)
    JCkpt(str(tmp_path / "jax"), jx.group).save(jts)
    written = _load(str(tmp_path / "jax" / "full-2"))
    slot_key = "slot/['accum']" if opt_name == "adagrad" else "slot/['m']"
    assert any(slot_key in arrs for arrs in written.values())
    assert any(k.startswith("['dense_opt']/[0]/.sum_of_squares/")
               for k in written["dense.npz"])

    tts = TCkpt(str(tmp_path / "jax"), port.group).restore(port.template())
    assert tts.step == 2
    jts, jloss = jx.step(jts, 2)
    tts, tloss = port.step(tts, 2)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    JCkpt(str(tmp_path / "j3"), jx.group).save(jts)
    TCkpt(str(tmp_path / "t3"), port.group).save(tts)
    _assert_same_checkpoint(str(tmp_path / "j3" / "full-3"),
                            str(tmp_path / "t3" / "full-3"))


def test_port_checkpoint_restores_in_jax(sides, tmp_path):
    opt_name, jx, port = sides
    tts = port.template()
    for i in range(2):
        tts, _ = port.step(tts, i)
    TCkpt(str(tmp_path / "port"), port.group).save(tts)
    jts = JCkpt(str(tmp_path / "port"), jx.group).restore(jx.template())
    assert int(jts.step) == 2
    if opt_name == "adam":
        np.testing.assert_allclose(
            float(next(iter(jts.slots.values()))["beta1_power"]), 0.9 ** 3,
            rtol=1e-6)
    jts, jloss = jx.step(jts, 2)
    tts, tloss = port.step(tts, 2)
    np.testing.assert_allclose(jloss, tloss, rtol=1e-5)
    JCkpt(str(tmp_path / "j3"), jx.group).save(jts)
    TCkpt(str(tmp_path / "t3"), port.group).save(tts)
    _assert_same_checkpoint(str(tmp_path / "j3" / "full-3"),
                            str(tmp_path / "t3" / "full-3"))
