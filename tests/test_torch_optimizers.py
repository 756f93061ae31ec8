"""Port parity: every sparse optimizer against the JAX package, and through
a checkpoint.

The eight entries of ``tests/test_optimizer_matrix.py`` (SGD, Adagrad,
AdagradDecay with a decay every 3 steps, Adam, AdamAsync in both forms,
Ftrl with l1, FtrlV2) train the matrix's one-column model (dim 4,
capacity 256, freq and version recorded) for 8 steps on both packages
from the same batches, with Adagrad(0.05) on the dense weight on both
sides (optax's and the port's). The rows start from the uniform
initializer, not the matrix's zeros: with zero rows every logit of the
first step is exactly 0, where ``bce_with_logits``'s ``max(x, 0)`` has
no derivative; JAX takes 0 there and PyTorch 1/2, so the two packages'
first gradients would differ by design of the frameworks. Losses each
step, table rows, slot rows and beta powers agree to rtol 1e-5, atol
1e-6 (float32 arithmetic in another order, and ``pow``/``rsqrt`` of
another math library); hash key rows, freqs and versions are bit-exact.
Then, in the port alone: 4 steps, a full save, 2 steps, an incremental
save, restore and 2 more steps equal training straight through, bit for
bit; and the port restores the JAX package's checkpoints with the slots
``linear`` and the scalar ``beta1_power``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu.feature_column import feature_column as jfc
from deeprec_tpu.optimizers import sparse as jsopt
from deeprec_tpu.train import loop as jloop
from deeprec_tpu.train import losses as jlosses
from deeprec_tpu.train.checkpoint import CheckpointManager as JCkpt
from deeprec_tpu_torch.feature_column import feature_column as tfc
from deeprec_tpu_torch.optimizers import dense as tdense
from deeprec_tpu_torch.optimizers import sparse as tsopt
from deeprec_tpu_torch.train import loop as tloop
from deeprec_tpu_torch.train import losses as tlosses
from deeprec_tpu_torch.train.checkpoint import CheckpointManager as TCkpt

torch.set_num_threads(1)

STEPS = 8
TOL = dict(rtol=1e-5, atol=1e-6)
OPTS = {
    "sgd": lambda m: m.SparseSGD(0.1),
    "adagrad": lambda m: m.SparseAdagrad(0.1),
    "adagrad_decay": lambda m: m.SparseAdagradDecay(
        0.1, decay_step=3, decay_rate=0.5),
    "adam": lambda m: m.SparseAdam(0.01),
    "adam_async": lambda m: m.SparseAdamAsync(0.01),
    "adam_async_original": lambda m: m.SparseAdamAsync(
        0.01, apply_sparse_adam=False),
    "ftrl": lambda m: m.SparseFtrl(0.1, l1=0.001),
    "ftrl_v2": lambda m: m.SparseFtrlV2(learning_rate=0.1),
}


def _columns(fc):
    return [fc.EmbeddingColumn(name="f", dim=4, capacity=1 << 8,
                               initializer="uniform", combiner="sum")]


def _raw(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(1, 60, size=(16, 2)).astype(np.int64)
        out.append((ids, (ids.sum(1) % 2).astype(np.float32)))
    return out


RAW = _raw(STEPS)


def _loss_t(out, b):
    return tlosses.bce_with_logits(out, b["label"])


class _Port:
    def __init__(self, name):
        self.opt = OPTS[name](tsopt)
        self.group = tfc.EmbeddingGroup(_columns(tfc))
        self.dopt = tdense.Adagrad(0.05)
        self.step = tloop.make_train_step(
            self.group, lambda p, e, b: (e["f"] * p["w"]).sum(1), _loss_t,
            self.opt, self.dopt)

    def state(self):
        return tloop.create_train_state(self.group, {"w": torch.ones(4)},
                                        self.dopt, self.opt, device="cpu")

    def run(self, ts, raw):
        losses = []
        for ids, label in raw:
            ts, m = self.step(ts, {"f": tfc.SparseIds.from_numpy(ids, "cpu"),
                                   "label": torch.from_numpy(label)})
            losses.append(float(m["loss"]))
        return ts, losses


@pytest.fixture(scope="module", params=sorted(OPTS))
def jax_run(request, tmp_path_factory):
    """8 JAX steps: losses, the final state as numpy, and a full
    checkpoint after step 4."""
    name = request.param
    opt = OPTS[name](jsopt)
    group = jfc.EmbeddingGroup(_columns(jfc))
    tx = optax.adagrad(0.05)
    step = jloop.make_train_step(
        group, lambda p, e, b: jnp.sum(e["f"] * p["w"], axis=1),
        lambda o, b: jlosses.bce_with_logits(o, b["label"]), opt, tx,
        donate=False)
    ts = jloop.create_train_state(group, {"w": jnp.ones((4,))}, tx, opt)
    losses = []
    ckpt = str(tmp_path_factory.mktemp(name))
    for i, (ids, label) in enumerate(RAW):
        ts, m = step(ts, {"f": jfc.SparseIds.from_numpy(ids),
                          "label": jnp.asarray(label)})
        losses.append(float(m["loss"]))
        if i == 3:
            JCkpt(ckpt, group).save(ts)
            at4 = jax.tree.map(np.asarray, ts.slots["f"])
    return {"name": name, "losses": losses, "ckpt": ckpt, "slots4": at4,
            "ev": jax.tree.map(np.asarray, ts.ev["f"]),
            "slots": jax.tree.map(np.asarray, ts.slots["f"])}


def _assert_slots(tslots, jslots):
    assert set(tslots) == set(jslots)
    for k, v in jslots.items():
        np.testing.assert_allclose(tslots[k].numpy(), v, **TOL, err_msg=k)


def test_matches_jax(jax_run):
    port = _Port(jax_run["name"])
    ts, losses = port.run(port.state(), RAW)
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-5)
    jev, tev = jax_run["ev"], ts.ev["f"]
    np.testing.assert_array_equal(tev.table.key_rows.numpy(),
                                  jev.table.key_rows)
    np.testing.assert_array_equal(tev.freqs.numpy(), jev.freqs)
    np.testing.assert_array_equal(tev.versions.numpy(), jev.versions)
    np.testing.assert_allclose(tev.values.numpy(), jev.values, **TOL)
    _assert_slots(ts.slots["f"], jax_run["slots"])


def test_checkpoint_round_trip_is_identical(jax_run, tmp_path):
    port = _Port(jax_run["name"])
    want, _ = port.run(port.state(), RAW)

    ts, _ = port.run(port.state(), RAW[:4])
    mgr = TCkpt(str(tmp_path), port.group)
    mgr.save(ts)
    ts, _ = port.run(ts, RAW[4:6])
    mgr.save(ts, incremental=True, since_step=4)
    ts = mgr.restore(port.state())
    assert ts.step == 6
    ts, _ = port.run(ts, RAW[6:])
    for a, b in ((want.ev["f"].values, ts.ev["f"].values),
                 (want.ev["f"].table.key_rows, ts.ev["f"].table.key_rows),
                 (want.params["w"], ts.params["w"])):
        assert torch.equal(a, b)
    for k, v in want.slots["f"].items():
        assert torch.equal(v, ts.slots["f"][k]), k


def test_port_restores_jax_checkpoint(jax_run):
    port = _Port(jax_run["name"])
    ts = TCkpt(jax_run["ckpt"], port.group).restore(port.state())
    assert ts.step == 4
    _assert_slots(ts.slots["f"], jax_run["slots4"])


def test_make_takes_every_name():
    assert set(tsopt.BY_NAME) == set(jsopt.BY_NAME)
    for name, cls in jsopt.BY_NAME.items():
        assert type(tsopt.make(name)).__name__ == cls.__name__
    assert tsopt.SparseFtrlV2().l2_shrinkage == jsopt.SparseFtrlV2(
        ).l2_shrinkage == 1e-3
