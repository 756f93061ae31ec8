"""Port parity: the model zoo through ``make_epoch_step``.

* DIN, ESMM, DSSM and DIEN (their own losses: BCE, ESMM's pCTCVR,
  DSSM's in-batch softmax, DIEN's BCE with its aux term; each with the
  JAX campaign's dense optimizer) trained by the port's
  ``make_epoch_step`` on a pool of 3 batches for 2 epochs, against the
  JAX package's ``make_epoch_step`` (one ``lax.scan``) on the same
  packed batches, from the port's tower weights carried across by
  ``convert.py`` and empty tables: losses ``[2, 3]`` rtol 1e-5
  (float32); key rows bit-equal, so rows, accumulators and dense params
  compare key by key, rtol 1e-5 / atol 1e-6
  (``tests/test_torch_train.py``).
* DIEN, BST, DLRM's cat interaction and MMoE: the port's step as the
  card runs it (batch ``k`` read through a device index, the global
  step a 0-dim tensor, the loss slot and both counters advanced by the
  step itself; the capture replaced by a direct call) against the eager
  ``make_train_step`` loop, bit for bit.
* On a card (``cuda`` marker): each of the 12 zoo runs (the 11 models
  and DLRM's cat interaction) captured against the eager loop, bit for
  bit, and the captured call leaves the card's reserved memory level
  from epoch to epoch.

Small sizes (B = 16, T = 6, dim 4, towers of width <= 8), in the style
of ``tests/test_torch_zoo.py``. JAX is imported inside the parity
fixture, so the ``cuda`` tests run where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_zoo_epoch.py -m cuda``.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from deeprec_tpu_torch import convert
from deeprec_tpu_torch.data import behavior as tbehavior
from deeprec_tpu_torch.data import criteo as tcriteo
from deeprec_tpu_torch.feature_column.feature_column import \
    EmbeddingGroup as TGroup
from deeprec_tpu_torch.layers.core import init_dense
from deeprec_tpu_torch.models import registry as treg
from deeprec_tpu_torch.optimizers import dense as tdense
from deeprec_tpu_torch.optimizers import sparse as tsopt
from deeprec_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

B, T, DIM = 16, 6, 4
POOL, EPOCHS = 3, 2
LOSS_RTOL = 1e-5
TOL = dict(rtol=1e-5, atol=1e-6)

MODULE_KWARGS = {
    "wdl": dict(hidden=(8, 4)),
    "deepfm": dict(hidden=(8, 4)),
    "dlrm": dict(embedding_dim=DIM, bottom=(8,), top=(8, 4)),
    "din": dict(hidden=(8, 4), att_hidden=(8, 4)),
    "dien": dict(gru_hidden=6, hidden=(8, 4)),
    "bst": dict(hidden=(8, 4), num_blocks=1, num_heads=2, seq_len=T),
    "dssm": dict(tower=(8, 4)),
    "esmm": dict(tower=(8, 4)),
    "mmoe": dict(num_experts=2, expert=(8,), tower=(4,)),
    "dbmtl": dict(bottom=(8,), tower=(4,)),
    "simple_multitask": dict(tower=(8, 4)),
}
RUNS = sorted(MODULE_KWARGS) + ["dlrm_cat"]
# The JAX campaign's dense optimizer of each (tools/zoo_auc.py CAMPAIGN).
DENSE = {"din": "adagrad", "esmm": "adam", "dssm": "adagrad", "dien": "adam"}


def _model(run, device="cpu"):
    """(group, module, registry entry) of a zoo run at the small sizes;
    the module's weights drawn from a seeded generator."""
    name = "dlrm" if run == "dlrm_cat" else run
    entry = treg.ZOO[name]
    group = TGroup(entry.columns(embedding_dim=DIM, capacity=1 << 10),
                   coalesce=True)
    mk = dict(MODULE_KWARGS[name])
    if run == "dlrm_cat":
        mk["interaction_op"] = "cat"
    module = entry.make_module(group, device=device, **mk)
    init_dense(module, torch.Generator().manual_seed(0))
    return group, module, entry


def _raw_batches(name, n, batch=B):
    if name in treg.SEQUENCE_MODELS:
        d = tbehavior.SyntheticBehavior(batch, num_items=300, num_cats=30,
                                        num_users=50, seq_len=T, seed=1)
        return [d.next_batch_np() for _ in range(n)]
    cls = (tcriteo.SyntheticMultiTask if name in ("esmm", "mmoe", "dbmtl",
                                                  "simple_multitask")
           else tcriteo.SyntheticCriteo)
    d = cls(batch, vocab=500, seed=1)
    return [d.next_batch_np(wide=True) for _ in range(n)]


def _port(run, device="cpu", dense="adagrad", params=None, batch=B):
    """The port's parts of a run as a namespace: group, apply, loss,
    optimizers, state (from ``params`` in the flax layout where given)
    and the packed pool."""
    name = "dlrm" if run == "dlrm_cat" else run
    group, module, entry = _model(run, device)
    dopt = tdense.Adam(2e-3) if dense == "adam" else tdense.Adagrad(0.05)
    sopt = tsopt.SparseAdagrad(0.05)
    state = (module.state_dict() if params is None
             else convert.params_from_numpy(params))
    ts = tloop.create_train_state(group, state, dopt, sopt, device=device)
    raw = _raw_batches(name, POOL, batch)
    return types.SimpleNamespace(
        group=group, module=module, afn=entry.make_apply(module, group),
        loss=entry.loss, dopt=dopt, sopt=sopt, ts=ts, raw=raw,
        pool=[group.pack_batch_np(r, device) for r in raw])


def _leaves(x, path=""):
    if isinstance(x, torch.Tensor):
        yield path, x
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{path}/{k}")
    elif hasattr(x, "__dataclass_fields__"):
        for k in x.__dataclass_fields__:
            yield from _leaves(getattr(x, k), f"{path}.{k}")


def _eager_loop(p, ts):
    """The eager ``make_train_step`` loop over the pool, EPOCHS times;
    returns (state, losses [EPOCHS * POOL])."""
    step = tloop.make_train_step(p.group, p.afn, p.loss, p.sopt, p.dopt)
    want = []
    for _ in range(EPOCHS):
        for b in p.pool:
            ts, m = step(ts, b)
            want.append(m["loss"])
    return ts, torch.stack(want)


# -- the JAX package's epoch scan ------------------------------------------

@pytest.fixture(scope="module")
def jx():
    import jax
    import optax

    from deeprec_tpu.feature_column.feature_column import EmbeddingGroup
    from deeprec_tpu.models import registry as jreg
    from deeprec_tpu.optimizers import sparse as jsopt
    from deeprec_tpu.train import loop as jloop

    return types.SimpleNamespace(jax=jax, optax=optax, Group=EmbeddingGroup,
                                 reg=jreg, sopt=jsopt, loop=jloop)


@pytest.fixture(scope="module", params=sorted(DENSE))
def both(request, jx):
    """One model trained by both packages' epoch steps."""
    name = request.param
    _, module, _ = _model(name)
    params = convert.params_to_numpy(module.state_dict())
    # A logit of exactly 0 takes another gradient in the two packages
    # (ROADMAP fault 3.5): start the heads' biases off 0.
    for head in ("head", "ctr_head", "cvr_head"):
        if head in params:
            params[head]["logits"]["bias"] = np.full((1,), 0.1, np.float32)
    p = _port(name, dense=DENSE[name], params=params)
    epoch = tloop.make_epoch_step(p.group, p.afn, p.loss, p.sopt, p.dopt,
                                  n_epochs=EPOCHS)
    tts, tlosses = epoch(p.ts, tloop.stack_batches(p.pool))

    jentry = jx.reg.ZOO[name]
    jg = jx.Group(jentry.columns(embedding_dim=DIM, capacity=1 << 10),
                  coalesce=True)
    jmodel = jentry.make_module(**MODULE_KWARGS[name])
    tx = (jx.optax.adam(2e-3) if DENSE[name] == "adam"
          else jx.optax.adagrad(0.05))
    jopt = jx.sopt.SparseAdagrad(0.05)
    jts = jx.loop.create_train_state(jg, params, tx, jopt)
    jepoch = jx.loop.make_epoch_step(jg, jentry.make_apply(jmodel, jg),
                                     jentry.loss, jopt, tx, n_epochs=EPOCHS)
    jts, jlosses = jepoch(jts, jx.loop.stack_batches(
        [jg.pack_batch_np(r) for r in p.raw]))
    return dict(name=name, tts=tts, tlosses=tlosses, jts=jts,
                jlosses=np.asarray(jlosses), jax=jx.jax)


def test_epoch_losses_match_jax(both):
    assert tuple(both["tlosses"].shape) == (EPOCHS, POOL)
    np.testing.assert_allclose(both["tlosses"].numpy(), both["jlosses"],
                               rtol=LOSS_RTOL)
    assert np.isfinite(both["jlosses"]).all()
    assert both["tts"].step == int(both["jts"].step) == EPOCHS * POOL


def test_epoch_tables_and_params_match_jax(both):
    jts, tts, jax = both["jts"], both["tts"], both["jax"]
    for tname, jst in jts.ev.items():
        tst = tts.ev[tname]
        np.testing.assert_array_equal(tst.table.key_rows.numpy(),
                                      np.asarray(jst.table.key_rows))
        np.testing.assert_array_equal(tst.freqs.numpy(),
                                      np.asarray(jst.freqs))
        np.testing.assert_allclose(tst.values.numpy(),
                                   np.asarray(jst.values), **TOL)
        np.testing.assert_allclose(tts.slots[tname]["accum"].numpy(),
                                   np.asarray(jts.slots[tname]["accum"]),
                                   **TOL)
    tp = convert.params_to_numpy(tts.params)
    flat_t = dict(jax.tree_util.tree_flatten_with_path(tp)[0])
    jp = jax.tree.map(np.asarray, jts.params)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        np.testing.assert_allclose(flat_t[path], leaf, **TOL)


# -- the card's path with the capture replaced by a direct call ------------

class _Event:
    def record(self):
        pass


@pytest.mark.parametrize("run", ["dien", "bst", "dlrm_cat", "mmoe"])
def test_device_counter_path_equals_the_step_loop(run, monkeypatch):
    p = _port(run)
    want_ts, want = _eager_loop(p, tloop.clone_state(p.ts))
    monkeypatch.setattr(tloop, "_capture", lambda fn: fn)
    monkeypatch.setattr(tloop, "_no_host_sync", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "Event", lambda **kw: _Event())
    epoch = tloop.make_epoch_step(p.group, p.afn, p.loss, p.sopt, p.dopt,
                                  n_epochs=EPOCHS)
    got = epoch._captured(p.ts, tloop.stack_batches(p.pool), POOL, EPOCHS,
                          torch.device("cpu"))
    assert epoch.last_run["replays"] == EPOCHS * POOL - 1
    assert torch.equal(got, want)
    a, d = dict(_leaves(want_ts)), dict(_leaves(p.ts))
    for path, t in a.items():
        assert torch.equal(t, d[path]), path


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("run", RUNS)
def test_captured_zoo_epoch_equals_eager_loop(cuda_device, run):
    p = _port(run, cuda_device, dense="adam", batch=256)
    eager, want = _eager_loop(p, tloop.clone_state(p.ts))
    epoch = tloop.make_epoch_step(p.group, p.afn, p.loss, p.sopt, p.dopt,
                                  n_epochs=EPOCHS)
    graph, losses = epoch(p.ts, tloop.stack_batches(p.pool))
    torch.cuda.synchronize()
    assert epoch.last_run["replays"] == EPOCHS * POOL - 1
    assert torch.equal(losses.reshape(-1), want)
    assert graph.step == eager.step == EPOCHS * POOL
    a, g = dict(_leaves(eager)), dict(_leaves(graph))
    for path, t in a.items():
        assert torch.equal(t, g[path]), path


@pytest.mark.cuda
def test_captured_calls_keep_reserved_memory_level(cuda_device):
    """Each call releases the last call's graph and its memory pool
    before it captures anew: fresh pools, one call each, leave the
    card's reserved memory where the second call left it."""
    p = _port("din", cuda_device, batch=256)
    epoch = tloop.make_epoch_step(p.group, p.afn, p.loss, p.sopt, p.dopt)
    reserved = []
    for i in range(4):
        data = tbehavior.SyntheticBehavior(256, num_items=300, num_cats=30,
                                           num_users=50, seq_len=T,
                                           seed=10 + i)
        pool = [p.group.pack_batch_np(data.next_batch_np(), cuda_device)
                for _ in range(POOL)]
        p.ts, _ = epoch(p.ts, tloop.stack_batches(pool))
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(cuda_device))
        del pool
    assert max(reserved[1:]) <= reserved[1], reserved
