"""Port parity: the model zoo against the JAX package.

* The port's ``ZOO`` names the JAX package's 11 models.
* ``SyntheticBehavior`` and ``SyntheticMultiTask`` draw the JAX
  package's batches bit for bit.
* Every model (and DLRM's ``cat`` interaction, DeepFM's wide-in-deep
  layout) gives the flax forward's
  outputs on the same embedding dict from the same params (the port's,
  drawn from a seeded generator and carried across by ``convert.py``),
  float32 rtol 1e-5; its params take the flax init's names and shapes
  and survive ``convert.py`` both ways; its registry loss on those
  outputs matches too.
* DeepFM, DIN and DIEN train 3 steps through ``make_train_step`` from
  the same tables and weights as the JAX package: losses rtol 1e-5;
  key rows bit-equal, so rows, accumulators and dense params compare
  key by key, rtol 1e-5 / atol 1e-6 (``tests/test_torch_train.py``);
  then DIN's eval step outputs on a fourth batch.
* ``tools/train_zoo_torch.py`` trains a sequence and a multi-task model
  on the CPU with shrunk widths.
Small sizes (B <= 32, T <= 8, widths <= 8) in the style of
``tests/test_model_zoo.py``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu.data import behavior as jbehavior
from deeprec_tpu.data import criteo as jcriteo
from deeprec_tpu.feature_column.feature_column import EmbeddingGroup as JGroup
from deeprec_tpu.models import registry as jreg
from deeprec_tpu.models import structured as jstructured
from deeprec_tpu.optimizers import sparse as jsopt
from deeprec_tpu.train import loop as jloop
from deeprec_tpu_torch import convert
from deeprec_tpu_torch.data import behavior as tbehavior
from deeprec_tpu_torch.data import criteo as tcriteo
from deeprec_tpu_torch.feature_column.feature_column import (
    EmbeddingGroup as TGroup, SequenceEmbeddingColumn)
from deeprec_tpu_torch.layers.core import init_dense
from deeprec_tpu_torch.models import registry as treg
from deeprec_tpu_torch.models import structured as tstructured
from deeprec_tpu_torch.optimizers import dense as tdense
from deeprec_tpu_torch.optimizers import sparse as tsopt
from deeprec_tpu_torch.train import loop as tloop
from deeprec_tpu_torch.utils import keys as tkeys

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-5
B, T, DIM = 16, 6, 4
STEPS = 3

# Shrunk towers, the same on both sides.
MODULE_KWARGS = {
    "wdl": dict(hidden=(8, 4)),
    "deepfm": dict(hidden=(8, 4)),
    "dlrm": dict(embedding_dim=DIM, bottom=(8,), top=(8, 4)),
    "din": dict(hidden=(8, 4), att_hidden=(8, 4)),
    "dien": dict(gru_hidden=6, hidden=(8, 4)),
    "bst": dict(hidden=(8, 4), num_blocks=1, num_heads=2),
    "dssm": dict(tower=(8, 4)),
    "esmm": dict(tower=(8, 4)),
    "mmoe": dict(num_experts=2, expert=(8,), tower=(4,)),
    "dbmtl": dict(bottom=(8,), tower=(4,)),
    "simple_multitask": dict(tower=(8, 4)),
}
MODELS = sorted(MODULE_KWARGS) + ["dlrm_cat", "deepfm_wide_in_deep"]


def _spec(name):
    """(registry name, module kwargs, column kwargs)."""
    base = {"dlrm_cat": "dlrm", "deepfm_wide_in_deep": "deepfm"}.get(name,
                                                                     name)
    mk = dict(MODULE_KWARGS[base])
    ck = dict(embedding_dim=DIM, capacity=1 << 10)
    if name == "dlrm_cat":
        mk["interaction_op"] = "cat"
    if name == "deepfm_wide_in_deep":
        ck["wide_in_deep"] = True
    return base, mk, ck


def _embs_np(group, seed=0):
    """A seeded embedding dict of ``group``'s columns: bags [B, dim],
    sequences (rows zero at padding, mask) of random lengths >= 1."""
    r = np.random.default_rng(seed)
    embs = {}
    for c in group.embedding:
        if isinstance(c, SequenceEmbeddingColumn):
            mask = (np.arange(T)[None, :]
                    < r.integers(1, T + 1, size=B)[:, None])
            rows = r.normal(size=(B, T, c.dim)).astype(np.float32)
            embs[c.name] = (rows * mask[..., None], mask)
        else:
            embs[c.name] = r.normal(size=(B, c.dim)).astype(np.float32)
    numeric = r.normal(size=(B, 13)).astype(np.float32)
    return embs, numeric


def _to(embs, fn):
    return {k: tuple(fn(x) for x in v) if isinstance(v, tuple) else fn(v)
            for k, v in embs.items()}


def _flat(out):
    """Model output as a list of float32 arrays (logits, the towers, the
    task dict in key order, DIEN's (logit, aux))."""
    if isinstance(out, dict):
        return [a for k in sorted(out) for a in _flat(out[k])]
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _flat(o)]
    if isinstance(out, torch.Tensor):
        return [out.detach().to(torch.float32).numpy()]
    return [np.asarray(out, np.float32)]


_BUILT = {}


def _built(name):
    """Both modules of ``name``, the port's weights drawn from a seeded
    generator and carried to the flax layout (``params_to_numpy``), the
    flax forward on them, and the flax init's param shapes."""
    if name not in _BUILT:
        base, mk, ck = _spec(name)
        jentry, tentry = jreg.ZOO[base], treg.ZOO[base]
        jg = JGroup(jentry.columns(**ck), coalesce=True)
        tg = TGroup(tentry.columns(**ck), coalesce=True)
        embs, numeric = _embs_np(tg)
        jmodel = jentry.make_module(**mk)
        seq = base in treg.SEQUENCE_MODELS
        jargs = (_to(embs, jnp.asarray),) + (
            () if seq else (jnp.asarray(numeric),))
        shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                                *jargs)["params"]
        tmodel = tentry.make_module(tg, device="cpu",
                                    **(dict(mk, seq_len=T) if base == "bst"
                                       else mk))
        init_dense(tmodel, torch.Generator().manual_seed(0))
        params = convert.params_to_numpy(tmodel.state_dict())
        want = jax.jit(lambda p: jmodel.apply({"params": p}, *jargs))(params)
        targs = (_to(embs, torch.from_numpy),) + (
            () if seq else (torch.from_numpy(numeric),))
        _BUILT[name] = dict(jmodel=jmodel, params=params, shapes=shapes,
                            want=want, tmodel=tmodel, targs=targs, tg=tg,
                            jg=jg)
    return _BUILT[name]


def test_zoo_names_match_the_jax_registry():
    assert set(treg.ZOO) == set(jreg.ZOO) and len(treg.ZOO) == 11
    assert set(treg.ZOO) == set(MODULE_KWARGS)


@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_flax(name):
    b = _built(name)
    with torch.no_grad():
        got = _flat(b["tmodel"](*b["targs"]))
    want = _flat(b["want"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **FP32_TOL)


@pytest.mark.parametrize("name", MODELS)
def test_params_roundtrip(name):
    """The port's params in the flax layout have the flax init's names
    and shapes, and cross back bit for bit into a fresh module."""
    b = _built(name)
    flat_s = jax.tree_util.tree_flatten_with_path(b["shapes"])[0]
    flat_p = dict(jax.tree_util.tree_flatten_with_path(b["params"])[0])
    assert len(flat_s) == len(flat_p)
    for path, leaf in flat_s:
        assert flat_p[path].shape == leaf.shape
        assert flat_p[path].dtype == leaf.dtype == np.float32
    base, mk, _ = _spec(name)
    fresh = treg.ZOO[base].make_module(
        b["tg"], device="cpu", **(dict(mk, seq_len=T) if base == "bst"
                                  else mk))
    fresh.load_state_dict(convert.params_from_numpy(b["params"]),
                          strict=True)
    for k, v in b["tmodel"].state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


@pytest.mark.parametrize("name", sorted(MODULE_KWARGS))
def test_loss_matches_jax(name):
    """The registry's loss on the forward's outputs (BCE; DIEN's with its
    aux term; DSSM's in-batch softmax at temperature 0.2; the multi-task
    sums and ESMM's pCTCVR) against the JAX package's."""
    b = _built(name)
    r = np.random.default_rng(11)
    labels = {k: (r.random(B) < 0.4).astype(np.float32)
              for k in ("label", "click")}
    labels["conversion"] = labels["click"] * (r.random(B) < 0.5)
    with torch.no_grad():
        out = b["tmodel"](*b["targs"])
        got = treg.ZOO[name].loss(
            out, {k: torch.from_numpy(v) for k, v in labels.items()})
    want = jreg.ZOO[name].loss(
        b["want"], {k: jnp.asarray(v) for k, v in labels.items()})
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


def _ids_equal(jsparse, raw):
    hi, lo = tkeys.split_ids(np.asarray(raw, np.int64))
    np.testing.assert_array_equal(np.asarray(jsparse.hi), hi)
    np.testing.assert_array_equal(np.asarray(jsparse.lo), lo)


def test_behavior_stream_is_bit_equal():
    kw = dict(num_items=500, num_cats=40, num_users=100, seq_len=7, seed=3)
    j = jbehavior.SyntheticBehavior(24, **kw)
    t = tbehavior.SyntheticBehavior(24, **kw)
    for _ in range(3):
        jb, tb = j.next_batch(), t.next_batch_np()
        assert set(jb) == set(tb)
        np.testing.assert_array_equal(np.asarray(jb["label"]), tb["label"])
        for k in tbehavior.SPARSE:
            _ids_equal(jb[k], tb[k])
    dev = t.next_batch("cpu")
    assert dev["seq_items"].hi.shape == (24, 7)


def test_multitask_stream_is_bit_equal():
    j = jcriteo.SyntheticMultiTask(24, vocab=1000, seed=5)
    t = tcriteo.SyntheticMultiTask(24, vocab=1000, seed=5)
    for _ in range(3):
        jb, tb = j.next_batch(), t.next_batch_np(wide=True)
        assert set(jb) == set(tb) and "label" not in tb
        for k, v in tb.items():
            if k.startswith("C"):
                _ids_equal(jb[k], v)
            else:
                np.testing.assert_array_equal(np.asarray(jb[k]), v)
    assert "C1_wide" not in t.next_batch_np()


def test_combine_tables_rejects_sequence_columns():
    tg = TGroup(treg.ZOO["din"].columns(embedding_dim=DIM,
                                        capacity=1 << 10), coalesce=True)
    raw = tbehavior.SyntheticBehavior(8, seq_len=1).next_batch_np()
    ts = tloop.create_train_state(tg, {}, device="cpu")
    _, gl = tg.lookup_train(ts.ev, tg.pack_batch_np(raw, "cpu"), 0)
    rows = {t: lk.rows for t, lk in gl.lks.items()}
    seq, mask = tg.combine(gl, rows)["seq_items"]
    assert seq.shape == (8, 1, DIM) and mask.shape == (8, 1)
    with pytest.raises(ValueError, match="seq_items"):
        tg.combine_tables(gl, rows)


def test_structured_score_matches_jax():
    r = np.random.default_rng(7)
    wu = r.normal(size=(5, 4)).astype(np.float32)
    wi = r.normal(size=(3, 4)).astype(np.float32)
    users = r.normal(size=(B, 5)).astype(np.float32)
    items = r.normal(size=(B, 9, 3)).astype(np.float32)
    jm = jstructured.StructuredModel(lambda p, u: u @ p["wu"],
                                     lambda p, i: i @ p["wi"])
    tm = tstructured.StructuredModel(lambda p, u: u @ p["wu"],
                                     lambda p, i: i @ p["wi"])
    want = jm.apply({"wu": jnp.asarray(wu), "wi": jnp.asarray(wi)},
                    jnp.asarray(users), jnp.asarray(items))
    got = tm.apply({"wu": torch.from_numpy(wu), "wi": torch.from_numpy(wi)},
                   torch.from_numpy(users), torch.from_numpy(items))
    assert got.shape == (B, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


TRAIN_MODELS = ["deepfm", "din", "dien"]
EVAL_MODEL = "din"  # each JAX eval step costs seconds of compile


def _raw_batches(name, n):
    if name in treg.SEQUENCE_MODELS:
        d = tbehavior.SyntheticBehavior(B, num_items=300, num_cats=30,
                                        num_users=50, seq_len=T, seed=1)
        return [d.next_batch_np() for _ in range(n)]
    d = tcriteo.SyntheticCriteo(B, vocab=500, seed=1)
    return [d.next_batch_np(wide=True) for _ in range(n)]


_TRAINED = {}


@pytest.fixture(scope="module", params=TRAIN_MODELS)
def trained(request):
    return _trained(request.param)


def _trained(name):
    """Three steps of ``name`` in both packages, run once."""
    if name in _TRAINED:
        return _TRAINED[name]
    b = _built(name)
    jg, tg = b["jg"], b["tg"]
    jentry, tentry = jreg.ZOO[name], treg.ZOO[name]
    raw = _raw_batches(name, STEPS + 1)
    # A logit of exactly 0 (every unit of a tiny tower dead, bias 0)
    # takes another gradient in the two packages (ROADMAP fault 3.5):
    # start the head's bias off 0.
    params = jax.tree.map(np.copy, b["params"])
    params["head"]["logits"]["bias"] = np.full((1,), 0.1, np.float32)
    jopt, topt = jsopt.SparseAdagrad(0.05), tsopt.SparseAdagrad(0.05)
    tx, dopt = optax.adagrad(0.05), tdense.Adagrad(0.05)
    jts = jloop.create_train_state(jg, params, tx, jopt)
    jstep = jloop.make_train_step(jg, jentry.make_apply(b["jmodel"], jg),
                                  jentry.loss, jopt, tx, donate=False)
    tts = tloop.create_train_state(
        tg, convert.params_from_numpy(params), dopt, topt, device="cpu")
    tstep = tloop.make_train_step(tg, tentry.make_apply(b["tmodel"], tg),
                                  tentry.loss, topt, dopt)
    out = {"jloss": [], "tloss": []}
    for r in raw[:STEPS]:
        jts, jm = jstep(jts, jg.pack_batch_np(r))
        tts, tm = tstep(tts, tg.pack_batch_np(r, "cpu"))
        out["jloss"].append(float(jm["loss"]))
        out["tloss"].append(float(tm["loss"]))
    if name == EVAL_MODEL:
        out["jeval"] = jloop.make_eval_step(
            jg, jentry.make_apply(b["jmodel"], jg))(
                jts, jg.pack_batch_np(raw[-1]))
        out["teval"] = tloop.make_eval_step(
            tg, tentry.make_apply(b["tmodel"], tg))(
                tts, tg.pack_batch_np(raw[-1], "cpu"))
    out.update(jts=jts, tts=tts)
    _TRAINED[name] = out
    return out


def test_train_losses_match(trained):
    np.testing.assert_allclose(trained["tloss"], trained["jloss"],
                               rtol=LOSS_RTOL)
    assert all(np.isfinite(trained["tloss"]))


def test_train_tables_and_params_match(trained):
    jts, tts = trained["jts"], trained["tts"]
    for tname, jst in jts.ev.items():
        tst = tts.ev[tname]
        np.testing.assert_array_equal(tst.table.key_rows.numpy(),
                                      np.asarray(jst.table.key_rows))
        np.testing.assert_allclose(tst.values.numpy(),
                                   np.asarray(jst.values), **TOL)
        np.testing.assert_allclose(tts.slots[tname]["accum"].numpy(),
                                   np.asarray(jts.slots[tname]["accum"]),
                                   **TOL)
    jp = jax.tree.map(np.asarray, jts.params)
    tp = convert.params_to_numpy(tts.params)
    flat_t = dict(jax.tree_util.tree_flatten_with_path(tp)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        np.testing.assert_allclose(flat_t[path], leaf, **TOL)


def test_eval_step_matches_after_training():
    """The eval step's sequence-column path (``eval_embeddings``), on
    DIN's trained state; the bag path is ``tests/test_torch_wdl.py``'s."""
    trained = _trained(EVAL_MODEL)
    got, want = _flat(trained["teval"]), _flat(trained["jeval"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **FP32_TOL)


@pytest.mark.parametrize("name", ["din", "esmm"])
def test_train_zoo_cli_runs_on_cpu(name, monkeypatch):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import train_zoo_torch as tz

    monkeypatch.setitem(tz.COLUMN_KWARGS, name,
                        dict(tz.COLUMN_KWARGS[name], capacity=1 << 10,
                             embedding_dim=DIM))
    monkeypatch.setitem(tz.MODULE_KWARGS, name, MODULE_KWARGS[name])
    monkeypatch.setitem(tz.SEQ_DATA, "seq_len", T)
    out = tz.main([name, "--cpu", "--steps", "3", "--batch_size", "32",
                   "--eval_steps", "2", "--log_steps", "1"])
    assert out["backend"] == "cpu" and out["steps"] == 3
    assert np.isfinite(out["final_loss"])
    # Single-logit models are evaluated; multi-task ones are not.
    assert ("auc" in out) == (name == "din")
    if name == "din":
        assert 0.0 < out["auc"] < 1.0
