"""Port parity: the table variants on a mesh of gloo ranks.

An adaptive model (its EV half row-sharded, hotness and migration
computed on the owner shard, the static table a dense param every rank
holds) and a dyn-dim model (the base table and its ``#hot`` sibling
both row-sharded, the sibling's CBF admission on the owner) train five
steps at S = 2 (``tests/torch_mesh_cases.py``), each rank on its half
of a 16-row global batch, and the port on one device trains the same
global batches, as the JAX package does, from the same weights
(``tests/torch_variant_parity.py``). Losses agree within rtol 1e-5 and
with the JAX package's; the tables hold the same keys and their rows
agree key by key within rtol 1e-5, atol 1e-6; so do the dense params
(the static tables included) and the sharded eval's logits. The S = 2
checkpoints restore on one device with the same keys and logits.
"""

import os

import numpy as np
import pytest
import torch

import torch_mesh_cases as mc
import torch_variant_parity as vp
from deeprec_tpu_torch.feature_column.feature_column import EmbeddingGroup
from deeprec_tpu_torch.train import checkpoint as tckpt
from deeprec_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

STEPS = 5
B = 16
KINDS = ("adaptive", "dyn_dim")
TOL = vp.TOL


def _cols(kind):
    """``cols(pkg)`` for the parity runner: ``mc.variant_columns`` in
    either package."""
    def cols(pkg):
        return [pkg.fc.EmbeddingColumn(**{
            f: getattr(c, f) for f in (
                "name", "dim", "capacity", "combiner", "init_scale",
                "adaptive_hot_threshold", "adaptive_buckets",
                "dyn_dim_blocks", "dyn_dim_thresholds",
                "dyn_dim_hot_capacity")})
            for c in mc.variant_columns(kind)]
    return cols


def _raw(kind):
    rng = np.random.default_rng(11)
    specs = {"a": 2, "b": 1} if kind == "adaptive" else {"f": 2, "g": 1}
    return vp.batches(rng, STEPS + 1, B, specs, vocab=24)


def _by_key(group, states):
    arrs = mc.table_arrays(group, states)
    return {t: dict(zip(arrs[f"keys/{t}"].tolist(), arrs[f"values/{t}"]))
            for t in group.tables}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("variants_mesh")
    single = {}
    for kind in KINDS:
        raw = _raw(kind)
        out = vp.run_pair(_cols(kind), raw[:STEPS], "adagrad",
                          eval_raw=raw[STEPS])
        single[kind] = out
        arrs = {f"p/{k}": v.numpy() for k, v in out.params0.items()}
        for i, r in enumerate(raw):
            arrs.update({f"b{i}/{k}": v for k, v in r.items()})
        np.savez(os.path.join(tmp, f"variant-{kind}.npz"), **arrs)
    mc.launch("variants", 2, tmp, kinds=KINDS, steps=STEPS)
    ranks = [mc.result("variants", tmp, r) for r in range(2)]
    return {"tmp": tmp, "single": single, "ranks": ranks}


@pytest.mark.parametrize("kind", KINDS)
def test_single_device_matches_jax(runs, kind):
    vp.assert_run_matches(runs["single"][kind])


@pytest.mark.parametrize("kind", KINDS)
def test_mesh_training_matches_one_device(runs, kind):
    single = runs["single"][kind]
    ranks = [mc.split_prefix(r, f"{kind}/") for r in runs["ranks"]]
    place = dict(ranks[0]["placement"].tolist())
    assert set(place.values()) == {"sharded"}
    assert set(place) == set(single.tg.tables)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], single.tloss, rtol=1e-5)
        np.testing.assert_allclose(r["loss"], single.jloss, rtol=1e-5)
    want = _by_key(single.tg, single.tts.ev)
    for t, rows in want.items():
        keys = np.concatenate([r[f"keys/{t}"] for r in ranks])
        vals = np.concatenate([r[f"values/{t}"] for r in ranks])
        assert np.unique(keys).size == keys.size, t
        assert set(keys.tolist()) == set(rows), t
        got = dict(zip(keys.tolist(), vals))
        ks = sorted(rows)
        np.testing.assert_allclose(np.stack([got[k] for k in ks]),
                                   np.stack([rows[k] for k in ks]), **TOL,
                                   err_msg=t)
    for k, v in single.tts.params.items():
        for r in ranks:
            np.testing.assert_allclose(r[f"params/{k}"], v.numpy(), **TOL)
    if kind == "dyn_dim":
        assert len(want["f#hot"]) >= 3
    else:
        assert any(st["a"][1].any() for st in single.tbits)


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_eval_matches_one_device(runs, kind):
    ranks = [mc.split_prefix(r, f"{kind}/") for r in runs["ranks"]]
    logits = np.concatenate([r["logits"] for r in ranks])
    np.testing.assert_allclose(logits, runs["single"][kind].teval, **TOL)
    np.testing.assert_allclose(logits, runs["single"][kind].jeval, **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_checkpoint_s2_restores_at_s1(runs, kind):
    single = runs["single"][kind]
    group = EmbeddingGroup(mc.variant_columns(kind))
    tmpl = tloop.create_train_state(
        group, {k: torch.zeros_like(v) for k, v in single.params0.items()},
        device="cpu")
    ts = tckpt.CheckpointManager(str(runs["tmp"] / f"ckpt-{kind}"),
                                 group).restore(tmpl)
    assert int(ts.step) == STEPS
    got, want = _by_key(group, ts.ev), _by_key(single.tg, single.tts.ev)
    assert {t: set(r) for t, r in got.items()} == {
        t: set(r) for t, r in want.items()}
    raw = _raw(kind)[STEPS]
    np.testing.assert_allclose(
        tloop.make_eval_step(group, vp.port_apply)(
            ts, vp.port_batch(raw)).numpy(), single.teval, **TOL)
