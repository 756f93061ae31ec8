"""The fused per-table combine of the port (``combine_tables`` +
``wdl.apply_fn_fused``), mirroring ``tests/test_fused_combine.py``.

Against the JAX package: its ``combine_tables`` + ``apply_fn_fused``
through ``make_train_step(combine_fn=)`` and the port's, on the same
wide_in_deep column set (EV and static columns), from the same tower
weights (carried across by ``convert.py``) and batches, for 3 steps:
losses rtol 1e-5, hash key rows bit-exact, table rows, accumulators and
dense params rtol 1e-5, atol 1e-6, as in ``test_torch_train``.

Within the port: the fused path splits each table's occurrences into
its columns' embeddings and runs the dict path's forward, so with the
same params both paths give the same outputs and the same training: on
the CPU the losses, table rows and dense params of 4 steps (EV columns)
and 3 steps (static columns) are bit-identical. The rejections: a multi-valued column in
``combine_tables``, ``combine_fn`` with micro-batches, and a column set
with separate ``*_wide`` columns in ``apply_fn_fused``, which the JAX
package takes and misreads.
"""

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
from deeprec_tpu_torch import convert
from deeprec_tpu_torch.data.criteo import SyntheticCriteo
from deeprec_tpu_torch.feature_column import feature_column as tfc
from deeprec_tpu_torch.layers.core import init_dense
from deeprec_tpu_torch.models import wdl
from deeprec_tpu_torch.optimizers import dense as tdense
from deeprec_tpu_torch.optimizers import sparse as tsopt
from deeprec_tpu_torch.train import loop as tloop
from deeprec_tpu_torch.train import losses as tlosses

torch.set_num_threads(1)


def _loss_fn(out, batch):
    return tlosses.bce_with_logits(out, batch["label"])


TOL = dict(rtol=1e-5, atol=1e-6)
JAX_STEPS = 3
HIDDEN = (32, 16)


def _columns(m, static=False, wide_in_deep=True):
    return m.criteo_columns(embedding_dim=8, capacity=1 << 10,
                            wide_in_deep=wide_in_deep, static_buckets=static)


def _build(static=False, wide_in_deep=True):
    cols = _columns(wdl, static, wide_in_deep)
    group = tfc.EmbeddingGroup(cols, coalesce=True)
    model = wdl.WDL(wdl.input_width(group), hidden=(32, 16), device="cpu")
    init_dense(model, torch.Generator().manual_seed(0))
    return group, model


@pytest.mark.parametrize("static,steps", [(False, 4), (True, 3)],
                         ids=["ev", "static"])
def test_fused_matches_dict_path(static, steps):
    group, model = _build(static)
    opt = tsopt.SparseAdagrad(learning_rate=0.05)
    dopt = tdense.Adagrad(0.05)
    # The step updates the params in place: each state its own copy.
    ts_a, ts_b = (tloop.create_train_state(
        group, {k: v.clone() for k, v in model.state_dict().items()}, dopt,
        opt, device="cpu") for _ in range(2))
    step_a = tloop.make_train_step(group, wdl.apply_fn(model, group),
                                   _loss_fn, opt, dopt)
    step_b = tloop.make_train_step(group, wdl.apply_fn_fused(model, group),
                                   _loss_fn, opt, dopt,
                                   combine_fn=group.combine_tables)
    data = SyntheticCriteo(batch_size=64, vocab=500, seed=0)
    for _ in range(steps):
        raw = data.next_batch_np(wide=False)
        ts_a, ma = step_a(ts_a, group.pack_batch_np(raw, "cpu"))
        ts_b, mb = step_b(ts_b, group.pack_batch_np(raw, "cpu"))
        assert torch.equal(ma["loss"], mb["loss"])
        assert np.isfinite(float(ma["loss"]))
    for t in group.tables:
        assert torch.equal(ts_a.ev[t].values, ts_b.ev[t].values), t
        for k, v in ts_a.slots[t].items():
            assert torch.equal(v, ts_b.slots[t][k]), (t, k)
    for k, v in ts_a.params.items():
        assert torch.equal(v, ts_b.params[k]), k


@pytest.fixture(scope="module", params=[False, True], ids=["ev", "static"])
def jax_fused(request):
    """The JAX package's fused path for JAX_STEPS steps: its initial
    tower params, the raw batches, losses and final state."""
    static = request.param
    group = jfc.EmbeddingGroup(_columns(jwdl, static), coalesce=True)
    model = jwdl.WDL(hidden=HIDDEN)
    data = SyntheticCriteo(batch_size=64, vocab=500, seed=0)
    raws = [data.next_batch_np(wide=False) for _ in range(JAX_STEPS)]
    batches = [group.pack_batch_np(r) for r in raws]
    embs0 = {c.name: jnp.zeros((64, c.dim)) for c in group.embedding}
    params = model.init(jax.random.key(0), embs0,
                        group.numeric_features(batches[0]))["params"]
    opt, tx = jsopt.SparseAdagrad(0.05), optax.adagrad(0.05)
    ts = jloop.create_train_state(group, params, tx, opt)
    step = jloop.make_train_step(
        group, jwdl.apply_fn_fused(model, group),
        lambda o, b: jlosses.bce_with_logits(o, b["label"]), opt, tx,
        donate=False, combine_fn=group.combine_tables)
    losses = []
    for b in batches:
        ts, m = step(ts, b)
        losses.append(float(m["loss"]))
    return {"static": static, "raws": raws, "losses": losses,
            "params0": jax.tree.map(np.asarray, params), "ts": ts}


def test_fused_matches_jax(jax_fused):
    static = jax_fused["static"]
    group = tfc.EmbeddingGroup(_columns(wdl, static), coalesce=True)
    model = wdl.WDL(wdl.input_width(group), hidden=HIDDEN, device="cpu")
    opt, dopt = tsopt.SparseAdagrad(0.05), tdense.Adagrad(0.05)
    ts = tloop.create_train_state(
        group, convert.wdl_params_from_numpy(jax_fused["params0"]), dopt,
        opt, device="cpu")
    step = tloop.make_train_step(group, wdl.apply_fn_fused(model, group),
                                 _loss_fn, opt, dopt,
                                 combine_fn=group.combine_tables)
    losses = []
    for raw in jax_fused["raws"]:
        ts, m = step(ts, group.pack_batch_np(raw, "cpu"))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jax_fused["losses"], rtol=1e-5)
    jts = jax_fused["ts"]
    assert set(ts.ev) == set(jts.ev)
    for t, jst in jts.ev.items():
        if not static:
            np.testing.assert_array_equal(ts.ev[t].table.key_rows.numpy(),
                                          np.asarray(jst.table.key_rows))
        np.testing.assert_allclose(ts.ev[t].values.numpy(),
                                   np.asarray(jst.values), **TOL)
        tslots = convert.slots_to_numpy({t: ts.slots[t]})[t]
        jslots = jax.tree.map(np.asarray, jts.slots[t])
        assert set(tslots) == set(jslots)
        for k, v in jslots.items():
            np.testing.assert_allclose(tslots[k], v, **TOL, err_msg=k)
    flat_j = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jts.params))[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(
        convert.wdl_params_to_numpy(ts.params))[0])
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        np.testing.assert_allclose(flat_t[path], leaf, **TOL)


def test_combine_tables_rejects_multi_valued_columns():
    cols = [tfc.EmbeddingColumn("s", dim=4, capacity=1 << 8)]
    g = tfc.EmbeddingGroup(cols)
    ids = np.random.default_rng(0).integers(0, 50, (8, 5)).astype(np.int64)
    st, gl = g.lookup_train(g.create_state("cpu"),
                            {"s": tfc.SparseIds.from_numpy(ids, "cpu")}, 0)
    with pytest.raises(ValueError, match="width-1"):
        g.combine_tables(gl, {t: lk.rows for t, lk in gl.lks.items()})


def test_combine_fn_requires_one_micro_batch():
    group, model = _build()
    with pytest.raises(ValueError, match="micro_batch_num"):
        tloop.make_train_step(group, wdl.apply_fn_fused(model, group),
                              _loss_fn, tsopt.SparseAdagrad(),
                              tdense.Adagrad(0.05), micro_batch_num=2,
                              combine_fn=group.combine_tables)


def test_apply_fn_fused_rejects_separate_wide_columns():
    """The JAX package's ``apply_fn_fused`` does not raise here: it reads
    channel 0 of every deep embedding as a wide weight and drops it from
    the deep input, a model other than the dict path's. The port
    refuses the column set."""
    group, model = _build(wide_in_deep=False)
    assert any(c.name.endswith("_wide") for c in group.embedding)
    with pytest.raises(ValueError, match="wide_in_deep"):
        wdl.apply_fn_fused(model, group)
