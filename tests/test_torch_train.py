"""Port parity: the training step against the JAX package.

The same seeded batches go through three steps of the JAX package's
``make_train_step`` and of the port's, from the same tower weights
(carried across by ``convert.py``) and empty tables, with
``SparseAdagrad`` and with ``SparseAdam`` on the tables and Adagrad on
the towers. Two configurations: the sizes of ``__graft_entry__._build``
(dim 16 and dim-1 wide columns, freq and version recorded: the exact
``U = n`` branch of ``lookup_train_occ``), and the reference-shape
column set at capacity ``1 << 12`` in the headline's LightHeader mode,
whose 65-wide table takes the budget branch (``U = 1,088`` of
``n = 1,152``). Towers run in float32 for parity; one run in bfloat16.

Integer state (hash key rows, freqs, versions, ``n_overflow``) must be
bit-exact, so both packages hold every key at the same slot; float state
is then compared slot by slot, which is key by key. Tolerances: losses
rtol 1e-5; table rows, accumulators and dense params rtol 1e-5, atol
1e-6 (float32 sums in another order, and row inits whose log/cos come
from another math library).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu import config as jcfg
from deeprec_tpu.embedding.variable import LookupResult as JLookupResult
from deeprec_tpu.feature_column.feature_column import EmbeddingGroup as JGroup
from deeprec_tpu.models import wdl as jwdl
from deeprec_tpu.optimizers import sparse as jsopt
from deeprec_tpu.train import loop as jloop
from deeprec_tpu.train import losses as jlosses
from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import convert
from deeprec_tpu_torch.data import criteo as tcriteo
from deeprec_tpu_torch.feature_column.feature_column import (
    EmbeddingGroup as TGroup)
from deeprec_tpu_torch.models import wdl as twdl
from deeprec_tpu_torch.optimizers import dense as tdense
from deeprec_tpu_torch.optimizers import sparse as tsopt
from deeprec_tpu_torch.train import loop as tloop
from deeprec_tpu_torch.train import losses as tlosses

torch.set_num_threads(1)

STEPS = 3
B = 64
TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-5
# bf16 towers round activations at every layer, at other points in the
# two frameworks, so every gradient differs by a few bf16 ulps. Largest
# differences seen after three steps: 1.1e-4 relative on the loss,
# 1.8e-4 absolute on the dense params, 1.9e-5 on table rows; the bounds
# are about 5x those.
BF16_LOSS_RTOL = 5e-4
BF16_TOL = dict(rtol=1e-3, atol=1e-3)

CONFIGS = {
    # __graft_entry__._build: dim 16, capacity 1 << 14, towers 256/128/64.
    "graft": dict(cols=lambda m, evo: m.criteo_columns(
        embedding_dim=16, capacity=1 << 14), vocab=5000, wide=True),
    # The headline's columns and EV mode at capacity 1 << 12.
    "reference": dict(cols=lambda m, evo: m.criteo_columns(
        capacity=1 << 12, reference_shapes=True, wide_in_deep=True,
        ev_option=evo(record_freq=False, record_version=False)),
        vocab=tcriteo.CRITEO_HASH_BUCKETS, wide=False),
}
HIDDEN = (256, 128, 64)


def _sparse(name):
    if name == "adagrad":
        return jsopt.SparseAdagrad(0.05), tsopt.SparseAdagrad(0.05)
    return jsopt.SparseAdam(), tsopt.SparseAdam()


def _run(config, opt_name, dtype):
    spec = CONFIGS[config]
    data = tcriteo.SyntheticCriteo(B, vocab=spec["vocab"], seed=0)
    raw = [data.next_batch_np(wide=spec["wide"]) for _ in range(STEPS)]

    jg = JGroup(spec["cols"](jwdl, jcfg.EmbeddingVariableOption),
                coalesce=True)
    jmodel = jwdl.WDL(hidden=HIDDEN, dtype=getattr(jnp, dtype))
    jb = [jg.pack_batch_np(r) for r in raw]
    embs0 = {c.name: jnp.zeros((B, c.dim)) for c in jg.embedding}
    params = jmodel.init(jax.random.key(0), embs0,
                         jg.numeric_features(jb[0]))["params"]
    jopt, topt = _sparse(opt_name)
    tx = optax.adagrad(0.05)
    jts = jloop.create_train_state(jg, params, tx, jopt)
    jstep = jloop.make_train_step(
        jg, jwdl.apply_fn(jmodel, jg),
        lambda o, b: jlosses.bce_with_logits(o, b["label"]), jopt, tx,
        donate=False)

    tg = TGroup(spec["cols"](twdl, tcfg.EmbeddingVariableOption),
                coalesce=True)
    tmodel = twdl.WDL(twdl.input_width(tg), hidden=HIDDEN,
                      dtype=getattr(torch, dtype), device="cpu")
    dopt = tdense.Adagrad(0.05)
    tts = tloop.create_train_state(
        tg, convert.wdl_params_from_numpy(jax.tree.map(np.asarray, params)),
        dopt, topt, device="cpu")
    tstep = tloop.make_train_step(
        tg, twdl.apply_fn(tmodel, tg),
        lambda o, b: tlosses.bce_with_logits(o, b["label"]), topt, dopt)

    out = {"jg": jg, "tg": tg, "jloss": [], "tloss": [], "jover": [],
           "tover": []}
    for r, b in zip(raw, jb):
        jts, jm = jstep(jts, b)
        tts, tm = tstep(tts, tg.pack_batch_np(r, "cpu"))
        out["jloss"].append(float(jm["loss"]))
        out["tloss"].append(float(tm["loss"]))
        out["jover"].append(int(jm["n_overflow"]))
        out["tover"].append(int(tm["n_overflow"]))
    out["jts"], out["tts"] = jts, tts
    return out


@pytest.fixture(scope="module", params=[
    ("graft", "adagrad", "float32"), ("graft", "adam", "float32"),
    ("reference", "adagrad", "float32"), ("reference", "adam", "float32"),
    ("graft", "adagrad", "bfloat16")], ids=lambda p: "-".join(p))
def run(request):
    out = _run(*request.param)
    out["dtype"] = request.param[2]
    return out


def _tol(run):
    return TOL if run["dtype"] == "float32" else BF16_TOL


def test_losses_and_overflow_match(run):
    rtol = LOSS_RTOL if run["dtype"] == "float32" else BF16_LOSS_RTOL
    np.testing.assert_allclose(run["tloss"], run["jloss"], rtol=rtol)
    assert run["tover"] == run["jover"]
    assert all(np.isfinite(run["tloss"]))


def test_budget_branch_taken_where_declared(run):
    """The reference-shape group bounds its 65-wide table's uniques
    (U = 1,088 of n = 1,152) and leaves the 129-wide one exact."""
    tg = run["tg"]
    budgets = {}
    for tname, tcols in tg._columns_by_table().items():
        widths = [1] * len(tcols)
        budgets[tg.tables[tname].dim] = tg._unique_budget(
            tcols, widths, (B, len(tcols)))
    if run["jg"].embedding[0].num_buckets is None:
        assert set(budgets.values()) == {None}
    else:
        assert budgets == {129: None, 65: 1088}


def test_tables_and_slots_match(run):
    jts, tts = run["jts"], run["tts"]
    tol = _tol(run)
    for tname, jst in jts.ev.items():
        tst = tts.ev[tname]
        np.testing.assert_array_equal(tst.table.key_rows.numpy(),
                                      np.asarray(jst.table.key_rows))
        np.testing.assert_array_equal(tst.freqs.numpy(),
                                      np.asarray(jst.freqs))
        np.testing.assert_array_equal(tst.versions.numpy(),
                                      np.asarray(jst.versions))
        np.testing.assert_allclose(tst.values.numpy(),
                                   np.asarray(jst.values), **tol)
        tslots = convert.slots_to_numpy({tname: tts.slots[tname]})[tname]
        jslots = jax.tree.map(np.asarray, jts.slots[tname])
        assert set(tslots) == set(jslots)
        for k, v in jslots.items():
            np.testing.assert_allclose(tslots[k], v, **tol)
    assert tts.step == int(jts.step) == STEPS


def test_dense_params_and_state_match(run):
    jts, tts = run["jts"], run["tts"]
    tol = _tol(run)
    jp = jax.tree.map(np.asarray, jts.params)
    tp = convert.wdl_params_to_numpy(tts.params)
    jsos = jax.tree.map(np.asarray, jts.dense_opt[0].sum_of_squares)
    tsos = convert.dense_opt_to_numpy(tts.dense_opt)
    # The JAX state converted into the port's layout matches it too.
    back = convert.dense_opt_from_numpy(
        jax.tree.map(np.asarray, jts.dense_opt))["sum_of_squares"]
    assert set(back) == set(tts.params)
    for k, v in back.items():
        np.testing.assert_allclose(
            tts.dense_opt["sum_of_squares"][k].numpy(), v.numpy(), **tol)
    for tree_j, tree_t in ((jp, tp), (jsos, tsos)):
        flat_j = jax.tree_util.tree_flatten_with_path(tree_j)[0]
        flat_t = dict(jax.tree_util.tree_flatten_with_path(tree_t)[0])
        assert len(flat_j) == len(flat_t)
        for path, leaf in flat_j:
            np.testing.assert_allclose(flat_t[path], leaf, **tol)


def test_unported_paths_raise():
    from deeprec_tpu_torch.embedding import variable as tev

    # CBF tables are ported; their sort-free lookup still refuses them,
    # as the JAX package's does (they take the sorted path).
    cbf = tcfg.EmbeddingVariableOption(filter_option=tcfg.CBFFilter(2))
    ccfg = tcfg.TableConfig(name="c", dim=4, capacity=64, ev_option=cbf)
    with pytest.raises(ValueError, match="CBF"):
        tev.lookup_train_occ(ccfg, tev.create(ccfg, "cpu"),
                             torch.zeros(2, dtype=torch.int32),
                             torch.arange(2, dtype=torch.int32), 0)
    # A dynamic-dimension table's kernel applies (refused until K2 and
    # K3 took the lookup's masked rows) equal the JAX package's on the
    # same lookup: the locked column of each fresh row is written back
    # as 0, not as its draw.
    kw = dict(name="d", dim=4, capacity=64, block_num=2,
              dyn_dim_thresholds=(2,))
    cfg, jcfg_ = tcfg.TableConfig(**kw), jcfg.TableConfig(**kw)
    st = tev.create(cfg, "cpu")
    hi = torch.zeros(3, dtype=torch.int32)
    lo = torch.arange(3, dtype=torch.int32)
    st, occ = tev.lookup_train_occ(cfg, st, hi, lo, 0)
    jlk = JLookupResult(**{k: jnp.asarray(v.numpy())
                           for k, v in occ.lk._asdict().items()})
    g = np.linspace(-1, 1, occ.lk.rows.numel(), dtype=np.float32).reshape(
        occ.lk.rows.shape) * (occ.lk.rows.numpy() != 0)
    for opt, jopt in ((tsopt.SparseAdagrad(), jsopt.SparseAdagrad()),
                      (tsopt.SparseAdamAsync(), jsopt.SparseAdamAsync())):
        values = st.values.clone()
        slots = opt.init(cfg, "cpu")
        opt.apply(cfg, slots, values, occ.lk, torch.from_numpy(g), 0)
        jslots, jvalues = jopt.apply(jcfg_, jopt.init(jcfg_),
                                     jnp.asarray(st.values.numpy()), jlk,
                                     jnp.asarray(g), 0)
        np.testing.assert_allclose(values.numpy(), np.asarray(jvalues),
                                   **TOL)
        for k, v in jslots.items():
            np.testing.assert_allclose(slots[k].numpy(), np.asarray(v),
                                       **TOL)
        assert bool((values[:3, 2:] == 0).all())
    # Micro-batches are ported; with a fused combine they are refused,
    # as in the JAX package.
    with pytest.raises(ValueError, match="micro_batch_num"):
        tloop.make_train_step(None, None, None, opt, None,
                              micro_batch_num=2, combine_fn=lambda *a: a)
