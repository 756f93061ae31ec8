"""Port mirror of ``tests/test_ev_behavior_matrix.py``'s filter x
optimizer x checkpoint matrix and its CBF and eviction cases.

Every sparse optimizer under each admission filter (counter filter on
the sort-free lookup, CBF on the sorted one) resumes bit for bit from a
checkpoint saved mid-admission, as in the JAX package's test; and a
run straight through equals the JAX package's on the same batches
(dense Adam on both sides): CBF counters, freqs, versions and key rows
bit-exact, rows rtol 1e-5, atol 1e-6. That comparison starts the rows
from the uniform initializer, not the matrix's zeros: a logit of
exactly 0 has no derivative in ``bce_with_logits``'s ``max(x, 0)``,
where JAX takes 0 and PyTorch 1/2 (``tests/test_torch_optimizers.py``).
Then the single-table cases:
counter and CBF admission resume after an export/import, the CBF false
positive bound, eviction restarting the filter count, and a re-inserted
key's optimizer slots starting fresh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu import config as jcfg
from deeprec_tpu.feature_column import feature_column as jfc
from deeprec_tpu.optimizers import sparse as jsopt
from deeprec_tpu.train import loop as jloop
from deeprec_tpu.train import losses as jlosses
from deeprec_tpu_torch import config as cfglib
from deeprec_tpu_torch.embedding import variable as ev
from deeprec_tpu_torch.feature_column.feature_column import (EmbeddingColumn,
                                                             EmbeddingGroup,
                                                             SparseIds)
from deeprec_tpu_torch.optimizers import dense as tdense
from deeprec_tpu_torch.optimizers import sparse as sopt
from deeprec_tpu_torch.train import loop as trainlib
from deeprec_tpu_torch.train import losses
from deeprec_tpu_torch.train.checkpoint import CheckpointManager
from deeprec_tpu_torch.utils import keys as keylib

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)

OPTS = {
    "sgd": lambda m: m.SparseSGD(0.1),
    "adagrad": lambda m: m.SparseAdagrad(0.1),
    "adagrad_decay": lambda m: m.SparseAdagradDecay(
        0.1, decay_step=3, decay_rate=0.5),
    "adam": lambda m: m.SparseAdam(0.01),
    "adam_async": lambda m: m.SparseAdamAsync(0.01),
    "ftrl": lambda m: m.SparseFtrl(0.1, l1=0.001),
    "ftrl_v2": lambda m: m.SparseFtrlV2(learning_rate=0.1),
}

FILTERS = {
    "counter": lambda m: m.EmbeddingVariableOption(
        filter_option=m.CounterFilter(filter_freq=3)),
    "cbf": lambda m: m.EmbeddingVariableOption(
        filter_option=m.CBFFilter(filter_freq=3, num_counters=2048,
                                  num_hash_func=2)),
}


def _q(ids):
    hi, lo = keylib.split_ids(np.asarray(ids, np.int64))
    return torch.from_numpy(hi), torch.from_numpy(lo)


def _loss(out, b):
    return losses.bce_with_logits(out, b["label"])


def _setup(opt, ev_option, initializer="zeros"):
    cols = [EmbeddingColumn(name="f", dim=4, capacity=1 << 8,
                            initializer=initializer, combiner="sum",
                            ev_option=ev_option)]
    group = EmbeddingGroup(cols)
    dense = tdense.Adam(0.05)
    ts = trainlib.create_train_state(group, {"w": torch.ones(4)}, dense, opt,
                                     device="cpu")
    step = trainlib.make_train_step(
        group, lambda p, e, b: (e["f"] * p["w"]).sum(dim=1), _loss, opt,
        dense)
    return group, ts, step


def _raw(n, seed=0, lo=1, hi=60):
    rng = np.random.default_rng(seed)
    return [rng.integers(lo, hi, size=(16, 2)).astype(np.int64)
            for _ in range(n)]


def _batch(ids):
    return {"f": SparseIds.from_numpy(ids, "cpu"),
            "label": torch.from_numpy((ids.sum(1) % 2).astype(np.float32))}


def _jax_run(oname, fname, raw):
    """The JAX package straight through ``raw``, with dense Adam, from
    uniform rows."""
    group = jfc.EmbeddingGroup([jfc.EmbeddingColumn(
        name="f", dim=4, capacity=1 << 8, initializer="uniform",
        combiner="sum", ev_option=FILTERS[fname](jcfg))])
    tx, opt = optax.adam(0.05), OPTS[oname](jsopt)
    ts = jloop.create_train_state(group, {"w": jnp.ones((4,))}, tx, opt)
    step = jloop.make_train_step(
        group, lambda p, e, b: jnp.sum(e["f"] * p["w"], axis=1),
        lambda out, b: jlosses.bce_with_logits(out, b["label"]), opt, tx,
        donate=False)
    for ids in raw:
        ts, _ = step(ts, {"f": jfc.SparseIds.from_numpy(ids),
                          "label": jnp.asarray(
                              (ids.sum(1) % 2).astype(np.float32))})
    return jax.tree.map(np.asarray, ts.ev["f"])


@pytest.mark.parametrize("fname", sorted(FILTERS))
@pytest.mark.parametrize("oname", sorted(OPTS))
def test_optimizer_filter_ckpt_restore_identical(oname, fname, tmp_path):
    raw = _raw(8)
    batches = [_batch(ids) for ids in raw]

    group, ts, step = _setup(OPTS[oname](sopt), FILTERS[fname](cfglib))
    for b in batches:
        ts, _ = step(ts, b)
    want = ts

    group2, ts2, step2 = _setup(OPTS[oname](sopt), FILTERS[fname](cfglib))
    for b in batches[:3]:   # many ids are still below filter_freq here
        ts2, _ = step2(ts2, b)
    mgr = CheckpointManager(str(tmp_path / f"{oname}-{fname}"), group2)
    mgr.save(ts2)
    _, template, _ = _setup(OPTS[oname](sopt), FILTERS[fname](cfglib))
    ts3 = mgr.restore(template)
    for b in batches[3:]:
        ts3, _ = step2(ts3, b)

    np.testing.assert_allclose(
        want.ev["f"].values.numpy(), ts3.ev["f"].values.numpy(),
        rtol=1e-6, atol=1e-7,
        err_msg=f"{oname}x{fname}: values diverge after mid-admission "
                f"restore")
    np.testing.assert_array_equal(want.ev["f"].freqs.numpy(),
                                  ts3.ev["f"].freqs.numpy())
    np.testing.assert_array_equal(want.ev["f"].bloom.numpy(),
                                  ts3.ev["f"].bloom.numpy())

    # Straight through from uniform rows, against the JAX package.
    _, ts4, step4 = _setup(OPTS[oname](sopt), FILTERS[fname](cfglib),
                           "uniform")
    for b in batches:
        ts4, _ = step4(ts4, b)
    jst = _jax_run(oname, fname, raw)
    tst = ts4.ev["f"]
    for field in ("freqs", "versions", "bloom"):
        np.testing.assert_array_equal(getattr(tst, field).numpy(),
                                      getattr(jst, field), err_msg=field)
    np.testing.assert_array_equal(tst.table.key_rows.numpy(),
                                  jst.table.key_rows)
    np.testing.assert_allclose(tst.values.numpy(), jst.values, **TOL)


def _one():
    return torch.ones(1, dtype=torch.int32)


def test_counter_filter_admission_resumes_after_restore():
    cfg = cfglib.TableConfig(
        name="t", dim=4, capacity=64, initializer="constant",
        init_scale=1.0, ev_option=cfglib.EmbeddingVariableOption(
            filter_option=cfglib.CounterFilter(filter_freq=3)))
    state = ev.create(cfg, "cpu")
    qhi, qlo = _q([42])
    state, lk = ev.lookup_train(cfg, state, qhi, qlo, _one(), 0)
    state, lk = ev.lookup_train(cfg, state, qhi, qlo, _one(), 1)
    assert not bool(lk.admitted[0])
    snap = ev.export_arrays(cfg, state)
    state2 = ev.import_arrays(cfg, ev.create(cfg, "cpu"), snap)
    state2, lk2 = ev.lookup_train(cfg, state2, qhi, qlo, _one(), 2)
    assert bool(lk2.admitted[0])  # 2 (restored) + 1 = 3 >= filter_freq


def test_cbf_admission_resumes_after_restore():
    cfg = cfglib.TableConfig(
        name="t", dim=4, capacity=64,
        ev_option=cfglib.EmbeddingVariableOption(
            filter_option=cfglib.CBFFilter(filter_freq=4, num_counters=2048,
                                           num_hash_func=2)))
    state = ev.create(cfg, "cpu")
    qhi, qlo = _q([99])
    state, lk = ev.lookup_train(cfg, state, qhi, qlo,
                                torch.full((1,), 3, dtype=torch.int32), 0)
    assert int(ev.num_live(state)) == 0  # 3 < 4: not yet inserted
    snap = ev.export_arrays(cfg, state)
    assert "bloom" in snap
    state2 = ev.import_arrays(cfg, ev.create(cfg, "cpu"), snap)
    state2, lk2 = ev.lookup_train(cfg, state2, qhi, qlo, _one(), 1)
    assert bool(lk2.admitted[0]) and int(ev.num_live(state2)) == 1


def test_cbf_false_positive_rate_bounded():
    """After counting 200 distinct ids once each into 4096 x 2 counters,
    under 5 % of fresh ids falsely pass filter_freq=2 (expected ~1 %)."""
    cfg = cfglib.TableConfig(
        name="t", dim=4, capacity=1 << 12,
        ev_option=cfglib.EmbeddingVariableOption(
            filter_option=cfglib.CBFFilter(filter_freq=2, num_counters=4096,
                                           num_hash_func=2)))
    state = ev.create(cfg, "cpu")
    qhi, qlo = _q(np.arange(1, 201))
    state, _ = ev.lookup_train(cfg, state, qhi, qlo,
                               torch.ones(200, dtype=torch.int32), 0)
    fhi, flo = _q(np.arange(10_001, 11_001))
    state, lk = ev.lookup_train(cfg, state, fhi, flo,
                                torch.ones(1000, dtype=torch.int32), 1)
    assert float(lk.admitted.float().mean()) < 0.05


def test_eviction_resets_filter_counting():
    cfg = cfglib.TableConfig(
        name="t", dim=4, capacity=64,
        ev_option=cfglib.EmbeddingVariableOption(
            filter_option=cfglib.CounterFilter(filter_freq=3),
            evict_option=cfglib.GlobalStepEvict(steps_to_live=5)))
    state = ev.create(cfg, "cpu")
    qhi, qlo = _q([7])
    for s in range(4):   # freq 4 >= 3: admitted
        state, lk = ev.lookup_train(cfg, state, qhi, qlo, _one(), s)
    assert bool(lk.admitted[0])
    state = ev.shrink(cfg, state, 20)   # 20 - 3 > 5: evicted
    assert int(ev.num_live(state)) == 0
    state, lk = ev.lookup_train(cfg, state, qhi, qlo, _one(), 21)
    assert not bool(lk.admitted[0])  # counting restarted


@pytest.mark.parametrize("oname", ["adagrad", "adam"])
def test_eviction_reinsert_resets_optimizer_slots(oname):
    opt = OPTS[oname](sopt)
    cfg = cfglib.TableConfig(
        name="t", dim=4, capacity=64, initializer="zeros",
        ev_option=cfglib.EmbeddingVariableOption(
            evict_option=cfglib.GlobalStepEvict(steps_to_live=2)))
    state = ev.create(cfg, "cpu")
    slots = opt.init(cfg, "cpu")
    qhi, qlo = _q([5])
    g = torch.full((1, 4), 1.0)
    for s in range(3):
        state, lk = ev.lookup_train(cfg, state, qhi, qlo, _one(), s)
        slots, state.values = opt.apply(cfg, slots, state.values, lk, g, s)
    state = ev.shrink(cfg, state, 10)
    assert int(ev.num_live(state)) == 0
    state, lk = ev.lookup_train(cfg, state, qhi, qlo, _one(), 11)
    slots, state.values = opt.apply(cfg, slots, state.values, lk, g, 11)
    s_new = int(lk.slots[0])

    state_f = ev.create(cfg, "cpu")
    slots_f = opt.init(cfg, "cpu")
    state_f, lk_f = ev.lookup_train(cfg, state_f, qhi, qlo, _one(), 0)
    slots_f, _ = opt.apply(cfg, slots_f, state_f.values, lk_f, g, 0)
    s_f = int(lk_f.slots[0])
    for n_, b in slots_f.items():
        if b.dim() >= 1 and b.shape[0] == cfg.capacity + 1:
            np.testing.assert_allclose(
                slots[n_][s_new].numpy(), b[s_f].numpy(), rtol=1e-6,
                err_msg=f"{oname}: slot row {n_} not re-initialized")
