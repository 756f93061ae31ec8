"""Port parity: metrics, dense Adam, the WorkQueue and the Estimator
against the JAX package, and the port's Estimator on its own (the cases
of ``tests/test_estimator.py``).

* Metrics: ``batch_auc`` (ties included), the streaming AUC,
  ``accuracy`` and ``recall_at_k`` on the same seeded scores; rtol 1e-6.
* Dense ``Adam`` against ``optax.adam`` over 20 steps; rtol 1e-6.
* ``WorkQueue``: the take order and state of both packages' queues,
  bit-exact (shuffled, two epochs, restored mid-way), and the TCP
  server on localhost.
* The slice as a whole: the WDL column set (dim 4, small capacities)
  with CBF admission and step eviction on every column, float32 towers,
  through both packages' ``Estimator`` with a ``CheckpointHook``
  (journaled shrink before every save, full and incremental saves) for
  8 steps from the same tower weights: losses per step rtol 1e-5; live
  keys, freqs, versions and CBF counters bit-exact; rows and
  accumulators key by key rtol 1e-5, atol 1e-6; held-out AUC within
  1e-4 (a histogram of scores that agree to float32 rounding).
* ``tools/train_zoo_torch.py`` refuses what the port lacks before any
  table is built, and trains with ``--micro_batch 2``;
  ``tools/train_wdl_torch.py --cpu`` prints ``tools/train_wdl.py``'s
  JSON keys.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu import config as jcfg
from deeprec_tpu.data.work_queue import WorkQueue as JQueue
from deeprec_tpu.feature_column import feature_column as jfc
from deeprec_tpu.models import wdl as jwdl
from deeprec_tpu.optimizers import sparse as jsopt
from deeprec_tpu.train import estimator as jest
from deeprec_tpu.train import losses as jlosses
from deeprec_tpu.train import metrics as jmetrics
from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import convert
from deeprec_tpu_torch.data import criteo as tcriteo
from deeprec_tpu_torch.data.work_queue import (RemoteWorkQueue, WorkQueue,
                                               WorkQueueServer)
from deeprec_tpu_torch.embedding import variable as tev
from deeprec_tpu_torch.feature_column import feature_column as tfc
from deeprec_tpu_torch.layers.core import MLP, LogitsHead, init_dense
from deeprec_tpu_torch.models import wdl as twdl
from deeprec_tpu_torch.optimizers import dense as tdense
from deeprec_tpu_torch.optimizers import sparse as tsopt
from deeprec_tpu_torch.train import losses as tlosses
from deeprec_tpu_torch.train import metrics as tmetrics
from deeprec_tpu_torch.train.estimator import (CheckpointHook, Estimator,
                                               Hook, LoggingHook,
                                               ProfilerHook)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)


# -- metrics ----------------------------------------------------------------

def _scores(seed, n=257):
    r = np.random.default_rng(seed)
    # Rounded to 1/8: many ties, which the stable sort ranks in order.
    logits = np.round(r.normal(size=n) * 8) / 8
    labels = (r.random(n) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    return logits.astype(np.float32), labels


def test_metrics_match_jax():
    for seed in range(3):
        lg, lb = _scores(seed)
        np.testing.assert_allclose(
            float(tmetrics.batch_auc(torch.from_numpy(lg),
                                     torch.from_numpy(lb))),
            float(jmetrics.batch_auc(jnp.asarray(lg), jnp.asarray(lb))),
            rtol=1e-6)
        np.testing.assert_allclose(
            float(tmetrics.accuracy(torch.from_numpy(lg),
                                    torch.from_numpy(lb))),
            float(jmetrics.accuracy(jnp.asarray(lg), jnp.asarray(lb))),
            rtol=1e-6)
    one_class = torch.ones(4)
    assert float(tmetrics.batch_auc(torch.arange(4.0), one_class)) == 0.5
    ts, js = tmetrics.auc_init(device="cpu"), jmetrics.auc_init()
    for seed in range(4):
        lg, lb = _scores(10 + seed, 1000)
        ts = tmetrics.auc_update(ts, torch.from_numpy(lg),
                                 torch.from_numpy(lb))
        js = jmetrics.auc_update(js, jnp.asarray(lg), jnp.asarray(lb))
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    np.testing.assert_array_equal(ts.neg.numpy(), np.asarray(js.neg))
    assert ts.pos.dtype == torch.float32
    np.testing.assert_allclose(float(tmetrics.auc_result(ts)),
                               float(jmetrics.auc_result(js)), rtol=1e-6)
    r = np.random.default_rng(3)
    u, v = r.normal(size=(64, 8)), r.normal(size=(64, 8))
    v[:32] = u[:32] + 0.1 * v[:32]
    assert tmetrics.recall_at_k(u, v, 5) == jmetrics.recall_at_k(u, v, 5)


def test_dense_adam_matches_optax():
    r = np.random.default_rng(0)
    p = {"deep.dense_0.weight": r.normal(size=(6, 5)).astype(np.float32),
         "deep.dense_0.bias": r.normal(size=6).astype(np.float32)}
    tx = optax.adam(2e-3)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    js = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    opt = tdense.Adam(2e-3)
    st = opt.init(tp)
    for _ in range(20):
        g = {k: r.normal(size=v.shape).astype(np.float32)
             for k, v in p.items()}
        u, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        opt.apply(tp, {k: torch.from_numpy(v) for k, v in g.items()}, st)
    assert int(st["count"]) == int(js[0].count) == 20
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6)
        np.testing.assert_allclose(st["mu"][k].numpy(),
                                   np.asarray(js[0].mu[k]), rtol=1e-6)
        np.testing.assert_allclose(st["nu"][k].numpy(),
                                   np.asarray(js[0].nu[k]), rtol=1e-6)
    # The JAX state crosses into the port's layout.
    back = convert.dense_opt_from_numpy(jax.tree.map(np.asarray, js))
    assert int(back["count"]) == 20 and set(back["mu"]) == set(p)


# -- WorkQueue ----------------------------------------------------------------

def test_work_queue_take_order_and_state_match():
    items = [f"shard-{i}" for i in range(7)]
    tq = WorkQueue(items, num_epochs=2, shuffle=True, seed=5)
    jq = JQueue(items, num_epochs=2, shuffle=True, seed=5)
    taken = []
    for i in range(9):
        taken.append(tq.take())
        assert taken[-1] == jq.take()
        assert tq.state() == jq.state()
    saved = tq.state()
    tq.add(["extra"])
    jq.add(["extra"])
    rest = list(tq)
    assert rest == list(jq) and tq.take() is None and jq.take() is None
    assert len(taken) + len(rest) == 2 * len(items) + 1
    tq2 = WorkQueue.from_state(saved, num_epochs=2, shuffle=True, seed=5)
    jq2 = JQueue.from_state(saved, num_epochs=2, shuffle=True, seed=5)
    assert list(tq2) == list(jq2)
    tq3 = WorkQueue(["x"])
    tq3.restore_state(saved)
    assert tq3.state() == saved


def test_work_queue_server_round_trip():
    q = WorkQueue([f"f{i}" for i in range(5)])
    server = WorkQueueServer(q, host="127.0.0.1")
    try:
        client = RemoteWorkQueue("127.0.0.1", server.port)
        assert list(client) == [f"f{i}" for i in range(5)]
        client.close()
    finally:
        server.shutdown()


# -- the port's Estimator on its own (tests/test_estimator.py) ------------------

class TinyModel(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.mlp = MLP(5, (16,), device="cpu")
        self.head = LogitsHead(16, device="cpu")

    def forward(self, embs, numeric):
        h = torch.cat([embs["item"], numeric], dim=1)
        return self.head(torch.relu(self.mlp(h)))


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(1).normal(size=50)
    while True:
        ids = rng.integers(0, 50, size=(16, 2)).astype(np.int64)
        y = (w[ids].sum(1) > 0).astype(np.float32)
        yield {"x": torch.from_numpy(rng.normal(size=16).astype(np.float32)),
               "item": tfc.SparseIds.from_numpy(ids, "cpu"),
               "label": torch.from_numpy(y)}


def _make(tmp_path, queue=None):
    group = tfc.EmbeddingGroup([tfc.NumericColumn("x"),
                                tfc.EmbeddingColumn("item", dim=4,
                                                    capacity=256)])
    model = TinyModel()
    init_dense(model, torch.Generator().manual_seed(0))
    afn = lambda p, e, b: torch.func.functional_call(  # noqa: E731
        model, p, (e, group.numeric_features(b)))
    lfn = lambda o, b: tlosses.bce_with_logits(o, b["label"])  # noqa: E731
    return Estimator(group, afn, lfn, tsopt.SparseAdagrad(0.2),
                     tdense.Adagrad(0.05), model.state_dict(),
                     model_dir=str(tmp_path / "model"), work_queue=queue,
                     device="cpu")


def test_train_hooks_and_checkpoint_cadence(tmp_path):
    est = _make(tmp_path)
    seen, lines = [], []

    class Recorder(Hook):
        def after_step(self, est, step, metrics):
            seen.append(step)

    hooks = [Recorder(),
             LoggingHook(every_steps=5, batch_size=16, log_fn=lines.append),
             CheckpointHook(est.manager, save_steps=10,
                            incremental_save_steps=5),
             ProfilerHook(3, 5, str(tmp_path / "trace"))]
    est.train(_batches(), max_steps=20, hooks=hooks)
    assert seen == list(range(1, 21))
    assert len(lines) == 4  # steps 5, 10, 15, 20
    names = sorted(os.listdir(tmp_path / "model"))
    assert "full-10" in names and "full-20" in names
    assert "incr-5" in names and "incr-15" in names
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_resume_and_evaluate(tmp_path):
    est = _make(tmp_path)
    est.train(_batches(), max_steps=15,
              hooks=[CheckpointHook(est.manager, save_steps=10,
                                    incremental_save_steps=3)])
    ev1 = est.evaluate(_batches(seed=9), steps=4)
    assert 0.5 < ev1["auc"] <= 1.0
    est2 = _make(tmp_path)
    assert est2.restore_if_available() == 15
    ev2 = est2.evaluate(_batches(seed=9), steps=4)
    np.testing.assert_allclose(ev1["auc"], ev2["auc"], rtol=1e-6)
    np.testing.assert_allclose(ev1["accuracy"], ev2["accuracy"], rtol=1e-6)
    est2.train(_batches(seed=3), max_steps=18)
    assert est2.ts.step == 18


def test_work_queue_rides_checkpoints(tmp_path):
    files = [f"shard-{i}.csv" for i in range(10)]
    q1 = WorkQueue(files)
    est = _make(tmp_path, q1)
    gen = _batches()

    def feeding():
        for _ in iter(q1.take, None):
            yield next(gen)

    est.train(feeding(), max_steps=4,
              hooks=[CheckpointHook(est.manager, save_steps=4)])
    remaining = q1.state()["pending"]
    assert len(remaining) == 10 - 4
    q2 = WorkQueue(files)
    est2 = _make(tmp_path, q2)
    assert est2.restore_if_available() == 4
    assert q2.state()["pending"] == remaining
    assert q2.take() == remaining[0]


# -- the slice: CBF + eviction WDL through both Estimators ---------------------

B, STEPS = 32, 8
HIDDEN = (16, 8)


def _wdl_columns(wdl, cfg):
    evo = cfg.EmbeddingVariableOption(
        filter_option=cfg.CBFFilter(filter_freq=2, num_counters=4096),
        evict_option=cfg.GlobalStepEvict(steps_to_live=3))
    return wdl.criteo_columns(embedding_dim=4, capacity=1 << 6,
                              ev_option=evo)


class _Losses(Hook):
    def __init__(self):
        self.losses = []

    def after_step(self, est, step, metrics):
        self.losses.append(float(metrics["loss"]))


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("slice")
    data = tcriteo.SyntheticCriteo(B, vocab=300, seed=0)
    raw = [data.next_batch_np(wide=True) for _ in range(STEPS)]
    held = tcriteo.SyntheticCriteo(B, vocab=300, seed=9)
    raw_eval = [held.next_batch_np(wide=True) for _ in range(3)]

    jg = jfc.EmbeddingGroup(_wdl_columns(jwdl, jcfg), coalesce=True)
    jmodel = jwdl.WDL(hidden=HIDDEN)
    jb = [jg.pack_batch_np(r) for r in raw]
    embs0 = {c.name: jnp.zeros((B, c.dim)) for c in jg.embedding}
    params = jmodel.init(jax.random.key(0), embs0,
                         jg.numeric_features(jb[0]))["params"]
    # Host copies first: the JAX step donates its input buffers.
    tparams = convert.wdl_params_from_numpy(jax.tree.map(np.asarray, params))
    jlh = _Losses()
    je = jest.Estimator(jg, jwdl.apply_fn(jmodel, jg),
                        lambda o, b: jlosses.bce_with_logits(o, b["label"]),
                        jsopt.SparseAdagrad(0.3), optax.adam(2e-3), params,
                        model_dir=str(d / "jax"))
    je.train(iter(jb), STEPS, hooks=[jlh, jest.CheckpointHook(
        je.manager, save_steps=6, incremental_save_steps=2)])
    jev_ = je.evaluate((jg.pack_batch_np(r) for r in raw_eval), steps=3)

    tg = tfc.EmbeddingGroup(_wdl_columns(twdl, tcfg), coalesce=True)
    tmodel = twdl.WDL(twdl.input_width(tg), hidden=HIDDEN, device="cpu")
    tlh = _Losses()
    te = Estimator(tg, twdl.apply_fn(tmodel, tg),
                   lambda o, b: tlosses.bce_with_logits(o, b["label"]),
                   tsopt.SparseAdagrad(0.3), tdense.Adam(2e-3), tparams,
                   model_dir=str(d / "port"), device="cpu")
    te.train((tg.pack_batch_np(r, "cpu") for r in raw), STEPS, hooks=[
        tlh, CheckpointHook(te.manager, save_steps=6,
                            incremental_save_steps=2)])
    tev_ = te.evaluate((tg.pack_batch_np(r, "cpu") for r in raw_eval),
                       steps=3)
    return dict(d=d, je=je, te=te, jl=jlh.losses, tl=tlh.losses, jev=jev_,
                tev=tev_)


def test_slice_losses_and_auc_match(slice_runs):
    r = slice_runs
    assert len(r["tl"]) == STEPS and all(np.isfinite(r["tl"]))
    np.testing.assert_allclose(r["tl"], r["jl"], rtol=1e-5)
    np.testing.assert_allclose(r["tev"]["auc"], r["jev"]["auc"], atol=1e-4)
    np.testing.assert_allclose(r["tev"]["accuracy"], r["jev"]["accuracy"],
                               atol=1e-4)
    assert sorted(os.listdir(r["d"] / "port")) == sorted(
        os.listdir(r["d"] / "jax"))


def test_slice_tables_match_key_by_key(slice_runs):
    r = slice_runs
    je, te = r["je"], r["te"]
    n_evicted = 0
    for tname, cfg in te.group.tables.items():
        jst = jax.tree.map(np.asarray, je.ts.ev[tname])
        tst = te.ts.ev[tname]
        # Same keys at the same slots: key rows, metadata and counters.
        np.testing.assert_array_equal(tst.table.key_rows.numpy(),
                                      jst.table.key_rows, err_msg=tname)
        np.testing.assert_array_equal(tst.freqs.numpy(), jst.freqs)
        np.testing.assert_array_equal(tst.versions.numpy(), jst.versions)
        np.testing.assert_array_equal(tst.bloom.numpy(), jst.bloom)
        np.testing.assert_allclose(tst.values.numpy(), jst.values, **TOL)
        np.testing.assert_allclose(
            te.ts.slots[tname]["accum"].numpy(),
            np.asarray(je.ts.slots[tname]["accum"]), **TOL)
        tomb = ((tst.table.key_hi == -(2**31)) & (tst.table.key_lo == 1))
        n_evicted += int(tomb.sum())
    assert n_evicted > 0  # the shrinks evicted real keys
    for k, v in te.ts.params.items():
        want = convert.wdl_params_from_numpy(
            jax.tree.map(np.asarray, je.ts.params))[k]
        np.testing.assert_allclose(v.numpy(), want.numpy(), **TOL)


def test_slice_incremental_checkpoints_carry_tombstones(slice_runs):
    d = slice_runs["d"]
    for side in ("jax", "port"):
        tombs = []
        for fn in os.listdir(d / side / "incr-8"):
            if fn.startswith("table-"):
                with np.load(d / side / "incr-8" / fn) as z:
                    tombs.append(z["tombstones"])
                    assert z["bloom"].shape == (4096,)
        assert sum(t.size for t in tombs) > 0, side


# -- tools/train_zoo_torch.py ---------------------------------------------------

def _tool(name):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    return __import__(name)


@pytest.mark.parametrize("argv, what", [
    (["wdl", "--adaptive_emb"], "adaptive"),
    (["deepfm", "--adaptive_emb"], "adaptive"),
])
def test_train_zoo_refuses_unported_before_any_table(argv, what,
                                                     monkeypatch):
    """``--adaptive_emb`` (refused until the port had adaptive tables)
    trains at tiny shapes: finite losses, every table adaptive, and
    some ids hot (their freq at the threshold) with rows of their own in
    the EV tables, whose static tables trained with the dense params."""
    train_zoo_torch = _tool("train_zoo_torch")
    monkeypatch.setitem(train_zoo_torch.COLUMN_KWARGS, argv[0],
                        dict(embedding_dim=4, capacity=1 << 8))
    monkeypatch.setitem(train_zoo_torch.MODULE_KWARGS, argv[0],
                        dict(hidden=(16, 8)))
    built = []
    build = train_zoo_torch.build

    def keep(*a, **k):
        built.append(build(*a, **k))
        return built[-1]

    monkeypatch.setattr(train_zoo_torch, "build", keep)
    out = train_zoo_torch.main(argv + [
        "--cpu", "--steps", "4", "--batch_size", "64", "--eval_steps", "2",
        "--adaptive_threshold", "2", "--adaptive_buckets", "64"])
    assert out["steps"] == 4 and np.isfinite(out["final_loss"])
    est = built[0][0]
    group = est.group
    assert set(group.adaptive_tables) == set(group.tables), what
    statics = {k for k in est.ts.params if k.startswith(group.ADAPTIVE_STATIC)}
    assert len(statics) == len(group.tables)
    hot = sum(int((st.freqs[:-1] >= 2).sum()) for st in est.ts.ev.values())
    assert hot > 0


def test_train_zoo_runs_micro_batches(monkeypatch, capsys):
    """``--micro_batch 2`` (refused until the port had micro-batches)
    trains, at small sizes."""
    train_zoo_torch = _tool("train_zoo_torch")
    monkeypatch.setitem(train_zoo_torch.COLUMN_KWARGS, "wdl",
                        dict(embedding_dim=4, capacity=1 << 8))
    monkeypatch.setitem(train_zoo_torch.MODULE_KWARGS, "wdl",
                        dict(hidden=(16, 8)))
    out = train_zoo_torch.main(["wdl", "--micro_batch", "2", "--cpu",
                                "--steps", "3", "--batch_size", "32",
                                "--eval_steps", "2"])
    assert out["steps"] == 3 and np.isfinite(out["final_loss"])
    assert 0.0 <= out["auc"] <= 1.0


def test_train_wdl_tool_prints_the_jax_tools_keys(capsys):
    """``tools/train_wdl_torch.py --cpu`` at a tiny size: the whole run
    is one epoch call, and its JSON line has ``tools/train_wdl.py``'s
    keys."""
    out = _tool("train_wdl_torch").main(
        ["3", "--cpu", "--pool", "2", "--cap", "10", "--vocab", "1000",
         "--hidden", "16,8", "--batch", "64"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert set(out) == {"metric", "auc", "mode", "backend", "steps",
                        "batch", "loss_first", "loss_last",
                        "loss_epoch_means", "train_s_incl_compile"}
    assert out["backend"] == "cpu" and out["mode"] == "bf16"
    assert out["steps"] == 4 and len(out["loss_epoch_means"]) == 2
    assert 0.0 < out["auc"] < 1.0 and np.isfinite(out["loss_last"])
