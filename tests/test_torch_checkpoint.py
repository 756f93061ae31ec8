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


# -- eviction: tombstones and CBF counters through checkpoints --------------
#
# The cases of tests/test_checkpoint.py:180-240 in the port (no
# resurrection of evicted keys on full + delta restore, a key inserted
# again after its eviction survives, CBF counters ride the deltas), then
# checkpoints holding ``tombstones`` and ``bloom`` across the packages in
# both directions, and the serving delta dropping an evicted key. Two
# sparse columns with CBF admission (counters 512 x 2) and eviction after
# 5 steps; dense Adam. Restored states are compared bit for bit: both
# packages insert a checkpoint's keys in its order, at the same slots.


def _ev_columns(fc, cfg, cbf=True):
    evo = cfg.EmbeddingVariableOption(
        filter_option=(cfg.CBFFilter(filter_freq=2, num_counters=512,
                                     num_hash_func=2) if cbf else None),
        evict_option=cfg.GlobalStepEvict(steps_to_live=5))
    return [fc.NumericColumn("x1"), fc.NumericColumn("x2"),
            fc.EmbeddingColumn("C1", dim=4, capacity=256, ev_option=evo),
            fc.EmbeddingColumn("C2", dim=4, capacity=256, ev_option=evo)]


def _ev_raw(i, lo=0, hi=60):
    r = np.random.default_rng(500 + i)
    batch = {"x1": r.normal(size=B).astype(np.float32),
             "x2": r.normal(size=B).astype(np.float32),
             "label": (r.random(B) < 0.5).astype(np.float32)}
    for c in ("C1", "C2"):
        batch[c] = r.integers(lo, hi, size=(B, 2)).astype(np.int64)
    return batch


class _EvJax:
    def __init__(self, cbf=True):
        from deeprec_tpu import config as jcfg
        self.group = jfc.EmbeddingGroup(_ev_columns(jfc, jcfg, cbf),
                                        coalesce=True)
        model = jwdl.WDL(hidden=HIDDEN)
        b0 = self.group.pack_batch_np(_ev_raw(0))
        embs0 = {c.name: jnp.zeros((B, c.dim)) for c in self.group.embedding}
        self.params = model.init(jax.random.key(0), embs0,
                                 self.group.numeric_features(b0))["params"]
        self.opt, self.tx = jsopt.SparseAdagrad(0.2), optax.adam(0.01)
        self.step_fn = jloop.make_train_step(
            self.group, jwdl.apply_fn(model, self.group),
            lambda o, b: jlosses.bce_with_logits(o, b["label"]), self.opt,
            self.tx, donate=False)

    def template(self):
        return jloop.create_train_state(self.group, self.params, self.tx,
                                        self.opt)

    def step(self, ts, raw):
        return self.step_fn(ts, self.group.pack_batch_np(raw))[0]

    def mgr(self, path):
        return JCkpt(str(path), self.group)


class _EvPort:
    def __init__(self, params, cbf=True):
        from deeprec_tpu_torch import config as tcfg
        self.group = tfc.EmbeddingGroup(_ev_columns(tfc, tcfg, cbf),
                                        coalesce=True)
        self.model = twdl.WDL(twdl.input_width(self.group), hidden=HIDDEN,
                              device="cpu")
        self.params = convert.wdl_params_from_numpy(
            jax.tree.map(np.asarray, params))
        self.opt, self.dopt = tsopt.SparseAdagrad(0.2), tdense.Adam(0.01)
        self.step_fn = tloop.make_train_step(
            self.group, twdl.apply_fn(self.model, self.group),
            lambda o, b: tlosses.bce_with_logits(o, b["label"]), self.opt,
            self.dopt)

    def template(self, serving=False):
        params = {k: v.clone() for k, v in self.params.items()}
        if serving:
            return tloop.create_train_state(self.group, params, device="cpu")
        return tloop.create_train_state(self.group, params, self.dopt,
                                        self.opt, device="cpu")

    def step(self, ts, raw):
        return self.step_fn(ts, self.group.pack_batch_np(raw, "cpu"))[0]

    def mgr(self, path):
        return TCkpt(str(path), self.group)


@pytest.fixture(scope="module")
def ev_sides():
    jx = _EvJax()
    return jx, _EvPort(jx.params)


def _evict_run(side, path, reinsert=False):
    """Steps 0-3 on ids [0, 60), a full save; steps 4-14 on [100, 160),
    the journaled shrink (every id of [0, 60) evicted), optionally one
    step on [0, 60) again, then a delta since step 4. Returns the state
    and its manager."""
    mgr = side.mgr(path)
    ts = side.template()
    for i in range(4):
        ts = side.step(ts, _ev_raw(i))
    mgr.save(ts)
    for i in range(4, 15):
        ts = side.step(ts, _ev_raw(i, 100, 160))
    ts = mgr.shrink_tables(ts)
    if reinsert:
        ts = side.step(ts, _ev_raw(77))
    mgr.save(ts, incremental=True, since_step=4)
    return ts, mgr


def _keys_of(st):
    from deeprec_tpu_torch.embedding import hash_table as tht
    from deeprec_tpu_torch.utils import keys as tkeys
    pair = st.table.key_pair[tht.live_mask(st.table)].numpy()
    return set(tkeys.join_ids(pair[:, 0], pair[:, 1]).tolist())


@pytest.mark.parametrize("reinsert", [False, True])
def test_evicted_keys_do_not_come_back_on_delta_restore(ev_sides, tmp_path,
                                                        reinsert):
    _, port = ev_sides
    ts, _ = _evict_run(port, tmp_path, reinsert)
    live = {t: _keys_of(st) for t, st in ts.ev.items()}
    first = set()   # the (salted) keys of steps 0-3
    for i in range(4):
        for c in port.group.embedding:
            hi, lo = port.group.transform_ids_np(c, _ev_raw(i)[c.name])
            first |= set(_join(hi, lo))
    old_live = first & set().union(*live.values())
    # Without the re-insert every key of steps 0-3 is gone; with it, the
    # keys it brought back are live and stay so.
    assert bool(old_live) == reinsert
    with np.load(_table_file(tmp_path, reinsert)) as z:
        tombs = set(z["tombstones"].tolist())
    assert tombs and not tombs & old_live
    restored = port.mgr(tmp_path).restore(port.template())
    assert {t: _keys_of(st) for t, st in restored.ev.items()} == live
    for t, st in restored.ev.items():
        np.testing.assert_array_equal(st.bloom.numpy(),
                                      ts.ev[t].bloom.numpy())


def _join(hi, lo):
    from deeprec_tpu_torch.utils import keys as tkeys
    return tkeys.join_ids(hi.ravel(), lo.ravel()).tolist()


def _table_file(path, reinsert):
    d = path / ("incr-16" if reinsert else "incr-15")
    return d / next(fn for fn in sorted(os.listdir(d))
                    if fn.startswith("table-coalesced"))


def _assert_same_restored(tts, jts):
    for tname, st in tts.ev.items():
        jst = jax.tree.map(np.asarray, jts.ev[tname])
        np.testing.assert_array_equal(st.table.key_rows.numpy(),
                                      jst.table.key_rows, err_msg=tname)
        for f in ("values", "freqs", "versions", "bloom"):
            np.testing.assert_array_equal(getattr(st, f).numpy(),
                                          getattr(jst, f), err_msg=f)
        np.testing.assert_array_equal(
            tts.slots[tname]["accum"].numpy(),
            np.asarray(jts.slots[tname]["accum"]))
    assert int(tts.dense_opt["count"]) == int(jts.dense_opt[0].count)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tombstones_and_bloom_cross_packages(ev_sides, tmp_path, writer):
    jx, port = ev_sides
    ts, _ = _evict_run(jx if writer == "jax" else port, tmp_path,
                       reinsert=True)
    with np.load(_table_file(tmp_path, True)) as z:
        assert z["tombstones"].size > 0 and z["bloom"].shape == (512,)
    tts = port.mgr(tmp_path).restore(port.template())
    jts = jx.mgr(tmp_path).restore(jx.template())
    assert tts.step == int(jts.step) == 16
    _assert_same_restored(tts, jts)
    live = (ts.ev if writer == "port" else
            {t: jax.tree.map(np.asarray, s) for t, s in ts.ev.items()})
    for tname, st in tts.ev.items():
        want = live[tname]
        np.testing.assert_array_equal(st.bloom.numpy(), np.asarray(
            want.bloom))


def test_serving_delta_drops_evicted_key(ev_sides, tmp_path):
    from deeprec_tpu_torch.serving.processor import ServingModel
    _, port = ev_sides
    ts, _ = _evict_run(port, tmp_path)
    serving = ServingModel(port.group, twdl.apply_fn(port.model, port.group),
                           port.template(serving=True), str(tmp_path))
    assert serving.full_update(step=4) == 4
    group = port.group
    tfile = _table_file(tmp_path, False)
    tname = tfile.name[len("table-"):-len("-s0.npz")]
    with np.load(tfile) as z, np.load(tmp_path / "full-4" / tfile.name) as f:
        # A key of the full save evicted before the delta.
        key = np.intersect1d(z["tombstones"], f["keys"])[:1]
    assert key.size == 1
    from deeprec_tpu_torch.utils import keys as tkeys
    hi, lo = tkeys.split_ids(key)

    def served_row():
        from deeprec_tpu_torch.embedding import variable as tev
        st = serving._ts.ev[tname]
        return tev.lookup(group.tables[tname], st, torch.from_numpy(hi),
                          torch.from_numpy(lo))[0]

    before = served_row()
    assert bool((before != 0).any())   # live at step 4: its trained row
    assert serving.delta_update() == 15
    assert torch.equal(served_row(), torch.zeros(4))  # evicted: default
    out = serving.predict(group.pack_batch_np(_ev_raw(0), "cpu"))
    assert out.shape == (B,) and bool(torch.isfinite(out).all())
