"""Port parity: static hash-bucket columns against the JAX package.

A static column (``categorical_column_with_hash_bucket`` +
``embedding_column``, the reference's default column type) is a fully
initialized ``[num_buckets, dim]`` matrix addressed by ``id mod
num_buckets``; static tables of one dim class coalesce into one matrix
by row offset. The same seeded inputs go through both packages.

Integer results (row maps, slots, ``inverse``, ``n_overflow``, the
transformed id halves) must be bit-exact, and so must a fetch from
equal matrices. Tolerances: a created matrix rtol 1e-6 (row draws whose
log/cos come from another math library); after training, losses rtol
1e-5 and table rows, accumulators and served scores rtol 1e-5, atol
1e-6 (float32 sums in another order). Towers run in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu.embedding import variable as jev
from deeprec_tpu.feature_column import feature_column as jfc
from deeprec_tpu.models import wdl as jwdl
from deeprec_tpu.optimizers import sparse as jsopt
from deeprec_tpu.train import loop as jloop
from deeprec_tpu.train import losses as jlosses
from deeprec_tpu.train.checkpoint import CheckpointManager as JCkpt
from deeprec_tpu.utils import keys as jkeys
from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import convert
from deeprec_tpu_torch.data import criteo as tcriteo
from deeprec_tpu_torch.embedding import variable as tev
from deeprec_tpu_torch.feature_column import feature_column as tfc
from deeprec_tpu_torch.models import wdl as twdl
from deeprec_tpu_torch.optimizers import dense as tdense
from deeprec_tpu_torch.optimizers import sparse as tsopt
from deeprec_tpu_torch.serving.processor import ServingModel
from deeprec_tpu_torch.train import loop as tloop
from deeprec_tpu_torch.train import losses as tlosses
from deeprec_tpu_torch.train.checkpoint import CheckpointManager as TCkpt
from deeprec_tpu_torch.utils import keys as tkeys

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
B = 64
HIDDEN = (16, 8)


def _columns(fc, dims=(8, 8, 16)):
    return [fc.NumericColumn("I1")] + [
        fc.EmbeddingColumn(name=f"C{i + 1}", dim=d, num_buckets=100 + 50 * i,
                           static_bucket=True)
        for i, d in enumerate(dims)]


def _ids(rng, n):
    """Raw int64 ids: small and huge (as uint64, >= 2**63), and -1."""
    ids = np.concatenate([
        rng.integers(0, 400, size=n // 2),
        rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                     size=n - n // 2, dtype=np.int64)]).astype(np.int64)
    ids[:4] = [-1, np.iinfo(np.int64).min + 7, 2**63 - 1, 123456789012345]
    return ids


@pytest.mark.parametrize("coalesce", [True, False])
def test_offset_coalescing_matches_jax(coalesce):
    jg = jfc.EmbeddingGroup(_columns(jfc, (8, 8, 16, 8)), coalesce=coalesce)
    tg = tfc.EmbeddingGroup(_columns(tfc, (8, 8, 16, 8)), coalesce=coalesce)
    assert tg._static_map == jg._static_map
    assert tg.salts == jg.salts
    assert {c.name: tg.physical_table_of(c) for c in tg.embedding} == {
        c.name: jg.physical_table_of(c) for c in jg.embedding}
    for name, jc in jg.tables.items():
        tc = tg.tables[name]
        assert (tc.static_buckets, tc.capacity, tc.dim, tc.init_scale) == (
            jc.static_buckets, jc.capacity, jc.dim, jc.init_scale)
    if coalesce:
        assert "static:C1,C2,C4" in tg.tables


def test_reference_static_columns_give_the_two_matrices():
    kw = dict(embedding_dim=16, capacity=1 << 20, reference_shapes=True,
              wide_in_deep=True, static_buckets=True)
    tg = tfc.EmbeddingGroup(twdl.criteo_columns(**kw), coalesce=True)
    jg = jfc.EmbeddingGroup(jwdl.criteo_columns(**kw), coalesce=True)
    shapes = sorted((c.capacity + 1, c.dim) for c in tg.tables.values())
    assert shapes == [(94491, 65), (1700001, 129)]
    assert tg._static_map == jg._static_map
    assert list(tg.tables) == list(jg.tables)


def test_static_config_validation():
    tcfg.TableConfig("t", dim=4, capacity=300, static_buckets=True)
    with pytest.raises(ValueError):
        tcfg.TableConfig("t", dim=4, capacity=0, static_buckets=True)
    with pytest.raises(ValueError):
        tcfg.TableConfig("t", dim=4, capacity=300, static_buckets=True,
                         block_num=2, dyn_dim_thresholds=(1,))
    with pytest.raises(ValueError):
        tcfg.TableConfig("t", dim=4, capacity=300)
    with pytest.raises(ValueError):
        tfc.EmbeddingColumn("x", dim=4, static_bucket=True).table_config()


@pytest.mark.parametrize("buckets", [1, 7, 100, 65536, 65537, 300000,
                                     2**31 - 3, 2**31 - 1])
def test_static_transforms_match_jax(buckets):
    col_args = dict(name="C1", dim=4, num_buckets=buckets,
                    static_bucket=True)
    extra = [dict(name="C2", dim=4, num_buckets=50, static_bucket=True)]
    jg = jfc.EmbeddingGroup([jfc.EmbeddingColumn(**a)
                             for a in extra + [col_args]], coalesce=True)
    tg = tfc.EmbeddingGroup([tfc.EmbeddingColumn(**a)
                             for a in extra + [col_args]], coalesce=True)
    rng = np.random.default_rng(buckets % 1000)
    ids = _ids(rng, 256).reshape(64, 4)
    ids[1, 1] = jkeys.EMPTY_ID
    hi, lo = tkeys.split_ids(ids.reshape(-1))
    for tc, jc in zip(tg.embedding, jg.embedding):
        want = jg.transform_ids_np(jc, ids)
        got = tg.transform_ids_np(tc, ids)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        dev = tg.transform_ids(tc, torch.from_numpy(hi), torch.from_numpy(lo))
        jdev = jg.transform_ids(jc, jnp.asarray(hi), jnp.asarray(lo))
        for a, b, h in zip(dev, jdev, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            np.testing.assert_array_equal(a.numpy(), h.reshape(-1))
    # mod_of on the device equals the host's exact uint64 remainder.
    got = tkeys.mod_of(torch.from_numpy(hi), torch.from_numpy(lo), buckets)
    np.testing.assert_array_equal(
        got.numpy().astype(np.int64),
        (ids.reshape(-1).view(np.uint64) % np.uint64(buckets)).astype(
            np.int64))


def test_created_static_matrix_matches_jax():
    jg = jfc.EmbeddingGroup(_columns(jfc), coalesce=True)
    tg = tfc.EmbeddingGroup(_columns(tfc), coalesce=True)
    for name, cfg in tg.tables.items():
        js = jev.create(jg.tables[name], salt=jg.salts[name])
        ts = tev.create(cfg, "cpu", salt=tg.salts[name])
        assert ts.values.shape == (cfg.capacity + 1, cfg.dim)
        np.testing.assert_allclose(ts.values.numpy(), np.asarray(js.values),
                                   rtol=1e-6, atol=0)
        assert not ts.values[-1].any()
        for f in ("freqs", "versions", "bloom"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)))


def _equal_static_state(jg, tg, name):
    """A JAX static state and a port state holding the same matrix."""
    js = jev.create(jg.tables[name], salt=jg.salts[name])
    ts = tev.create(tg.tables[name], "cpu", salt=tg.salts[name])
    ts.values.copy_(torch.from_numpy(np.array(js.values)))
    return js, ts


@pytest.mark.parametrize("budget", [None, 40])
def test_lookup_train_static_matches_jax(budget):
    jg = jfc.EmbeddingGroup(_columns(jfc), coalesce=True)
    tg = tfc.EmbeddingGroup(_columns(tfc), coalesce=True)
    name = "static:C1,C2"
    js, ts = _equal_static_state(jg, tg, name)
    rng = np.random.default_rng(5)
    his, los = [], []
    for c in tg.embedding[:2]:
        ids = _ids(rng, 64)
        ids[::9] = jkeys.EMPTY_ID
        h, l = tg.transform_ids_np(c, ids)
        his.append(h)
        los.append(l)
    qhi, qlo = np.concatenate(his), np.concatenate(los)
    _, jo = jev.lookup_train_static(jg.tables[name], js, jnp.asarray(qhi),
                                    jnp.asarray(qlo), 3, budget=budget)
    before = ts.values.clone()
    _, to = tev.lookup_train_static(tg.tables[name], ts,
                                    torch.from_numpy(qhi),
                                    torch.from_numpy(qlo), 3, budget=budget)
    assert torch.equal(ts.values, before)
    for f in ("slots", "admitted", "is_new", "prev_versions", "qhi", "qlo",
              "rows"):
        np.testing.assert_array_equal(getattr(to.lk, f).numpy(),
                                      np.asarray(getattr(jo.lk, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(to.inverse.numpy(), np.asarray(jo.inverse))
    assert int(to.n_overflow) == int(jo.n_overflow)
    if budget is not None:
        assert int(to.n_overflow) > 0
    # Serving lookup (through ``lookup``'s static branch).
    np.testing.assert_array_equal(
        tev.lookup(tg.tables[name], ts, torch.from_numpy(qhi),
                   torch.from_numpy(qlo)).numpy(),
        np.asarray(jev.lookup(jg.tables[name], js, jnp.asarray(qhi),
                              jnp.asarray(qlo))))


# -- training, checkpoints, serving -----------------------------------------

CONFIGS = {
    # Deep dim 8 and wide dim 1 static columns of 256 buckets: two
    # matrices, exact budget (26 * min(256, 64) = n).
    "wide": dict(kw=dict(embedding_dim=8, capacity=256,
                         static_buckets=True), wide=True),
    # Wide weight in channel 0 of dim-9 columns of 40 buckets: one
    # matrix under the unique budget (1,088 of n = 1,664).
    "budget": dict(kw=dict(embedding_dim=8, capacity=40, wide_in_deep=True,
                           static_buckets=True), wide=False),
}


class _Sides:
    """One static WDL in both packages from the same tower weights."""

    def __init__(self, config):
        spec = CONFIGS[config]
        self.wide = spec["wide"]
        self.data = tcriteo.SyntheticCriteo(B, vocab=10**6, seed=0)
        self.raw = [self.data.next_batch_np(wide=self.wide)
                    for _ in range(4)]
        self.jg = jfc.EmbeddingGroup(jwdl.criteo_columns(**spec["kw"]),
                                     coalesce=True)
        self.tg = tfc.EmbeddingGroup(twdl.criteo_columns(**spec["kw"]),
                                     coalesce=True)
        jmodel = jwdl.WDL(hidden=HIDDEN)
        b0 = self.jg.pack_batch_np(self.raw[0])
        embs0 = {c.name: jnp.zeros((B, c.dim)) for c in self.jg.embedding}
        self.params = jmodel.init(jax.random.key(0), embs0,
                                  self.jg.numeric_features(b0))["params"]
        self.jopt, self.tx = jsopt.SparseAdagrad(0.2), optax.adagrad(0.05)
        self.jafn = jwdl.apply_fn(jmodel, self.jg)
        self.jstep = jloop.make_train_step(
            self.jg, self.jafn,
            lambda o, b: jlosses.bce_with_logits(o, b["label"]), self.jopt,
            self.tx, donate=False)
        tmodel = twdl.WDL(twdl.input_width(self.tg), hidden=HIDDEN,
                          device="cpu")
        self.topt, self.dopt = tsopt.SparseAdagrad(0.2), tdense.Adagrad(0.05)
        self.tafn = twdl.apply_fn(tmodel, self.tg)
        self.tstep = tloop.make_train_step(
            self.tg, self.tafn,
            lambda o, b: tlosses.bce_with_logits(o, b["label"]), self.topt,
            self.dopt)

    def jax_template(self):
        return jloop.create_train_state(self.jg, self.params, self.tx,
                                        self.jopt)

    def port_template(self):
        return tloop.create_train_state(
            self.tg, convert.wdl_params_from_numpy(
                jax.tree.map(np.asarray, self.params)),
            self.dopt, self.topt, device="cpu")

    def jax_step(self, ts, i):
        ts, m = self.jstep(ts, self.jg.pack_batch_np(self.raw[i]))
        return ts, float(m["loss"]), int(m["n_overflow"])

    def port_step(self, ts, i):
        ts, m = self.tstep(ts, self.tg.pack_batch_np(self.raw[i], "cpu"))
        return ts, float(m["loss"]), int(m["n_overflow"])


def _assert_states_close(jts, tts, tol=TOL):
    for name in tts.ev:
        np.testing.assert_allclose(tts.ev[name].values.numpy(),
                                   np.asarray(jts.ev[name].values),
                                   err_msg=name, **tol)
        np.testing.assert_allclose(tts.slots[name]["accum"].numpy(),
                                   np.asarray(jts.slots[name]["accum"]),
                                   err_msg=name, **tol)


@pytest.fixture(scope="module", params=list(CONFIGS))
def sides(request):
    return request.param, _Sides(request.param)


def test_three_static_training_steps_match_jax(sides):
    config, s = sides
    jts, tts = s.jax_template(), s.port_template()
    for name, st in tts.ev.items():
        # Both packages start from the same matrix, up to row draws.
        np.testing.assert_allclose(st.values.numpy(),
                                   np.asarray(jts.ev[name].values),
                                   rtol=1e-6, atol=0)
    for i in range(3):
        jts, jloss, jover = s.jax_step(jts, i)
        tts, tloss, tover = s.port_step(tts, i)
        np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
        assert tover == jover == 0
    _assert_states_close(jts, tts)
    budgets = [s.tg._unique_budget(tcols, s.tg._pack_widths[t], (B, 26))
               for t, tcols in s.tg._columns_by_table().items()]
    assert (budgets == [1088]) == (config == "budget")


def test_port_checkpoints_restore_in_jax(sides, tmp_path):
    _, s = sides
    tts = s.port_template()
    for i in range(2):
        tts, _, _ = s.port_step(tts, i)
    mgr = TCkpt(str(tmp_path), s.tg)
    mgr.save(tts)
    tts, _, _ = s.port_step(tts, 2)
    mgr.save(tts, incremental=True, since_step=2)
    jts = JCkpt(str(tmp_path), s.jg).restore(s.jax_template())
    assert int(jts.step) == 3
    # Saved in full by the incremental save too: equal to the bit.
    _assert_states_close(jts, tts, dict(rtol=0, atol=0))
    jts, jloss, _ = s.jax_step(jts, 3)
    tts, tloss, _ = s.port_step(tts, 3)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)


def test_jax_checkpoints_restore_in_port(sides, tmp_path):
    _, s = sides
    jts = s.jax_template()
    for i in range(2):
        jts, _, _ = s.jax_step(jts, i)
    mgr = JCkpt(str(tmp_path), s.jg)
    mgr.save(jts)
    jts, _, _ = s.jax_step(jts, 2)
    mgr.save(jts, incremental=True, since_step=2)
    tts = TCkpt(str(tmp_path), s.tg).restore(s.port_template())
    assert tts.step == 3
    _assert_states_close(jts, tts, dict(rtol=0, atol=0))
    jts, jloss, _ = s.jax_step(jts, 3)
    tts, tloss, _ = s.port_step(tts, 3)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)


def test_served_static_model_matches_jax_eval(sides, tmp_path):
    _, s = sides
    jts = s.jax_template()
    for i in range(3):
        jts, _, _ = s.jax_step(jts, i)
    JCkpt(str(tmp_path), s.jg).save(jts)
    template = tloop.create_train_state(
        s.tg, {k: v.clone() for k, v in s.port_template().params.items()},
        device="cpu")
    serving = ServingModel(s.tg, s.tafn, template, str(tmp_path))
    assert serving.full_update() == 3
    raw = s.data.next_batch_np(wide=s.wide)
    want = np.asarray(jloop.make_eval_step(s.jg, s.jafn)(
        jts, s.jg.pack_batch_np(raw)))
    got = serving.predict(s.tg.pack_batch_np(raw, "cpu"))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
