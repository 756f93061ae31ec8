"""Port parity: adaptive embedding against the JAX package.

The module (``embedding/adaptive.py``): lookups whose ``hot``,
``newly_hot`` and ``bucket`` equal the JAX ones bit for bit, the
migration of newly hot rows, the combine and the inference read. The
group (``adaptive_hot_threshold`` columns): ids below the threshold
train their static bucket rows, a dense param
``adaptive_static.<table>`` carried across by ``convert.py`` from the
JAX ``params["adaptive_static"]``; an id crossing it gets its EV row
seeded from its static row inside ``lk.rows``, which K2/K3 update
(``base_rows``), so the EV row continues from the trained value. Held
over five steps (``tests/torch_variant_parity.py``), also at threshold
1 (an id is hot, newly hot and fresh in the EV at its first sighting)
and with CBF admission: routing bits bit for bit, losses per step
within rtol 1e-5, key rows, freqs and versions bit for bit, rows,
slots and dense params (the static tables included) within rtol 1e-5,
atol 1e-6; eval logits alike, and equal to the train step's forward.
K2's and K3's plain versions on a migrated lookup (seeds in fresh rows)
equal the JAX applies on the same lookup.
A checkpoint restores the static tables with the EV tables, and
``ServingModel`` serves the restored state as ``make_eval_step`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_variant_parity as vp
from deeprec_tpu import config as jcfg
from deeprec_tpu.embedding import adaptive as jad
from deeprec_tpu.embedding import variable as jev
from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch.embedding import adaptive as tad
from deeprec_tpu_torch.embedding import variable as tev
from deeprec_tpu_torch.feature_column.feature_column import (
    EmbeddingColumn, EmbeddingGroup)
from deeprec_tpu_torch.train import loop as tloop
from deeprec_tpu_torch.utils import keys as keylib

torch.set_num_threads(1)

TOL = vp.TOL


def test_module_matches_jax():
    """Five lookups of a zero-initialized table (threshold 2, 8
    buckets): bits, migration into the table, combine and inference
    reads against the JAX module."""
    kw = dict(name="t", dim=4, capacity=64, initializer="zeros")
    jc, tc = jcfg.TableConfig(**kw), tcfg.TableConfig(**kw)
    jst, tst = jev.create(jc), tev.create(tc, "cpu")
    rng = np.random.default_rng(0)
    static = rng.normal(size=(8, 4)).astype(np.float32)
    ad = dict(hot_threshold=2, num_buckets=8, salt=3)
    jlook = jax.jit(lambda st, h, l, s: jad.lookup_train(jc, st, h, l, s,
                                                         **ad))
    for step in range(5):
        ids = np.where(rng.random((6, 2)) < 0.2, keylib.EMPTY_ID,
                       rng.integers(0, 12, (6, 2))).astype(np.int64)
        hi, lo = keylib.split_ids(ids)
        jst, jal = jlook(jst, jnp.asarray(hi), jnp.asarray(lo), step)
        tst, tal = tad.lookup_train(tc, tst, torch.from_numpy(hi),
                                    torch.from_numpy(lo), step, **ad)
        for f in ("hot", "newly_hot", "bucket", "inverse", "mask"):
            np.testing.assert_array_equal(getattr(tal, f).numpy(),
                                          np.asarray(getattr(jal, f)), f)
        np.testing.assert_array_equal(tal.lk.slots.numpy(),
                                      np.asarray(jal.lk.slots))
        jst = jad.migrate_new_hot(jc, jst, jal, jnp.asarray(static))
        tst = tad.migrate_new_hot(tc, tst, tal, torch.from_numpy(static))
        np.testing.assert_array_equal(tst.values.numpy(),
                                      np.asarray(jst.values))
        for comb in ("sum", "mean"):
            np.testing.assert_allclose(
                tad.combine(tal.lk.rows, torch.from_numpy(static), tal,
                            comb).numpy(),
                np.asarray(jad.combine(jal.lk.rows, jnp.asarray(static),
                                       jal, comb)), **TOL)
        want = np.asarray(jad.lookup_infer(jc, jst, jnp.asarray(hi),
                                           jnp.asarray(lo),
                                           jnp.asarray(static), **ad))
        got = tad.lookup_infer(tc, tst, torch.from_numpy(hi),
                               torch.from_numpy(lo),
                               torch.from_numpy(static), **ad)
        np.testing.assert_array_equal(got.numpy(), want)
    assert int(tal.hot.sum()) > 0


def _cols(threshold=2, buckets=16, evo=None, coalesce_peer=True):
    def cols(pkg):
        kw = {} if evo is None else dict(ev_option=evo(pkg))
        out = [pkg.fc.EmbeddingColumn(
            name="a", dim=4, capacity=1 << 7, combiner="mean",
            adaptive_hot_threshold=threshold, adaptive_buckets=buckets,
            **kw)]
        if coalesce_peer:
            out.append(pkg.fc.EmbeddingColumn(name="b", dim=3,
                                              capacity=1 << 7))
        return out
    return cols


def _cbf(pkg):
    return pkg.cfg.EmbeddingVariableOption(
        filter_option=pkg.cfg.CBFFilter(filter_freq=3, num_counters=512))


@pytest.mark.parametrize("case", [
    ("adagrad", 2, None), ("adam", 2, None), ("adagrad", 1, None),
    ("adagrad", 1, _cbf)], ids=["adagrad", "adam", "threshold1", "cbf"])
def test_group_trains_as_jax(case):
    sparse, threshold, evo = case
    rng = np.random.default_rng(4)
    raw = vp.batches(rng, 6, 16, {"a": 2, "b": 1}, vocab=24)
    out = vp.run_pair(_cols(threshold, evo=evo), raw[:5], sparse,
                      eval_raw=raw[5])
    vp.assert_run_matches(out)
    newly = sum(int(b["a"][1].sum()) for b in out.tbits)
    assert newly > 0, "no id went hot"
    # Migration continued the EV rows from the static table: a hot id's
    # row is not its fresh draw (a zero or truncated-normal row).
    if evo is not None:
        keys = tev.export_arrays(out.tg.tables["a"], out.tts.ev["a"])["keys"]
        assert 0 < keys.size < 24  # CBF kept the cold ids out


@pytest.mark.parametrize("sparse", ["adagrad", "adam"])
def test_applies_after_migration_match_jax(sparse):
    """K2's and K3's plain versions on a lookup whose newly hot rows took
    their seeds (``migrate_adaptive``; threshold 1, so every id is hot,
    newly hot and fresh in the EV at once) against the JAX package's
    ``SparseAdagrad``/``SparseAdam`` apply on the same lookup."""
    from deeprec_tpu.embedding.variable import LookupResult as JLookup
    from deeprec_tpu_torch.optimizers import sparse as tsopt
    rng = np.random.default_rng(8)
    raw = vp.batches(rng, 1, 16, {"a": 2, "b": 1}, vocab=24)
    tg = EmbeddingGroup(_cols(threshold=1)(vp.PORT))
    params = tg.adaptive_static_params("cpu")
    st = tg.create_state("cpu")
    st, gl = tg.lookup_train(st, vp.port_batch(raw[0]), 0)
    _, gl = tg.migrate_adaptive(st, gl, params)
    lk = gl.lks["a"]
    adp = gl.columns["a"].adp
    assert bool((adp.newly_hot & lk.is_new).any())
    seed = params["adaptive_static.a"][adp.bucket.long()]
    torch.testing.assert_close(lk.rows[adp.newly_hot], seed[adp.newly_hot],
                               rtol=0, atol=0)
    cfg = tg.tables["a"]
    jc = jcfg.TableConfig(**{f: getattr(cfg, f) for f in (
        "name", "dim", "capacity", "initializer", "init_scale",
        "adaptive_hot_threshold", "adaptive_buckets")})
    jopt, topt = vp.SPARSE[sparse]()
    g = rng.normal(size=tuple(lk.rows.shape)).astype(np.float32)
    values = st["a"].values.clone()
    tslots = topt.init(cfg, "cpu")
    topt.apply(cfg, tslots, values, lk, torch.from_numpy(g), 0)
    jlk = JLookup(**{k: jnp.asarray(v.numpy())
                     for k, v in lk._asdict().items()})
    jslots, jvalues = jopt.apply(jc, jopt.init(jc),
                                 jnp.asarray(st["a"].values.numpy()), jlk,
                                 jnp.asarray(g), 0)
    np.testing.assert_allclose(values.numpy(), np.asarray(jvalues), **TOL)
    for k, v in jslots.items():
        np.testing.assert_allclose(tslots[k].numpy(), np.asarray(v), **TOL)


def test_eval_matches_train_forward():
    """The eval step's logits equal the train step's forward (lookup,
    migration, combine) on the same state."""
    rng = np.random.default_rng(5)
    raw = vp.batches(rng, 4, 16, {"a": 2, "b": 1}, vocab=24)
    out = vp.run_pair(_cols(), raw[:3], "adagrad")
    tg, ts = out.tg, out.tts
    b = vp.port_batch(raw[3])
    got = tloop.make_eval_step(tg, vp.port_apply)(ts, b)
    st = tloop.clone_state(ts.ev)
    st, gl = tg.lookup_train(st, b, 10)
    st, gl = tg.migrate_adaptive(st, gl, ts.params)
    embs = tg.combine(gl, {t: lk.rows for t, lk in gl.lks.items()},
                      ts.params)
    want = vp.port_apply(ts.params, embs, b)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_group_rules():
    with pytest.raises(ValueError, match="dynamic-dimension"):
        EmbeddingGroup([EmbeddingColumn(
            name="c0", dim=4, capacity=1 << 8, adaptive_hot_threshold=2,
            adaptive_buckets=8, dyn_dim_blocks=2, dyn_dim_thresholds=(3,))])
    cols = [EmbeddingColumn(name="a", dim=4, capacity=1 << 8,
                            adaptive_hot_threshold=2, adaptive_buckets=8),
            EmbeddingColumn(name="b", dim=4, capacity=1 << 8),
            EmbeddingColumn(name="c", dim=4, capacity=1 << 8)]
    g = EmbeddingGroup(cols, coalesce=True)
    assert g.physical_table_of(cols[0]) == "a"
    assert g.physical_table_of(cols[1]) == g.physical_table_of(cols[2])
    with pytest.raises(ValueError, match="adaptive_buckets"):
        tcfg.TableConfig(name="x", dim=4, capacity=8,
                         adaptive_hot_threshold=2)
    with pytest.raises(ValueError, match="static bucket table"):
        g._adaptive_static({}, "a")
    # Placement on a mesh: the EV half is always row-sharded.
    mg = EmbeddingGroup(cols, axis_name="data", num_shards=2,
                        placement="auto", replicate_threshold=1 << 30)
    assert mg.placement["a"] == "sharded"
    assert mg.placement[mg.physical_table_of(cols[1])] == "replicated"


def test_checkpoint_and_serving(tmp_path):
    from deeprec_tpu_torch.serving.processor import ServingModel
    from deeprec_tpu_torch.train import checkpoint as tckpt
    rng = np.random.default_rng(6)
    raw = vp.batches(rng, 4, 16, {"a": 2, "b": 1}, vocab=24)
    out = vp.run_pair(_cols(), raw[:3], "adagrad")
    tg, ts = out.tg, out.tts
    tckpt.CheckpointManager(str(tmp_path), tg).save(ts)
    template = tloop.create_train_state(
        tg, {k: torch.zeros_like(v) for k, v in ts.params.items()},
        device="cpu")
    served = ServingModel(tg, vp.port_apply, template, str(tmp_path))
    assert served.full_update() == ts.step
    for k, v in ts.params.items():
        torch.testing.assert_close(served._ts.params[k], v, rtol=0, atol=0)
    b = vp.port_batch(raw[3])
    want = tloop.make_eval_step(tg, vp.port_apply)(ts, b)
    torch.testing.assert_close(served.predict(b), want, rtol=0, atol=0)
