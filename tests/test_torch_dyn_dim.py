"""Port parity: dynamic-dimension tables against the JAX package.

Three forms: a masked table (``block_num`` 4, the full matrix stored,
locked blocks read 0); ``dyn_dim.DynDimEV``, whose blocks 1.. live in a
small CBF-admitted sibling; and the group's split of a column with
``dyn_dim_hot_capacity`` into a base table and its ``#hot`` sibling,
trained through ``make_train_step`` and read by ``make_eval_step``.

K2 and K3 (plain versions here; ``tests/test_torch_sparse_apply.py``
holds the kernels against them on the card, ``base_rows`` included)
update a masked table from the lookup's masked rows, as the JAX applies update from ``lk.rows``: a fresh row's
locked columns are written back as 0, not as their draw, and a block
unlocked later starts from 0. Held over several steps in which blocks
unlock: key rows, freqs and versions bit for bit, rows and slots within
rtol 1e-5, atol 1e-6, losses per step within rtol 1e-5, eval logits
alike. ``memory_rows`` is the JAX one's; checkpoints carry both
siblings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_variant_parity as vp
from deeprec_tpu import config as jcfg
from deeprec_tpu.embedding import dyn_dim as jdd
from deeprec_tpu.embedding import lookup as jlookup
from deeprec_tpu.embedding import variable as jev
from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch.embedding import dyn_dim as tdd
from deeprec_tpu_torch.embedding import variable as tev
from deeprec_tpu_torch.utils import keys as keylib

torch.set_num_threads(1)

TOL = vp.TOL
DIM, BLOCKS, CAP, HOT_CAP = 8, 4, 64, 16
THR = (2, 4, 6)


def _cfgs(**kw):
    return (jcfg.TableConfig(name="d", dim=DIM, capacity=CAP, init_scale=1.0,
                             block_num=BLOCKS, dyn_dim_thresholds=THR, **kw),
            tcfg.TableConfig(name="d", dim=DIM, capacity=CAP, init_scale=1.0,
                             block_num=BLOCKS, dyn_dim_thresholds=THR, **kw))


def _ids(rng, step):
    """A recurring head (ids 0-3, unlocking blocks over the steps) and
    a fresh tail each step."""
    return np.concatenate([np.arange(4), 100 + 10 * step
                           + rng.integers(0, 10, 6)]).astype(np.int64)


@pytest.mark.parametrize("opt", ["adagrad", "adam", "adam_async"])
def test_masked_applies_match_jax(opt):
    """K2/K3's plain versions on a masked table's occurrence lookups,
    six steps: the JAX package's ``SparseAdagrad``/``SparseAdam``/
    ``SparseAdamAsync`` apply on its own lookup of the same ids."""
    jc, tc = _cfgs()
    jopt, topt = vp.SPARSE[opt]()
    jst, tst = jev.create(jc, salt=5), tev.create(tc, "cpu", salt=5)
    jsl, tsl = jopt.init(jc), topt.init(tc, "cpu")
    rng = np.random.default_rng(0)
    jlook = jax.jit(lambda *a: jev.lookup_train_occ(jc, *a, salt=5))
    japply = jax.jit(lambda *a: jopt.apply(jc, *a))
    for step in range(6):
        hi, lo = keylib.split_ids(_ids(rng, step))
        jst, jocc = jlook(jst, jnp.asarray(hi), jnp.asarray(lo), step)
        tst, tocc = tev.lookup_train_occ(tc, tst, torch.from_numpy(hi),
                                         torch.from_numpy(lo), step, salt=5)
        jlk, tlk = jocc.lk, tocc.lk
        np.testing.assert_array_equal(tlk.slots.numpy(),
                                      np.asarray(jlk.slots))
        np.testing.assert_allclose(tlk.rows.numpy(), np.asarray(jlk.rows),
                                   **TOL)
        # The masked forward gives locked columns no gradient.
        g = (rng.normal(size=tlk.rows.shape)
             * (tlk.rows.numpy() != 0)).astype(np.float32)
        jsl, jvals = japply(jsl, jst.values, jlk, jnp.asarray(g), step)
        jst = jst.replace(values=jvals)
        topt.apply(tc, tsl, tst.values, tlk, torch.from_numpy(g), step)
        np.testing.assert_array_equal(tst.freqs.numpy(),
                                      np.asarray(jst.freqs))
        np.testing.assert_allclose(tst.values.numpy(), np.asarray(jvals),
                                   **TOL)
        for k, v in jsl.items():
            np.testing.assert_allclose(tsl[k].numpy(), np.asarray(v), **TOL)
    # The head unlocked every block; a tail key's locked columns are 0
    # in the table (written back from the masked row), not its draw.
    freqs = tst.freqs[:-1]
    assert int(freqs.max()) >= THR[-1]
    cold = (freqs == 1).nonzero()[:, 0]
    assert cold.numel() and bool((tst.values[cold, DIM // BLOCKS:] == 0)
                                 .all())


def _ev_pair():
    jc, tc = _cfgs()
    return (jdd.DynDimEV(jc, hot_capacity=HOT_CAP, cbf_counters=1 << 12),
            tdd.DynDimEV(tc, hot_capacity=HOT_CAP, cbf_counters=1 << 12))


def test_split_configs_and_memory_match_jax():
    j, t = _ev_pair()
    for jc, tc in ((j.base_cfg, t.base_cfg), (j.hot_cfg, t.hot_cfg)):
        assert (tc.name, tc.dim, tc.capacity, tc.block_num,
                tc.dyn_dim_thresholds) == (jc.name, jc.dim, jc.capacity,
                                           jc.block_num,
                                           jc.dyn_dim_thresholds)
    jf, tf = j.hot_cfg.ev_option.filter_option, t.hot_cfg.ev_option.filter_option
    assert (tf.filter_freq, tf.num_counters, tf.num_hash_func) == (
        jf.filter_freq, jf.num_counters, jf.num_hash_func) == (THR[0], 4096, 3)
    assert t.base_cfg.ev_option.filter_option is None
    assert t.memory_rows() == j.memory_rows() == (
        CAP * (DIM // BLOCKS) + HOT_CAP * (DIM - DIM // BLOCKS))
    st = t.create("cpu")
    assert st.base.values.shape == (CAP + 1, DIM // BLOCKS)
    assert st.hot.values.shape == (HOT_CAP + 1, DIM - DIM // BLOCKS)
    with pytest.raises(ValueError, match="block_num"):
        tdd.split_configs(tcfg.TableConfig(name="x", dim=4, capacity=8), 4)


@pytest.mark.parametrize("opt", ["adagrad", "adam"])
def test_dyn_dim_ev_matches_jax(opt, tmp_path):
    """DynDimEV over six steps (the hot sibling admits the head at its
    first threshold, its own blocks unlock later): lookups, applies,
    inference reads, checkpoint round trip and shrink."""
    j, t = _ev_pair()
    jopt, topt = vp.SPARSE[opt]()
    jst, tst = j.create(salt=2), t.create("cpu", salt=2)
    jsl, tsl = j.init_optimizer(jopt), t.init_optimizer(topt, "cpu")
    rng = np.random.default_rng(1)
    jlookup_train = jax.jit(lambda *a: j.lookup_train(*a, salt=2))
    japply = jax.jit(lambda *a: j.apply_gradients(jopt, *a))
    for step in range(6):
        hi, lo = keylib.split_ids(_ids(rng, step))
        dd = jlookup.dedup(jnp.asarray(hi), jnp.asarray(lo))
        args = [np.array(x) for x in (dd.uhi, dd.ulo, dd.counts)]
        jst, jlk = jlookup_train(jst, *dd[:3], step)
        tst, tlk = t.lookup_train(tst, *(torch.from_numpy(a) for a in args),
                                  step, salt=2)
        np.testing.assert_array_equal(tlk.hot.slots.numpy(),
                                      np.asarray(jlk.hot.slots))
        np.testing.assert_allclose(tlk.rows.numpy(), np.asarray(jlk.rows),
                                   **TOL)
        g = rng.normal(size=tlk.rows.shape).astype(np.float32)
        jsl, jst = japply(jsl, jst, jlk, jnp.asarray(g), step)
        tsl, tst = t.apply_gradients(topt, tsl, tst, tlk,
                                     torch.from_numpy(g), step)
        for js, ts in ((jst.base, tst.base), (jst.hot, tst.hot)):
            np.testing.assert_array_equal(ts.table.key_rows.numpy(),
                                          np.asarray(js.table.key_rows))
            np.testing.assert_array_equal(ts.freqs.numpy(),
                                          np.asarray(js.freqs))
            np.testing.assert_allclose(ts.values.numpy(),
                                       np.asarray(js.values), **TOL)
    # The head (and tail ids seen twice in a step) earned hot rows; most
    # tail ids did not.
    n_hot = int(tev.num_live(tst.hot))
    hot_keys = set(tev.export_arrays(t.hot_cfg, tst.hot)["keys"].tolist())
    assert {0, 1, 2, 3} <= hot_keys
    assert 2 * n_hot < int(tev.num_live(tst.base))
    hi, lo = keylib.split_ids(np.array([0, 1, 2, 3, 555], np.int64))
    jrows = np.asarray(j.lookup(jst, jnp.asarray(hi), jnp.asarray(lo)))
    trows = t.lookup(tst, torch.from_numpy(hi), torch.from_numpy(lo))
    np.testing.assert_allclose(trows.numpy(), jrows, **TOL)
    arrays = t.export_arrays(tst)
    assert arrays["hot"]["values"].shape == (n_hot, DIM - DIM // BLOCKS)
    back = t.import_arrays(t.create("cpu", salt=2), arrays)
    torch.testing.assert_close(
        t.lookup(back, torch.from_numpy(hi), torch.from_numpy(lo)), trows,
        rtol=0, atol=0)


def test_shrink_applies_to_both_like_jax():
    evo_j = jcfg.EmbeddingVariableOption(
        evict_option=jcfg.GlobalStepEvict(steps_to_live=2))
    evo_t = tcfg.EmbeddingVariableOption(
        evict_option=tcfg.GlobalStepEvict(steps_to_live=2))
    jc, tc = _cfgs(ev_option=evo_j)[0], _cfgs(ev_option=evo_t)[1]
    jc = jc.__class__(**{**jc.__dict__, "dyn_dim_thresholds": (1, 4, 6)})
    tc = tc.__class__(**{**tc.__dict__, "dyn_dim_thresholds": (1, 4, 6)})
    j = jdd.DynDimEV(jc, hot_capacity=HOT_CAP, cbf_counters=1 << 12)
    t = tdd.DynDimEV(tc, hot_capacity=HOT_CAP, cbf_counters=1 << 12)
    hi, lo = keylib.split_ids(np.array([5], np.int64))
    cnt = np.array([2], np.int32)
    jst, _ = jax.jit(j.lookup_train)(j.create(), jnp.asarray(hi),
                                     jnp.asarray(lo), jnp.asarray(cnt), 0)
    tst, _ = t.lookup_train(t.create("cpu"), torch.from_numpy(hi),
                            torch.from_numpy(lo), torch.from_numpy(cnt), 0)
    assert (int(tev.num_live(tst.base)), int(tev.num_live(tst.hot))) == (1, 1)
    jst, tst = j.shrink(jst, 10), t.shrink(tst, 10)
    for js, ts in ((jst.base, tst.base), (jst.hot, tst.hot)):
        assert int(tev.num_live(ts)) == int(jev.num_live(js)) == 0


def test_blocks_unlock_with_frequency_like_jax():
    """The masked table's unlocked width as a key's freq grows
    (thresholds 3, 6, 9; constant rows), the JAX package's own case."""
    kw = dict(name="t", dim=8, capacity=64, initializer="constant",
              init_scale=1.0, block_num=4, dyn_dim_thresholds=(3, 6, 9))
    jc, tc = jcfg.TableConfig(**kw), tcfg.TableConfig(**kw)
    jst, tst = jev.create(jc), tev.create(tc, "cpu")
    hi, lo = keylib.split_ids(np.array([42], np.int64))
    widths = []
    jlook = jax.jit(lambda *a: jev.lookup_train_occ(jc, *a))
    for step in range(10):
        jst, jocc = jlook(jst, jnp.asarray(hi), jnp.asarray(lo), step)
        tst, tocc = tev.lookup_train_occ(tc, tst, torch.from_numpy(hi),
                                         torch.from_numpy(lo), step)
        np.testing.assert_array_equal(tocc.lk.rows.numpy(),
                                      np.asarray(jocc.lk.rows))
        widths.append(int((tocc.lk.rows[0] != 0).sum()))
    assert widths == [2, 2, 4, 4, 4, 6, 6, 6, 8, 8]


def _split_cols(pkg, **kw):
    return [pkg.fc.EmbeddingColumn(
        name="f", dim=DIM, capacity=CAP, init_scale=1.0,
        dyn_dim_blocks=BLOCKS, dyn_dim_thresholds=THR,
        dyn_dim_hot_capacity=HOT_CAP, **kw),
        pkg.fc.EmbeddingColumn(name="g", dim=4, capacity=CAP)]


def _split_batches(n, B=16, seed=3):
    """Batches whose first half of rows carry a recurring id (hot)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in vp.batches(rng, n, B, {"f": 2, "g": 1}, vocab=1000):
        b["f"][: B // 2, 0] = np.arange(B // 2) % 3
        out.append(b)
    return out


@pytest.mark.parametrize("sparse", ["adagrad", "adam"])
def test_group_split_trains_as_jax(sparse):
    raw = _split_batches(6)
    out = vp.run_pair(_split_cols, raw[:5], sparse, eval_raw=raw[5])
    assert set(out.tg.tables) == {"f", "f#hot", "g"}
    assert out.tg.tables["f#hot"].capacity == HOT_CAP
    vp.assert_run_matches(out)
    hot = tev.export_arrays(out.tg.tables["f#hot"], out.tts.ev["f#hot"])
    assert {0, 1, 2} <= set(hot["keys"].tolist())
    assert 2 * hot["keys"].size < int(tev.num_live(out.tts.ev["f"]))


def test_group_split_checkpoint_carries_both(tmp_path):
    from deeprec_tpu_torch.train import checkpoint as tckpt
    from deeprec_tpu_torch.train import loop as tloop
    raw = _split_batches(4)
    out = vp.run_pair(_split_cols, raw[:3], "adagrad")
    tg = out.tg
    mgr = tckpt.CheckpointManager(str(tmp_path), tg)
    mgr.save(out.tts)
    fresh = tloop.create_train_state(
        tg, {k: torch.zeros_like(v) for k, v in out.tts.params.items()},
        device="cpu")
    back = mgr.restore(fresh)
    for t in ("f", "f#hot"):
        want = tev.export_arrays(tg.tables[t], out.tts.ev[t])
        got = tev.export_arrays(tg.tables[t], back.ev[t])
        assert want["keys"].size and set(got["keys"]) == set(want["keys"])
    ev_step = tloop.make_eval_step(tg, vp.port_apply)
    b = vp.port_batch(raw[3])
    torch.testing.assert_close(ev_step(back, b), ev_step(out.tts, b),
                               rtol=0, atol=0)
