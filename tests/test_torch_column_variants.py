"""Port parity: weighted columns, multi-hash embeddings and tensible
tables against the JAX package.

Weighted columns (``weight_name``): ``combine_bags`` and
``combine_from_occ`` with weights on random rows, every combiner; a
group of a weighted and an unweighted bag column of width 3 (EMPTY
padding) trained three steps by both packages from the same weights
(``tests/torch_variant_parity.py``): losses per step within rtol 1e-5,
key rows, freqs and versions bit for bit, rows, slots and dense params
within rtol 1e-5, atol 1e-6, eval logits alike; a row seen only with
weight 0 does not move. Multi-hash: ``qr_indices`` exactly, and
``MultiHashEmbedding`` with the flax module's ``part_{i}`` carried
across by ``convert.py``, outputs and the parts' gradients within
1e-6, for each operation. Tensible: ``TensibleEV`` with each admission
strategy and a black list, growth included, against the JAX one on the
same ids and gradients: capacity, generation, keys, freqs bit for bit,
rows and slots (those regrown through the export/import path too)
within 1e-6; P1's probes of the regrown table find every key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_variant_parity as vp
from deeprec_tpu import config as jcfg
from deeprec_tpu.embedding import lookup as jlookup
from deeprec_tpu.embedding import multi_hash as jmh
from deeprec_tpu.embedding import tensible as jtens
from deeprec_tpu.embedding import variable as jev
from deeprec_tpu.feature_column.feature_column import SparseIds as JIds
from deeprec_tpu.optimizers import sparse as jsopt
from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import convert
from deeprec_tpu_torch.embedding import hash_table as tht
from deeprec_tpu_torch.embedding import lookup as tlookup
from deeprec_tpu_torch.embedding import multi_hash as tmh
from deeprec_tpu_torch.embedding import tensible as ttens
from deeprec_tpu_torch.embedding import variable as tev
from deeprec_tpu_torch.feature_column.feature_column import SparseIds as TIds
from deeprec_tpu_torch.optimizers import sparse as tsopt
from deeprec_tpu_torch.utils import keys as keylib

torch.set_num_threads(1)

TOL = vp.TOL


# -- weighted columns --------------------------------------------------------

@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_weighted_combine_matches_jax(combiner):
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(9, 5)).astype(np.float32)
    inverse = rng.integers(0, 9, (6, 4))
    mask = rng.random((6, 4)) < 0.7
    mask[0] = False  # an empty bag: the 1e-9 floor
    w = (rng.random((6, 4)) * 3).astype(np.float32)
    for weights in (w, None):
        jw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else torch.from_numpy(weights)
        want = np.asarray(jlookup.combine_bags(
            jnp.asarray(rows), jnp.asarray(inverse), jnp.asarray(mask),
            combiner, weights=jw))
        got = tlookup.combine_bags(
            torch.from_numpy(rows), torch.from_numpy(inverse),
            torch.from_numpy(mask), combiner, weights=tw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        occ = rows[inverse] * mask[..., None]
        want = np.asarray(jlookup.combine_from_occ(
            jnp.asarray(occ), jnp.asarray(mask), combiner, weights=jw))
        got = tlookup.combine_from_occ(
            torch.from_numpy(occ), torch.from_numpy(mask), combiner,
            weights=tw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _weighted_cols(pkg):
    return [pkg.fc.EmbeddingColumn(name="a", dim=4, capacity=1 << 7,
                                   combiner="mean", weight_name="a_w"),
            pkg.fc.EmbeddingColumn(name="b", dim=3, capacity=1 << 7,
                                   combiner="sqrtn")]


@pytest.mark.parametrize("sparse", ["adagrad", "adam"])
def test_weighted_group_trains_as_jax(sparse):
    rng = np.random.default_rng(1)
    raw = vp.batches(rng, 4, 16, {"a": 3, "b": 3})
    out = vp.run_pair(_weighted_cols, raw[:3], sparse, eval_raw=raw[3])
    vp.assert_run_matches(out)


def test_zero_weight_row_does_not_move():
    raw = [{"a": np.array([[1, 2]], np.int64),
            "a_w": np.array([[1.0, 0.0]], np.float32),
            "b": np.array([[5, 6]], np.int64),
            "b_w": np.ones((1, 2), np.float32),
            "label": np.ones(1, np.float32)}]
    out = vp.run_pair(_weighted_cols, raw)
    vp.assert_run_matches(out)
    cfg = out.tg.tables["a"]
    st0 = tev.create(cfg, "cpu", salt=out.tg.salts["a"])
    hi, lo = keylib.split_ids(np.array([1, 2], np.int64))
    qhi, qlo = torch.from_numpy(hi), torch.from_numpy(lo)
    st0, _ = tev.lookup_train(cfg, st0, qhi, qlo, torch.ones(2), 0,
                              salt=out.tg.salts["a"])
    before = tev.lookup(cfg, st0, qhi, qlo)
    after = tev.lookup(cfg, out.tts.ev["a"], qhi, qlo)
    assert not torch.allclose(after[0], before[0])
    torch.testing.assert_close(after[1], before[1], rtol=0, atol=0)


def test_combine_tables_refuses_weighted_columns():
    from deeprec_tpu_torch.feature_column.feature_column import (
        EmbeddingColumn, EmbeddingGroup)
    g = EmbeddingGroup([EmbeddingColumn(name="a", dim=4, capacity=64,
                                        weight_name="a_w")])
    ids = TIds.from_numpy(np.array([[3], [4]], np.int64), "cpu")
    st = g.create_state("cpu")
    _, gl = g.lookup_train(st, {"a": ids, "a_w": torch.ones(2, 1)}, 0)
    with pytest.raises(ValueError, match="unweighted"):
        g.combine_tables(gl, {t: lk.rows for t, lk in gl.lks.items()})


# -- multi-hash ----------------------------------------------------------------

def test_qr_indices_match_jax():
    ids = np.concatenate([np.arange(0, 5000, 7),
                          [2**31 + 5, 2**40 + 3, -7]]).astype(np.int64)
    hi, lo = keylib.split_ids(ids)
    buckets = (97, 89, 13)
    want = jmh.qr_indices(jnp.asarray(hi), jnp.asarray(lo), buckets)
    got = tmh.qr_indices(torch.from_numpy(hi), torch.from_numpy(lo), buckets)
    for g, w, b in zip(got, want, buckets):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert int(g.max()) < b and int(g.min()) >= 0
    # Collision-free below prod(buckets[:2]).
    small = tmh.qr_indices(torch.zeros(97 * 89, dtype=torch.int32),
                           torch.arange(97 * 89, dtype=torch.int32),
                           buckets[:2])
    pairs = set(zip(small[0].tolist(), small[1].tolist()))
    assert len(pairs) == 97 * 89


@pytest.mark.parametrize("operation, combiner", [
    ("add", "mean"), ("mult", "sum"), ("concat", "sqrtn")])
def test_multihash_matches_jax(operation, combiner):
    buckets, dim = (31, 29), 8
    ids = np.array([[3, 5, keylib.EMPTY_ID], [700, keylib.EMPTY_ID,
                                              keylib.EMPTY_ID],
                    [899, 12, 3]], np.int64)
    jmod = jmh.MultiHashEmbedding(buckets=buckets, dim=dim,
                                  operation=operation, combiner=combiner)
    jids = JIds.from_numpy(ids)
    params = jmod.init(jax.random.key(0), jids)["params"]
    tmod = tmh.MultiHashEmbedding(buckets, dim, operation, combiner,
                                  device="cpu")
    tmod.load_state_dict(convert.params_from_numpy(
        jax.tree.map(np.asarray, params)))
    tids = TIds.from_numpy(ids, "cpu")
    want = np.asarray(jmod.apply({"params": params}, jids))
    got = tmod(tids)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-7)
    jgrad = jax.grad(lambda p: jnp.sum(
        jmod.apply({"params": p}, jids) ** 2))(params)
    (got ** 2).sum().backward()
    for i in range(len(buckets)):
        np.testing.assert_allclose(
            getattr(tmod, f"part_{i}").grad.numpy(),
            np.asarray(jgrad[f"part_{i}"]), rtol=1e-5, atol=1e-7)


# -- tensible tables -----------------------------------------------------------

CAP, DIM = 16, 4


def _tensible_pair(admit, blacklist=None, opt="adagrad", threshold=0.5):
    jcfg_ = jcfg.TableConfig(name="t", dim=DIM, capacity=CAP,
                             init_scale=0.5)
    tcfg_ = tcfg.TableConfig(name="t", dim=DIM, capacity=CAP,
                             init_scale=0.5)
    jopt, topt = ((jsopt.SparseAdagrad(0.1), tsopt.SparseAdagrad(0.1))
                  if opt == "adagrad" else
                  (jsopt.SparseAdam(0.01), tsopt.SparseAdam(0.01)))
    jadmit, tadmit = {
        "everything": (jtens.AdmitEverything(), ttens.AdmitEverything()),
        "read_only": (jtens.ReadOnlyAdmit(), ttens.ReadOnlyAdmit()),
        "bloom": (jtens.BloomAdmit(2, num_counters=256),
                  ttens.BloomAdmit(2, num_counters=256)),
    }[admit]
    jbl = tbl = None
    if blacklist is not None:
        jbl = jtens.BlackList(np.asarray(blacklist))
        tbl = ttens.BlackList(np.asarray(blacklist), device="cpu")
    j = jtens.TensibleEV(jcfg_, jopt, admit=jadmit, blacklist=jbl,
                         growth_threshold=threshold, max_capacity=CAP * 2,
                         salt=3)
    t = ttens.TensibleEV(tcfg_, topt, admit=tadmit, blacklist=tbl,
                         growth_threshold=threshold, max_capacity=CAP * 2,
                         salt=3, device="cpu")
    return j, t


def _step(j, t, ids, step, rng):
    hi, lo = keylib.split_ids(np.asarray(ids, np.int64))
    dd = jlookup.dedup(jnp.asarray(hi), jnp.asarray(lo))
    jlk = j.lookup_train(dd.uhi, dd.ulo, dd.counts, step)
    tlk = t.lookup_train(torch.from_numpy(np.asarray(dd.uhi)),
                         torch.from_numpy(np.asarray(dd.ulo)),
                         torch.from_numpy(np.asarray(dd.counts)), step)
    np.testing.assert_array_equal(tlk.slots.numpy(), np.asarray(jlk.slots))
    np.testing.assert_array_equal(tlk.admitted.numpy(),
                                  np.asarray(jlk.admitted))
    np.testing.assert_allclose(tlk.rows.numpy(), np.asarray(jlk.rows), **TOL)
    g = rng.normal(size=tuple(jlk.rows.shape)).astype(np.float32)
    j.apply_gradients(jlk, jnp.asarray(g), step)
    t.apply_gradients(tlk, torch.from_numpy(g), step)
    return j.maybe_grow(), t.maybe_grow()


def _assert_tensible_match(j, t):
    assert (t.capacity, t.generation) == (j.capacity, j.generation)
    np.testing.assert_array_equal(t.state.table.key_rows.numpy(),
                                  np.asarray(j.state.table.key_rows))
    np.testing.assert_array_equal(t.state.freqs.numpy(),
                                  np.asarray(j.state.freqs))
    np.testing.assert_allclose(t.state.values.numpy(),
                               np.asarray(j.state.values), **TOL)
    for k, v in j.slots.items():
        np.testing.assert_allclose(t.slots[k].numpy(), np.asarray(v), **TOL)


@pytest.mark.parametrize("admit, blacklist, opt", [
    ("everything", None, "adagrad"), ("everything", [3, 7, 11], "adam"),
    ("bloom", None, "adagrad"), ("read_only", None, "adagrad")])
def test_tensible_matches_jax(admit, blacklist, opt):
    j, t = _tensible_pair(admit, blacklist, opt)
    rng = np.random.default_rng(2)
    grew = []
    for step in range(4):
        ids = rng.integers(0, 12 + 10 * step, 10)
        jg, tg = _step(j, t, ids, step, rng)
        assert jg == tg
        grew.append(tg)
        _assert_tensible_match(j, t)
    live = int(tht.num_live(t.state.table))
    if admit == "read_only":
        assert live == 0 and not any(grew)
        return
    assert any(grew) and t.capacity > CAP
    # P1 probes the regrown table: every live key is found at its slot.
    arrays = tev.export_arrays(t.cfg, t.state)
    hi, lo = keylib.split_ids(arrays["keys"])
    slots = tht.find(t.state.table, torch.from_numpy(hi),
                     torch.from_numpy(lo), max_probes=t.cfg.max_probes)
    assert arrays["keys"].size == live
    assert bool((slots < t.capacity).all())
    if blacklist is not None:
        assert not set(blacklist) & set(arrays["keys"].tolist())


def test_blacklist_contains_matches_jax():
    banned = np.array([5, 2**40 + 1, -3, 99], np.int64)
    probe = np.array([5, 6, 2**40 + 1, -3, 0, 99, 100], np.int64)
    hi, lo = keylib.split_ids(probe)
    jbl = jtens.BlackList(banned)
    tbl = ttens.BlackList(banned, device="cpu")
    want = np.asarray(jbl.contains(jnp.asarray(hi), jnp.asarray(lo)))
    got = tbl.contains(torch.from_numpy(hi), torch.from_numpy(lo)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [True, False, True, True, False, True, False]
    empty = ttens.BlackList(np.zeros(0, np.int64), device="cpu")
    assert not empty.contains(torch.from_numpy(hi),
                              torch.from_numpy(lo)).any()
