"""Port parity: WDL towers, the Criteo column set, the synthetic stream
and the eval step against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprec_tpu import config as jcfg
from deeprec_tpu.data import criteo as jcriteo
from deeprec_tpu.embedding import variable as jev
from deeprec_tpu.feature_column.feature_column import (
    EmbeddingGroup as JGroup)
from deeprec_tpu.models import wdl as jwdl
from deeprec_tpu.train import loop as jloop
from deeprec_tpu.utils import stateless_random as jsr
from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import convert
from deeprec_tpu_torch.data import criteo as tcriteo
from deeprec_tpu_torch.feature_column.feature_column import (
    EmbeddingGroup as TGroup)
from deeprec_tpu_torch.models import wdl as twdl
from deeprec_tpu_torch.train import loop as tloop
from deeprec_tpu_torch.utils import keys as tkeys

torch.set_num_threads(1)

# bf16 towers round activations to 8 mantissa bits at every layer, and
# the two frameworks round at different points (fused bias add or not),
# so bf16 logits agree to a few bf16 ulps of their magnitude.
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
FP32_TOL = dict(rtol=1e-5, atol=1e-5)


def _embs(wide_in_deep, B=16, seed=0):
    r = np.random.default_rng(seed)
    dims = {"C1": 4, "C2": 8, "C3": 2}
    embs = {}
    for k, d in dims.items():
        if wide_in_deep:
            embs[k] = r.normal(size=(B, d + 1)).astype(np.float32)
        else:
            embs[k] = r.normal(size=(B, d)).astype(np.float32)
            embs[k + "_wide"] = r.normal(size=(B, 1)).astype(np.float32)
    numeric = r.normal(size=(B, 3)).astype(np.float32)
    return embs, numeric, sum(dims.values()) + 3


@pytest.mark.parametrize("wide_in_deep", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wdl_forward_matches_flax(wide_in_deep, dtype):
    embs, numeric, width = _embs(wide_in_deep)
    jmodel = jwdl.WDL(hidden=(32, 16), dtype=getattr(jnp, dtype))
    jembs = {k: jnp.asarray(v) for k, v in embs.items()}
    params = jmodel.init(jax.random.key(0), jembs,
                         jnp.asarray(numeric))["params"]
    want = np.asarray(jmodel.apply({"params": params}, jembs,
                                   jnp.asarray(numeric)))
    tmodel = twdl.WDL(width, hidden=(32, 16), dtype=getattr(torch, dtype),
                      device="cpu")
    tmodel.load_state_dict(convert.wdl_params_from_numpy(
        jax.tree.map(np.asarray, params)))
    got = tmodel({k: torch.from_numpy(v) for k, v in embs.items()},
                 torch.from_numpy(numeric))
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.detach().numpy(), want, **tol)


def test_params_roundtrip():
    tree = {"deep": {"dense_0": {"kernel": np.ones((3, 2), np.float32),
                                 "bias": np.zeros(2, np.float32)}},
            "head": {"logits": {"kernel": np.ones((2, 1), np.float32),
                                "bias": np.zeros(1, np.float32)}}}
    sd = convert.wdl_params_from_numpy(tree)
    assert sd["deep.dense_0.weight"].shape == (2, 3)
    back = convert.wdl_params_to_numpy(sd)
    np.testing.assert_array_equal(back["deep"]["dense_0"]["kernel"],
                                  tree["deep"]["dense_0"]["kernel"])


def _groups(reference_shapes, **kw):
    jevo = jcfg.EmbeddingVariableOption(record_freq=False,
                                        record_version=False)
    tevo = tcfg.EmbeddingVariableOption(record_freq=False,
                                        record_version=False)
    jcols = jwdl.criteo_columns(reference_shapes=reference_shapes,
                                wide_in_deep=True, ev_option=jevo, **kw)
    tcols = twdl.criteo_columns(reference_shapes=reference_shapes,
                                wide_in_deep=True, ev_option=tevo, **kw)
    return JGroup(jcols, coalesce=True), TGroup(tcols, coalesce=True)


def test_reference_shape_group_matches():
    jg, tg = _groups(True, capacity=1 << 20)
    assert list(tg.tables) == list(jg.tables)
    for name, tc in tg.tables.items():
        jc = jg.tables[name]
        assert (tc.dim, tc.capacity, tc.initializer, tc.init_scale) == (
            jc.dim, jc.capacity, jc.initializer, jc.init_scale)
    assert tg.salts == jg.salts
    assert tg._phys_of == jg._phys_of
    # The headline shape: two physical tables, 129 x 2^22 and 65 x 2^19.
    assert sorted((t.dim, t.capacity) for t in tg.tables.values()) == [
        (65, 1 << 19), (129, 1 << 22)]
    assert twdl.input_width(tg) == 2176 + 13


def test_synthetic_stream_and_packing_match():
    jdata = jcriteo.SyntheticCriteo(64, vocab=jcriteo.CRITEO_HASH_BUCKETS,
                                    seed=3)
    tdata = tcriteo.SyntheticCriteo(64, vocab=tcriteo.CRITEO_HASH_BUCKETS,
                                    seed=3)
    jb = jdata.next_batch()
    tb = tdata.next_batch("cpu")
    for k, v in jb.items():
        if k.startswith("C"):
            np.testing.assert_array_equal(tb[k].hi.numpy(), np.asarray(v.hi))
            np.testing.assert_array_equal(tb[k].lo.numpy(), np.asarray(v.lo))
        else:
            np.testing.assert_array_equal(np.asarray(tb[k]), np.asarray(v))
    jg, tg = _groups(True, capacity=1 << 20)
    raw = tdata.next_batch_np(wide=False)
    jp = jg.pack_batch_np(raw)
    tp = tg.pack_batch_np(raw, "cpu")
    for name in tg.tables:
        key = tg.PACKED_PREFIX + name
        np.testing.assert_array_equal(tp[key].hi.numpy(),
                                      np.asarray(jp[key].hi))
        np.testing.assert_array_equal(tp[key].lo.numpy(),
                                      np.asarray(jp[key].lo))
    # per-column transform == host packing
    for c in tg.embedding[:4]:
        h, l = tg.transform_ids(c, tb[c.name].hi, tb[c.name].lo)
        hn, ln = tg.transform_ids_np(c, tkeys.join_ids(
            tb[c.name].hi.numpy(), tb[c.name].lo.numpy()))
        np.testing.assert_array_equal(h.numpy(), hn)
        np.testing.assert_array_equal(l.numpy(), ln)


def test_eval_step_matches_jax():
    jg, tg = _groups(False, embedding_dim=4, capacity=256)
    data = tcriteo.SyntheticCriteo(32, vocab=50, seed=1)
    # Fill each table with the ids of a few batches, rows drawn as a
    # fresh insert draws them.
    jstates = jg.create_state()
    for tname, cfg in jg.tables.items():
        keys = []
        for _ in range(3):
            raw = data.next_batch_np(wide=False)
            for c in jg.embedding:
                if jg.physical_table_of(c) == tname:
                    keys.append(tkeys.join_ids(
                        *jg.transform_ids_np(c, raw[c.name])).reshape(-1))
        keys = np.unique(np.concatenate(keys))
        hi, lo = tkeys.split_ids(keys)
        vals = np.asarray(jsr.init_rows(
            cfg.initializer, jnp.asarray(hi), jnp.asarray(lo), cfg.dim,
            cfg.init_scale, salt=jg.salts[tname]))
        jstates[tname] = jev.import_arrays(cfg, jstates[tname], {
            "keys": keys, "values": vals,
            "freqs": np.ones(keys.size, np.int32),
            "versions": np.zeros(keys.size, np.int32)})
    batch = data.next_batch_np(wide=False)
    jmodel = jwdl.WDL(hidden=(16, 8))
    jp = jg.pack_batch_np(batch)
    jts = jloop.TrainState(params=None, dense_opt=None, ev=jstates,
                           slots={}, step=jnp.int32(0))
    embs0 = {c.name: jnp.zeros((32, c.dim)) for c in jg.embedding}
    params = jmodel.init(jax.random.key(1), embs0,
                         jg.numeric_features(jp))["params"]
    jts = jts.replace(params=params)
    want = np.asarray(jloop.make_eval_step(
        jg, jwdl.apply_fn(jmodel, jg))(jts, jp))

    tmodel = twdl.WDL(twdl.input_width(tg), hidden=(16, 8), device="cpu")
    tparams = convert.wdl_params_from_numpy(jax.tree.map(np.asarray, params))
    tev = {}
    for tname, st in jstates.items():
        tev[tname] = convert.ev_state_from_numpy(
            {"key_rows": np.asarray(st.table.key_rows),
             **{k: np.asarray(getattr(st, k)) for k in
                ("values", "freqs", "versions", "default_bank", "bloom")}},
            "cpu")
    tts = tloop.TrainState(params=tparams, ev=tev)
    got = tloop.make_eval_step(tg, twdl.apply_fn(tmodel, tg))(
        tts, tg.pack_batch_np(batch, "cpu"))
    np.testing.assert_allclose(got.numpy(), want, **FP32_TOL)
