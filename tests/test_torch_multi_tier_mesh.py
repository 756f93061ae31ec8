"""Port parity: multi-tier storage on a mesh of two gloo ranks.

A 4-wide ``HBM_HOST`` table row-sharded over S = 2 ranks
(``tests/torch_mesh_cases.py``'s ``multi_tier`` case, one launch),
trained on a 16-row global batch of ids 1..16, six batches of fresh ids
that force demotions on both shards (watermarks 0.5 / 0.25, every
step), then ids 1..16 again, each rank on its 8 rows. The test holds:

* every spilled key sits in its owner's store;
* the rows of ids 1..16 come back bit for bit, those a rank's batch
  asks of the other rank's shard included: that rank demoted them, and
  only the all-gather of ``pre_step`` tells it they are wanted. The same
  run with the gather cut (each rank promotes its own rows' ids) reads
  fresh rows for them instead;
* each rank's spill store equals, key by key, its shard's store of the
  JAX package's ``TieredGroup`` at ``num_shards=2`` on the same global
  batches (keys, freqs and versions exact; rows and losses within 1e-6);
* spill files re-bucket: the S = 2 checkpoint restores on one device
  with the union of both stores, and a one-device checkpoint restores
  onto each rank with the keys it owns.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_mesh_cases as mc
from deeprec_tpu import config as jcfg
from deeprec_tpu.embedding import multi_tier as jmt
from deeprec_tpu.feature_column import feature_column as jfc
from deeprec_tpu.optimizers import sparse as jsopt
from deeprec_tpu.parallel.mesh import data_mesh
from deeprec_tpu.train import loop as jloop
from deeprec_tpu_torch.utils import keys as keylib

torch.set_num_threads(1)

S = 2
TOL = dict(rtol=1e-6, atol=1e-6)


def _jax_stores():
    """The JAX package's sharded TieredGroup over the global batches,
    up to the end of the flood: losses and each shard's spill export."""
    group = mc.tier_model(jcfg, jfc, S)
    opt, tx = jsopt.SparseSGD(0.5), optax.sgd(0.1)
    mesh = data_mesh(S)
    ts = jloop.create_train_state(group, {"w": jnp.ones((4,))}, tx, opt)
    step = jloop.make_train_step(
        group, lambda p, e, b: jnp.sum(e["f"] * p["w"], axis=1),
        lambda out, b: (out - b["label"]) ** 2, opt, tx, mesh=mesh,
        donate=False)
    tiered = jmt.TieredGroup(group, ts.slots, high_watermark=0.5,
                             low_watermark=0.25, demote_every=1)
    losses = []
    for ids in mc.tier_batches()[:-1]:
        b = {"f": jfc.SparseIds.from_numpy(ids[:, None]),
             "label": jnp.ones((ids.size,), jnp.float32)}
        ts = tiered.pre_step(ts, b)
        ts, m = step(ts, b)
        ts = tiered.post_step(ts)
        losses.append(float(m["loss"]))
    return np.array(losses), tiered.export_spill()["f"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multi_tier_mesh")
    ckpt_s1, ckpt_s2 = str(tmp / "ckpt_s1"), str(tmp / "ckpt_s2")
    single = mc.tier_run(None, ckpt_s1)
    mc.launch("multi_tier", S, tmp, ckpt_s2=ckpt_s2, ckpt_s1=ckpt_s1)
    ranks = [mc.result("multi_tier", tmp, r) for r in range(S)]
    jloss, jstores = _jax_stores()
    return {"single": single, "ranks": ranks, "jloss": jloss,
            "jstores": jstores, "from_s2": mc.tier_restore(None, ckpt_s2)}


def _store(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


def _by_key(arrays):
    order = np.argsort(arrays["keys"], kind="stable")
    return {k: np.asarray(v)[order] for k, v in arrays.items()}


def _assert_stores_equal(got, want, what):
    got, want = _by_key(got), _by_key(want)
    assert sorted(got) == sorted(want), what
    for k in want:
        if np.issubdtype(want[k].dtype, np.floating):
            np.testing.assert_allclose(got[k], want[k], **TOL,
                                       err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{what} {k}")


def test_spilled_keys_sit_in_their_owners_store(runs):
    for r, res in enumerate(runs["ranks"]):
        keys = res["gather/spill/keys"]
        assert keys.size > 0
        np.testing.assert_array_equal(keylib.shard_of_np(keys, S),
                                      np.full(keys.size, r))


def test_rows_round_trip_bit_for_bit(runs):
    for res in runs["ranks"]:
        assert int(res["gather/promoted"]) > 0
        np.testing.assert_array_equal(res["gather/back"],
                                      res["gather/first"])
        assert np.abs(res["gather/first"]).sum() > 0


def test_a_row_asked_by_the_other_rank_comes_back(runs):
    """Ids of a rank's rows that the other rank owns and had demoted:
    trained rows with the gather, fresh ones without it."""
    first = mc.tier_batches()[0]
    bl = first.size // S
    checked = 0
    for r, res in enumerate(runs["ranks"]):
        other = runs["ranks"][1 - r]
        mine = first[r * bl:(r + 1) * bl]
        cross = (np.isin(mine, other["gather/before/store"])
                 & (keylib.shard_of_np(mine, S) == 1 - r))
        checked += int(cross.sum())
        np.testing.assert_array_equal(res["gather/back"][cross],
                                      res["gather/first"][cross])
        assert np.array_equal(
            np.isin(mine, other["local/before/store"]), cross)
        assert not (res["local/back"][cross]
                    == res["local/first"][cross]).all(axis=1).any()
        np.testing.assert_array_equal(res["local/back"][cross], 0.0)
    assert checked > 0


def test_stores_match_the_jax_package(runs):
    for r, res in enumerate(runs["ranks"]):
        np.testing.assert_allclose(res["gather/loss"], runs["jloss"], **TOL)
        _assert_stores_equal(_store(res, "gather/spill/"),
                             runs["jstores"][r], f"shard {r}")


def test_spill_rebuckets_across_shard_counts(runs):
    # S = 2 -> 1: one device holds both ranks' rows.
    both = {k: np.concatenate([_store(res, "gather/spill/")[k]
                               for res in runs["ranks"]])
            for k in _store(runs["ranks"][0], "gather/spill/")}
    _assert_stores_equal(_store(runs["from_s2"], "spill/"), both, "2 -> 1")
    # S = 1 -> 2: each rank keeps the keys it owns.
    single = _store(runs["single"], "spill/")
    assert single["keys"].size > 0
    owner = keylib.shard_of_np(single["keys"], S)
    for r, res in enumerate(runs["ranks"]):
        _assert_stores_equal(_store(res, "restore/spill/"),
                             {k: v[owner == r] for k, v in single.items()},
                             f"1 -> 2, rank {r}")
