"""Port: ``make_epoch_step(mesh=)`` on 2 gloo ranks.

The graft WDL of ``tests/torch_mesh_cases.py`` (its deep table
row-sharded, its wide table replicated) on a pool of 3 local batches
for 2 epochs: ``make_epoch_step(mesh=)`` against ``make_train_step
(mesh=)`` stepped over the same pool from the same state, bit for bit
(losses, every table's keys and rows, the dense params); gloo cannot
capture collectives, so the epoch runs its step loop, ``captured``
False and no replays.

Each rank against the JAX package's ``make_epoch_step(mesh=
data_mesh(2))`` on the same global pool, from the same tower weights
(``convert.params_to_numpy``): losses within rtol 1e-5; a sharded
table's shard holds exactly the keys of the JAX shard of its rank and
a replicated table the JAX table's, their rows key by key, and the
dense params, within rtol 1e-5, atol 1e-6 (``test_torch_mesh_train.py``'s
tolerances: float32 sums in another order). The same against the
port's one-device ``make_epoch_step`` on the global batches.
"""

import numpy as np
import pytest
import torch

import torch_mesh_cases as mc
from deeprec_tpu_torch import convert
from deeprec_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

WORLD = 2
POOL = 3
EPOCHS = 2
LOSS_RTOL = 1e-5
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_epoch")
    mc.launch("epoch", WORLD, tmp, pool=POOL, n_epochs=EPOCHS)
    return [mc.result("epoch", tmp, r) for r in range(WORLD)]


def _table_dict(arrs):
    return dict(zip(arrs["keys"].tolist(), arrs["values"]))


@pytest.fixture(scope="module")
def single():
    """The one-device epoch on the global batches: losses, tables
    ``{table: {key: row}}``, dense params."""
    group, model, afn, loss_fn, sopt, dopt = mc.wdl_parts()
    ts = tloop.create_train_state(group, model.state_dict(), dopt, sopt,
                                  "cpu")
    pool = [group.pack_batch_np(raw, "cpu")
            for raw in mc.global_batches(POOL)]
    run = tloop.make_epoch_step(group, afn, loss_fn, sopt, dopt,
                                n_epochs=EPOCHS)
    ts, losses = run(ts, tloop.stack_batches(pool))
    arrs = mc.table_arrays(group, ts.ev)
    tables = {t: dict(zip(arrs[f"keys/{t}"].tolist(), arrs[f"values/{t}"]))
              for t in group.tables}
    return dict(loss=losses.numpy(), tables=tables,
                dense={k: v.numpy() for k, v in ts.params.items()},
                step=ts.step)


@pytest.fixture(scope="module")
def jax_mesh():
    """The JAX package's epoch on ``data_mesh(WORLD)`` over the same
    global pool: losses ``[E, K]``, per table ``{key: row}`` of each
    shard (a sharded table) or of the whole (a replicated one), dense
    params under the port's names."""
    import jax
    import jax.numpy as jnp
    import optax

    from deeprec_tpu.embedding import variable as jev
    from deeprec_tpu.feature_column.feature_column import EmbeddingGroup
    from deeprec_tpu.models import wdl as jwdl
    from deeprec_tpu.optimizers import sparse as jsopt
    from deeprec_tpu.parallel.mesh import data_mesh
    from deeprec_tpu.train import loop as jloop
    from deeprec_tpu.train import losses as jlosses

    _, model, _, _, _, _ = mc.wdl_parts()
    group = EmbeddingGroup(
        jwdl.criteo_columns(embedding_dim=mc.DIM, capacity=mc.CAPACITY),
        coalesce=True, axis_name="data", num_shards=WORLD,
        placement="auto", replicate_threshold=mc.REPLICATE_THRESHOLD)
    tx, sopt = optax.adagrad(mc.LR), jsopt.SparseAdagrad(mc.LR)
    params = jax.tree.map(jnp.asarray,
                          convert.params_to_numpy(model.state_dict()))
    ts = jloop.create_train_state(group, params, tx, sopt)
    pool = [group.pack_batch_np(raw) for raw in mc.global_batches(POOL)]
    run = jloop.make_epoch_step(
        group, jwdl.apply_fn(jwdl.WDL(hidden=mc.HIDDEN), group),
        lambda o, b: jlosses.bce_with_logits(o, b["label"]), sopt, tx,
        mesh=data_mesh(WORLD), donate=False, n_epochs=EPOCHS)
    ts, losses = run(ts, jloop.stack_batches(pool))
    tables = {}
    for t, cfg in group.tables.items():
        if group._is_stacked(t):
            tables[t] = [_table_dict(jev.export_arrays(
                cfg, jax.tree.map(lambda x, s=s: x[s], ts.ev[t])))
                for s in range(WORLD)]
        else:
            tables[t] = _table_dict(jev.export_arrays(cfg, ts.ev[t]))
    dense = convert.params_from_numpy(jax.tree.map(np.asarray, ts.params))
    return dict(loss=np.asarray(losses), tables=tables,
                dense={k: v.numpy() for k, v in dense.items()},
                placement=group.placement_plan())


def _assert_rows_equal(keys, vals, want: dict, t):
    assert keys.size == len(want) and set(keys.tolist()) == set(want), t
    got = dict(zip(keys.tolist(), vals))
    order = sorted(want)
    np.testing.assert_allclose(np.stack([got[k] for k in order]),
                               np.stack([want[k] for k in order]),
                               **TOL, err_msg=t)


@pytest.mark.parametrize("rank", range(WORLD))
def test_epoch_equals_stepped_loop_bit_for_bit(ranks, rank):
    res = ranks[rank]
    got, want = mc.split_prefix(res, "epoch/"), mc.split_prefix(res,
                                                                "step/")
    assert got["loss"].shape == (EPOCHS, POOL)
    np.testing.assert_array_equal(got["loss"].reshape(-1), want["loss"])
    assert int(got["step"]) == int(want["step"]) == EPOCHS * POOL
    assert not want["n_overflow"].any()
    for k in want:
        if k.startswith(("keys/", "values/", "dense/")):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not bool(got["captured"]) and int(got["replays"]) == 0


def test_epoch_on_mesh_agrees_with_one_device(ranks, single):
    place = dict(ranks[0]["placement"].tolist())
    assert sorted(place.values()) == ["replicated", "sharded"]
    for res in ranks:
        np.testing.assert_allclose(res["epoch/loss"], single["loss"],
                                   rtol=LOSS_RTOL)
        for k, v in single["dense"].items():
            np.testing.assert_allclose(res[f"epoch/dense/{k}"], v, **TOL,
                                       err_msg=k)
    for t, want in single["tables"].items():
        # A replicated table is whole on each rank (the ranks' copies
        # are bit-equal); a sharded one is split over them.
        parts = ranks[:1] if place[t] == "replicated" else ranks
        if place[t] == "replicated":
            np.testing.assert_array_equal(ranks[1][f"epoch/values/{t}"],
                                          ranks[0][f"epoch/values/{t}"])
        _assert_rows_equal(
            np.concatenate([r[f"epoch/keys/{t}"] for r in parts]),
            np.concatenate([r[f"epoch/values/{t}"] for r in parts]), want, t)


@pytest.mark.parametrize("rank", range(WORLD))
def test_epoch_on_mesh_agrees_with_jax(ranks, jax_mesh, rank):
    """Rank ``rank`` against the JAX shard_map epoch: its losses, its
    shard of a sharded table (the JAX shard ``rank``), a replicated
    table whole, the dense params."""
    res = ranks[rank]
    assert dict(res["placement"].tolist()) == jax_mesh["placement"]
    assert res["epoch/loss"].shape == jax_mesh["loss"].shape
    np.testing.assert_allclose(res["epoch/loss"], jax_mesh["loss"],
                               rtol=LOSS_RTOL)
    for t, want in jax_mesh["tables"].items():
        if isinstance(want, list):
            want = want[rank]
        _assert_rows_equal(res[f"epoch/keys/{t}"], res[f"epoch/values/{t}"],
                           want, t)
    assert set(jax_mesh["dense"]) == {k[len("epoch/dense/"):] for k in res
                                      if k.startswith("epoch/dense/")}
    for k, v in jax_mesh["dense"].items():
        np.testing.assert_allclose(res[f"epoch/dense/{k}"], v, **TOL,
                                   err_msg=k)
