"""Port parity: the mesh branches of the train and eval steps, and
checkpoints that reshard.

The port's WDL at the sizes of ``__graft_entry__._build`` (dim-16 deep
and dim-1 wide columns, capacity 1 << 14, coalesced; towers 256/128/64
in float32), with ``placement="auto"`` at a 16 MiB threshold, so its
deep table is row-sharded and its wide table replicated, trains three
steps of two micro-batches each on S = 2 and S = 4 gloo ranks
(``tests/torch_mesh_cases.py``), each rank on its slice of a 64-row
global batch; the port on one device trains the same global batches.
The losses must agree within rtol 1e-5 and ``n_overflow`` read 0; the
tables hold the same keys, exactly, and their rows agree key by key
within rtol 1e-5, atol 1e-6 (float32 sums in another order; the
differences seen are below 5e-8); so do the sharded eval's logits.

Checkpoints: the S = 2 run's save restores on one device with the same
keys, rows and logits; the one-device run's save restores at S = 2; a
JAX checkpoint written at S = 2 (its tables filled by one sharded
lookup under ``shard_map``) restores in the port at S = 2 and at S = 1,
and the port's S = 2 save restores in the JAX package at S = 1, each
with eval logits equal to the JAX package's (rtol 1e-5, atol 1e-6).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_mesh_cases as mc
from deeprec_tpu.feature_column.feature_column import EmbeddingGroup as JGroup
from deeprec_tpu.models import wdl as jwdl
from deeprec_tpu.optimizers import sparse as jsopt
from deeprec_tpu.parallel.mesh import data_mesh
from deeprec_tpu.train import checkpoint as jckpt
from deeprec_tpu.train import loop as jloop
from deeprec_tpu_torch import convert
from deeprec_tpu_torch.embedding import variable as tev
from deeprec_tpu_torch.train import checkpoint as tckpt
from deeprec_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

STEPS = 3
MICRO = 2
LOSS_RTOL = 1e-5
TOL = dict(rtol=1e-5, atol=1e-6)


def _placement(res):
    return dict(res["placement"].tolist())


def _merged_tables(ranks):
    """{table: {key: row}} over the ranks: a sharded table's shards
    (disjoint), a replicated table's rank-0 copy (the others equal it,
    bit for bit)."""
    place = _placement(ranks[0])
    out = {}
    for t, p in place.items():
        if p == "replicated":
            for r in ranks[1:]:
                np.testing.assert_array_equal(r[f"keys/{t}"],
                                              ranks[0][f"keys/{t}"])
                np.testing.assert_array_equal(r[f"values/{t}"],
                                              ranks[0][f"values/{t}"])
            parts = ranks[:1]
        else:
            parts = ranks
        keys = np.concatenate([r[f"keys/{t}"] for r in parts])
        vals = np.concatenate([r[f"values/{t}"] for r in parts])
        assert np.unique(keys).size == keys.size, t
        out[t] = dict(zip(keys.tolist(), vals))
    return out


def _assert_tables_equal(got: dict, want: dict, tol=TOL):
    assert set(got) == set(want)
    for t in want:
        assert set(got[t]) == set(want[t]), t
        keys = sorted(want[t])
        np.testing.assert_allclose(np.stack([got[t][k] for k in keys]),
                                   np.stack([want[t][k] for k in keys]),
                                   **tol, err_msg=t)


def _tables_of(group, states):
    arrs = mc.table_arrays(group, states)
    return {t: dict(zip(arrs[f"keys/{t}"].tolist(), arrs[f"values/{t}"]))
            for t in group.tables}


def _single_eval(group, afn, ts):
    raw = mc.global_batches(1, 1)[0]
    return tloop.make_eval_step(group, afn)(
        ts, group.pack_batch_np(raw, "cpu")).numpy()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-device run (saved), a JAX checkpoint at S = 2, and one
    launch of 4 ranks: the S = 4 run, then on ranks 0 and 1 the S = 2
    run (saved) and the S = 2 restores of the JAX checkpoint and of the
    one-device save."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    group, model, afn, loss_fn, sopt, dopt = mc.wdl_parts()
    ts = tloop.create_train_state(group, model.state_dict(), dopt, sopt,
                                  "cpu")
    step = tloop.make_train_step(group, afn, loss_fn, sopt, dopt,
                                 micro_batch_num=MICRO)
    losses = []
    for raw in mc.global_batches(STEPS):
        ts, m = step(ts, group.pack_batch_np(raw, "cpu"))
        losses.append(float(m["loss"]))
        assert int(m["n_overflow"]) == 0
    single = dict(loss=np.array(losses), tables=_tables_of(group, ts.ev),
                  logits=_single_eval(group, afn, ts),
                  ckpt=str(tmp / "single"))
    tckpt.CheckpointManager(single["ckpt"], group).save(ts)
    jax_dir = _jax_checkpoint(str(tmp / "jax_s2"), model.state_dict())
    mc.launch("mesh_suite", 4, tmp, steps=STEPS, micro=MICRO,
              ckpt_s2=str(tmp / "ckpt_s2"),
              restore=[jax_dir, single["ckpt"]])
    res = [mc.result("mesh_suite", tmp, r) for r in range(4)]
    return {"single": single, "tmp": tmp, "jax": jax_dir,
            4: [mc.split_prefix(r, "s4/") for r in res],
            2: [mc.split_prefix(r, "s2/") for r in res[:2]],
            "restore": [mc.split_prefix(r, "restore/") for r in res[:2]]}


@pytest.mark.parametrize("S", [2, 4])
def test_mesh_training_matches_one_device(runs, S):
    single, ranks = runs["single"], runs[S]
    assert set(_placement(ranks[0]).values()) == {"sharded", "replicated"}
    for r in ranks:
        np.testing.assert_allclose(r["loss"], single["loss"],
                                   rtol=LOSS_RTOL)
        assert not r["n_overflow"].any()
    _assert_tables_equal(_merged_tables(ranks), single["tables"])


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_eval_matches_one_device(runs, S):
    logits = np.concatenate([r["logits"] for r in runs[S]])
    np.testing.assert_allclose(logits, runs["single"]["logits"], **TOL)


def test_checkpoint_s2_restores_at_s1(runs):
    group, model, afn, _, sopt, dopt = mc.wdl_parts()
    tmpl = tloop.create_train_state(group, model.state_dict(), dopt, sopt,
                                    "cpu")
    mgr = tckpt.CheckpointManager(str(runs["tmp"] / "ckpt_s2"), group)
    with open(os.path.join(mgr.dir, f"full-{STEPS}", "meta.json")) as f:
        meta = f.read()
    assert '"num_shards": 2' in meta
    ts = mgr.restore(tmpl)
    assert int(ts.step) == STEPS
    _assert_tables_equal(_tables_of(group, ts.ev), _merged_tables(runs[2]),
                         tol=dict(rtol=0, atol=0))
    np.testing.assert_allclose(
        _single_eval(group, afn, ts),
        np.concatenate([r["logits"] for r in runs[2]]), **TOL)


# -- across the packages --------------------------------------------------------

def _jax_groups():
    cols = jwdl.criteo_columns(embedding_dim=mc.DIM, capacity=mc.CAPACITY)
    mesh_group = JGroup(cols, coalesce=True, axis_name="data", num_shards=2,
                        placement="auto",
                        replicate_threshold=mc.REPLICATE_THRESHOLD)
    return mesh_group, JGroup(cols, coalesce=True)


def _jax_state(group, port_params):
    params = jax.tree.map(jnp.asarray, convert.params_to_numpy(port_params))
    return jloop.create_train_state(group, params, optax.adagrad(mc.LR),
                                    jsopt.SparseAdagrad(mc.LR))


@pytest.fixture(scope="module")
def jax_eval_s1():
    """``fn(ckpt_dir, port_params)``: the JAX package's eval logits of the
    held-out batch from ``ckpt_dir`` restored on one device (its eval
    step jitted once)."""
    _, single = _jax_groups()
    step = jloop.make_eval_step(single, jwdl.apply_fn(
        jwdl.WDL(hidden=mc.HIDDEN), single))
    raw = mc.global_batches(1, 1)[0]

    def fn(ckpt_dir, port_params):
        tmpl = _jax_state(single, port_params)
        ts = jckpt.CheckpointManager(ckpt_dir, single).restore(tmpl)
        return np.asarray(step(ts, single.pack_batch_np(raw)))

    return fn


def _jax_checkpoint(d, port_params):
    """A JAX checkpoint at S = 2: one sharded lookup of the stream's first
    batch under shard_map fills the tables, then a save."""
    group, _ = _jax_groups()
    ts = _jax_state(group, port_params)
    batch = group.pack_batch_np(mc.global_batches(1)[0])
    specs = {t: jax.tree.map(
        lambda _, t=t: P("data") if group._is_stacked(t) else P(), st)
        for t, st in ts.ev.items()}

    def lookup(states, b):
        return group.lookup_train(states, b, 0)[0]

    ev = jax.jit(jax.shard_map(
        lookup, mesh=data_mesh(2),
        in_specs=(specs, jax.tree.map(lambda _: P("data"), batch)),
        out_specs=specs), compiler_options={
            "xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True})(ts.ev, batch)
    jckpt.CheckpointManager(d, group).save(ts.replace(ev=ev,
                                                      step=jnp.int32(1)))
    return d


def test_jax_s2_checkpoint_restores_in_the_port(runs, jax_eval_s1):
    """At S = 1 here and at S = 2 on the spawned ranks; the one-device
    run's save at S = 2 as well."""
    d = runs["jax"]
    group, model, afn, _, sopt, dopt = mc.wdl_parts()
    jax_logits = jax_eval_s1(d, model.state_dict())
    tmpl = tloop.create_train_state(group, model.state_dict(), dopt, sopt,
                                    "cpu")
    ts = tckpt.CheckpointManager(d, group).restore(tmpl)
    np.testing.assert_allclose(_single_eval(group, afn, ts), jax_logits,
                               **TOL)
    ranks = runs["restore"]
    np.testing.assert_allclose(
        np.concatenate([r["logits/0"] for r in ranks]), jax_logits, **TOL)
    np.testing.assert_allclose(
        np.concatenate([r["logits/1"] for r in ranks]),
        runs["single"]["logits"], **TOL)
    assert [int(r["step/1"]) for r in ranks] == [STEPS, STEPS]
    # The restored shards hold exactly the JAX shards' keys.
    jg, _ = _jax_groups()
    for t in jg.tables:
        if not jg._is_stacked(t):
            continue
        for s in range(2):
            with np.load(os.path.join(d, "full-1",
                                      f"table-{t}-s{s}.npz")) as z:
                want = np.sort(z["keys"])
            np.testing.assert_array_equal(np.sort(ranks[s][f"keys0/{t}"]),
                                          want)


def test_port_s2_checkpoint_restores_in_jax(runs, jax_eval_s1):
    _, model, _, _, _, _ = mc.wdl_parts()
    got = jax_eval_s1(str(runs["tmp"] / "ckpt_s2"), model.state_dict())
    np.testing.assert_allclose(
        got, np.concatenate([r["logits"] for r in runs[2]]), **TOL)


def test_partition_import_covers_every_key(runs):
    """Restoring the S = 2 save at S = 4 partitions every key once."""
    group, _, _, _, _, _ = mc.wdl_parts(4)
    d = str(runs["tmp"] / "ckpt_s2")
    seen = {t: [] for t in group.tables}
    for t, cfg in group.tables.items():
        merged = {}
        for s in range(2):
            fn = os.path.join(d, f"full-{STEPS}", f"table-{t}-s{s}.npz")
            if os.path.exists(fn):
                with np.load(fn) as z:
                    for k in ("keys", "values", "freqs", "versions"):
                        merged.setdefault(k, []).append(z[k])
        merged = {k: np.concatenate(v) for k, v in merged.items()}
        n = 4 if group._is_stacked(t) else 1
        for pid in range(n):
            st = tev.import_arrays(cfg, tev.create(cfg, "cpu"), merged,
                                   partition_id=pid, partition_num=n)
            seen[t].append(tev.export_arrays(cfg, st)["keys"])
        keys = np.concatenate(seen[t])
        np.testing.assert_array_equal(np.sort(keys), np.sort(merged["keys"]))
