"""Port parity: ``embedding/sharded.py`` against the JAX package.

The routing functions (``_dest_of``, ``_route_ids``, ``_fill_send``,
``per_peer_slots``, ``_static_local_uniques``) and ``keys.shard_of_np``
run in this process on seeded numpy inputs and must equal the JAX ones
bit for bit, a forced overflow's count included; so must a static
table's shard (``create_shard``, within the row-init tolerance below)
and the partitioned ``import_arrays``.

Then every placement kind of ``tests/torch_mesh_cases.KINDS`` (EV,
static, replicated, replicated static) trains two steps at S = 2: the
JAX functions under
``jax.shard_map`` on ``data_mesh(2)``, the port's in two spawned gloo
ranks, from the same initial shards (``convert.shard_of_stacked``).
Each rank's integer state must equal the JAX shard's bit for bit: the
table's key rows, freqs and versions, and each step's ``slots``,
``is_new``, ``dest``, ``owner_inverse``, ``counts``, ``n_overflow``
and ``union_of_local``. ``ShardedBagLookup.counts`` has shape
``[S*K]`` on every path: the JAX static lookup leaves it at its
default, a 0-d zero (a fault of the reference, ``sharded.py:91``), and
the port's static lookup sets ``[S*K]`` zeros (it updates no freqs).
Losses, rows and accumulators agree within rtol 1e-4, atol 1e-6
(float32 sums in another order), as ``tests/test_sharded_embedding.py``
holds the mesh to one device; so do the port's sharded inference
embeddings of the last batch (``bag_lookup_infer``,
``lookup_rows_infer_static``) with the bag sums of the JAX shards'
final rows.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_mesh_cases as mc
from deeprec_tpu import config as jcfg
from deeprec_tpu.embedding import lookup as jlkup
from deeprec_tpu.embedding import sharded as jsh
from deeprec_tpu.embedding import variable as jev
from deeprec_tpu.optimizers import sparse as jsopt
from deeprec_tpu.parallel.mesh import data_mesh
from deeprec_tpu.utils import keys as jkeys
from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import convert
from deeprec_tpu_torch.embedding import lookup as tlkup
from deeprec_tpu_torch.embedding import sharded as tsh
from deeprec_tpu_torch.embedding import variable as tev
from deeprec_tpu_torch.utils import keys as tkeys

torch.set_num_threads(1)

S = 2
TOL = dict(rtol=1e-4, atol=1e-6)
INIT_TOL = dict(rtol=1e-5, atol=1e-6)  # row draws: another libm


def _ids(rng, n, vocab=40, pad=0.2):
    ids = rng.integers(0, vocab, size=n).astype(np.int64)
    ids[rng.random(n) < pad] = jkeys.EMPTY_ID
    return ids


# -- routing functions, in process --------------------------------------------

@pytest.mark.parametrize("S_,K", [(4, 8), (3, 16), (1, 8), (8, 8)])
def test_dest_of_bit_exact(S_, K):
    rng = np.random.default_rng(S_ * 100 + K)
    owner = rng.integers(0, S_ + 1, size=200).astype(np.int32)
    jd, jo = jsh._dest_of(jnp.asarray(owner), S_, K)
    td, to = tsh._dest_of(torch.from_numpy(owner), S_, K)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert int(to) == int(jo)
    if K * S_ < 200 * S_ / (S_ + 1):
        assert int(jo) > 0  # the small K overflows


def test_route_ids_and_fill_send_bit_exact():
    rng = np.random.default_rng(1)
    hi, lo = jkeys.split_ids(_ids(rng, 96, vocab=500))
    jdd = jlkup.dedup(jnp.asarray(hi), jnp.asarray(lo))
    tdd = tlkup.dedup(torch.from_numpy(hi), torch.from_numpy(lo))
    np.testing.assert_array_equal(tdd.uhi.numpy(), np.asarray(jdd.uhi))
    for S_, K in [(3, 8), (2, 64)]:
        jd, jo = jsh._route_ids(jdd.uhi, jdd.ulo, S_, K)
        td, to = tsh._route_ids(tdd.uhi, tdd.ulo, S_, K)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        assert int(to) == int(jo)
        for payload, fill in [(jdd.ulo, jkeys.EMPTY_LO), (jdd.counts, 0),
                              (jdd.uhi, jkeys.EMPTY_HI)]:
            want = jsh._fill_send(jd, payload, fill, S_, K)
            got = tsh._fill_send(td, torch.from_numpy(np.asarray(payload)),
                                 fill, S_, K)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(jsh._route_ids(jdd.uhi, jdd.ulo, 3, 8)[1]) > 0


def test_per_peer_slots_equal():
    for n in (1, 7, 64, 1000, 16384 * 26):
        for S_ in (1, 2, 3, 4, 8):
            for cf in (0.25, 1.0, 2.0, 3.5):
                assert (tsh.per_peer_slots(n, S_, cf)
                        == jsh.per_peer_slots(n, S_, cf))


@pytest.mark.parametrize("budget", [None, 10, 1000])
def test_static_local_uniques_bit_exact(budget):
    rng = np.random.default_rng(5)
    N = 50
    slots = rng.integers(0, N, size=120).astype(np.int32)
    hi = np.zeros(120, np.int32)
    pad = rng.random(120) < 0.2
    hi[pad], slots[pad] = jkeys.EMPTY_HI, jkeys.EMPTY_LO
    ju, ji, jo = jsh._static_local_uniques(jnp.asarray(hi),
                                           jnp.asarray(slots), N, budget)
    tu, ti, to = tsh._static_local_uniques(torch.from_numpy(hi),
                                           torch.from_numpy(slots), N,
                                           budget)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert int(to) == int(jo)
    if budget == 10:
        assert int(jo) > 0


@pytest.mark.parametrize("num_shards", [1, 2, 3, 8, 1000])
def test_shard_of_np_bit_exact(num_shards):
    rng = np.random.default_rng(num_shards)
    ids = rng.integers(-(2**62), 2**62, size=3000, dtype=np.int64)
    got = tkeys.shard_of_np(ids, num_shards)
    np.testing.assert_array_equal(got, jkeys.shard_of_np(ids, num_shards))
    hi, lo = tkeys.split_ids(ids)
    np.testing.assert_array_equal(got, tkeys.shard_of(
        torch.from_numpy(hi), torch.from_numpy(lo), num_shards).numpy())


def test_static_shard_draws_as_the_jax_stack():
    jc = jcfg.TableConfig(name="s", dim=5, capacity=24, static_buckets=True)
    tc = tcfg.TableConfig(name="s", dim=5, capacity=24, static_buckets=True)
    stacked = jsh.create_stacked(jc, 3, salt=2)
    for s in range(3):
        shard = tsh.create_shard(tc, "cpu", s, 3, salt=2)
        np.testing.assert_allclose(shard.values.numpy(),
                                   np.asarray(stacked.values[s]), **INIT_TOL)


def test_partitioned_import_keeps_the_partition():
    """``import_arrays(partition_id, partition_num)``: restore-time
    re-sharding. Partition p of an EV import holds exactly the keys the
    JAX package's ``shard_of_np`` gives p, in the slots an unpartitioned
    import of just those keys gives them; a static import keeps the
    global rows ``g % S == p`` at local row ``g // S``, as the JAX
    package's does."""
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(0, 10**9, size=300)).astype(np.int64)
    arrays = {"keys": keys,
              "values": rng.normal(size=(keys.size, 4)).astype(np.float32),
              "freqs": rng.integers(0, 9, keys.size).astype(np.int32),
              "versions": rng.integers(0, 9, keys.size).astype(np.int32)}
    tc = tcfg.TableConfig(name="e", dim=4, capacity=256)
    owner = jkeys.shard_of_np(keys, 3)
    for pid in range(3):
        got = tev.import_arrays(tc, tev.create(tc, "cpu"), arrays,
                                partition_id=pid, partition_num=3)
        want = tev.import_arrays(tc, tev.create(tc, "cpu"), {
            k: v[owner == pid] for k, v in arrays.items()})
        for f in ("values", "freqs", "versions"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          getattr(want, f).numpy())
        np.testing.assert_array_equal(got.table.key_rows.numpy(),
                                      want.table.key_rows.numpy())
        assert int(tev.num_live(got)) == int((owner == pid).sum())
    sarr = {"keys": np.arange(50, dtype=np.int64),
            "values": rng.normal(size=(50, 4)).astype(np.float32),
            "freqs": np.zeros(50, np.int32),
            "versions": np.zeros(50, np.int32)}
    jc = jcfg.TableConfig(name="s", dim=4, capacity=17, static_buckets=True)
    tc = tcfg.TableConfig(name="s", dim=4, capacity=17, static_buckets=True)
    for pid in range(3):
        js = jev.import_arrays(jc, jev.create(jc), sarr, partition_id=pid,
                               partition_num=3)
        ts = tev.import_arrays(tc, tev.create(tc, "cpu"), sarr,
                               partition_id=pid, partition_num=3)
        np.testing.assert_array_equal(ts.values.numpy(),
                                      np.asarray(js.values))


# -- every placement kind at S = 2, JAX under shard_map vs gloo ranks ---------

def _ev_numpy(st):
    return {"key_rows": np.asarray(st.table.key_rows),
            "values": np.asarray(st.values), "freqs": np.asarray(st.freqs),
            "versions": np.asarray(st.versions),
            "default_bank": np.asarray(st.default_bank),
            "bloom": np.asarray(st.bloom)}


def _jax_step(kind, cfg, opt, mesh):
    """One shard_mapped training step of ``kind``: lookup, loss, row
    gradients, apply."""
    k = mc.KINDS[kind]
    ax = "data"
    st_spec = P(ax) if k["sharded"] else P()

    def body(state, slots, hi, lo, tgt, gs):
        if k["sharded"]:
            state = jsh.local_of(state)
            slots = jax.tree.map(lambda x: x[0], slots)
            fn = (jsh.bag_lookup_train_static if k["static"]
                  else jsh.bag_lookup_train)
            state, sbl = fn(cfg, state, hi, lo, gs, axis_name=ax)
            lk, r = sbl.lk, sbl.routing
            info = {"dest": r.dest, "owner_inverse": r.owner_inverse,
                    "n_overflow": r.n_overflow[None]}
            if not k["static"]:
                info["counts"] = sbl.counts
            emb_of = lambda rows: jsh.combine(rows, sbl, "sum", axis_name=ax)
        else:
            fn = (jsh.bag_lookup_train_replicated_static if k["static"]
                  else jsh.bag_lookup_train_replicated)
            state, (lk, r) = fn(cfg, state, hi, lo, gs, axis_name=ax)
            info = {"union_of_local": r.union_of_local}
            emb_of = lambda rows: jsh.combine_replicated(rows, r, "sum")
        shared = {"slots": lk.slots, "is_new": lk.is_new}

        def loss_fn(rows):
            return jnp.sum((jnp.sum(emb_of(rows), axis=1) - tgt) ** 2)

        loss, g = jax.value_and_grad(loss_fn)(lk.rows)
        slots, values = opt.apply(cfg, slots, state.values, lk, g, gs)
        state = state.replace(values=values)
        if k["sharded"]:
            info.update(shared)
            shared = {}
            state = jsh.stacked_of(state)
            slots = jax.tree.map(lambda x: x[None], slots)
        return state, slots, jax.lax.psum(loss, ax), info, shared

    # XLA's cheapest backend passes: a third of the compile time here, and
    # the integers are exact either way.
    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(st_spec, st_spec, P(ax), P(ax), P(ax), P()),
        out_specs=(st_spec, st_spec, P(), P(ax), P())),
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True})


def _jax_run(kind, mesh):
    k = mc.KINDS[kind]
    cfg = mc.kind_config(jcfg, kind)
    opt = jsopt.SparseAdagrad(mc.PARITY_LR)
    if k["sharded"]:
        state = jsh.create_stacked(cfg, S)
        slots = jax.tree.map(
            lambda x: jnp.broadcast_to(x[None], (S,) + x.shape),
            opt.init(cfg))
    else:
        state, slots = jev.create(cfg), opt.init(cfg)
    out = {"init": _ev_numpy(state), "steps": []}
    step = _jax_step(kind, cfg, opt, mesh)
    for i, (ids, target) in enumerate(mc.parity_batches(kind, S)):
        hi, lo = jkeys.split_ids(ids.reshape(-1))
        state, slots, loss, info, shared = step(
            state, slots, jnp.asarray(hi).reshape(ids.shape),
            jnp.asarray(lo).reshape(ids.shape), jnp.asarray(target),
            jnp.int32(i))
        out["steps"].append(dict(
            loss=float(loss), **{n: np.asarray(v) for n, v in info.items()},
            **{n: np.asarray(v) for n, v in shared.items()}))
    out["final"] = dict(_ev_numpy(state), accum=np.asarray(slots["accum"]))
    return out


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_parity")
    mesh = data_mesh(S)
    jax_out = {kind: _jax_run(kind, mesh) for kind in mc.KINDS}
    np.savez(tmp / "parity_inputs.npz", **{
        f"init/{kind}/{f}": v for kind, o in jax_out.items()
        for f, v in o["init"].items()})
    mc.launch("sharded_parity", S, tmp)
    ranks = [mc.result("sharded_parity", tmp, r) for r in range(S)]
    return jax_out, ranks


def _split(a, r):
    """Rank ``r``'s part of a JAX P("data") output."""
    return np.split(np.asarray(a), S)[r]


@pytest.mark.parametrize("kind", list(mc.KINDS))
def test_integer_state_bit_equal_per_shard(parity, kind):
    jax_out, ranks = parity
    k = mc.KINDS[kind]
    for r, got in enumerate(ranks):
        for i, js in enumerate(jax_out[kind]["steps"]):
            pre = f"{kind}/{i}/"
            if not k["sharded"]:
                names = ["union_of_local"]
            else:
                names = ["dest", "owner_inverse", "n_overflow", "slots",
                         "is_new"] + ([] if k["static"] else ["counts"])
            for n in names:
                np.testing.assert_array_equal(
                    got[pre + n].astype(np.int64),
                    _split(js[n], r).astype(np.int64), err_msg=pre + n)
            if not k["sharded"]:
                for n in ("slots", "is_new"):
                    np.testing.assert_array_equal(got[pre + n], js[n],
                                                  err_msg=pre + n)
            if k["sharded"]:
                # [S*K] on every path (the JAX static lookup's is 0-d).
                assert got[pre + "counts"].shape == \
                    got[pre + "owner_inverse"].shape
                if k["static"]:
                    assert not got[pre + "counts"].any()
        final = jax_out[kind]["final"]
        if not k["sharded"]:
            for f in ("key_rows", "freqs", "versions"):
                np.testing.assert_array_equal(got[f"{kind}/final/{f}"],
                                              final[f], err_msg=f"{kind} {f}")
    if k["sharded"]:
        # The ranks' shards stacked as the JAX package stacks them.
        stacked = convert.stack_shards([
            {f: got[f"{kind}/final/{f}"] for f in mc.EV_FIELDS}
            for got in ranks])
        for f in ("key_rows", "freqs", "versions"):
            np.testing.assert_array_equal(stacked[f],
                                          jax_out[kind]["final"][f],
                                          err_msg=f"{kind} {f}")


def _jax_bag_sums(kind, final, ids):
    """Bag sums of a batch's ids over the JAX shards' final rows: an EV
    id's row on the shard whose key rows hold it (zeros if none), a
    static slot's at ``values[slot % S][slot // S]``."""
    rows = np.zeros(ids.shape + (mc.PARITY_DIM,), np.float32)
    if mc.KINDS[kind]["static"]:
        real = ids != jkeys.EMPTY_ID
        rows[real] = final["values"][ids[real] % S, ids[real] // S]
        return rows.sum(axis=1)
    for s in range(S):
        kr = final["key_rows"][s].reshape(-1, 2)
        keys = jkeys.join_ids(kr[:, 0], kr[:, 1])
        slot = {int(k): i for i, k in enumerate(keys)}
        for idx, k in np.ndenumerate(ids):
            if int(k) in slot and k != jkeys.EMPTY_ID:
                rows[idx] = final["values"][s][slot[int(k)]]
    return rows.sum(axis=1)


@pytest.mark.parametrize("kind", list(mc.KINDS))
def test_losses_rows_and_infer_within_tolerance(parity, kind):
    jax_out, ranks = parity
    k = mc.KINDS[kind]
    for r, got in enumerate(ranks):
        for i, js in enumerate(jax_out[kind]["steps"]):
            np.testing.assert_allclose(float(got[f"{kind}/{i}/loss"]),
                                       js["loss"], **TOL)
        final = jax_out[kind]["final"]
        for f in ("values", "accum"):
            want = final[f] if not k["sharded"] else final[f][r]
            np.testing.assert_allclose(got[f"{kind}/final/{f}"], want,
                                       **TOL, err_msg=f"{kind} {f} {r}")
        if k["sharded"]:
            ids = mc.parity_batches(kind, S)[-1][0]
            np.testing.assert_allclose(
                got[f"{kind}/infer"],
                _split(_jax_bag_sums(kind, final, ids), r), **TOL)
