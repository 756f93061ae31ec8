"""Ranks of the mesh tests, spawned as gloo process groups on the CPU.

``launch(case, world, tmp, **kw)`` starts ``world`` processes
(``torch.multiprocessing.spawn``); rank ``r`` joins a gloo group through
``parallel.multihost.initialize`` (a ``FileStore`` under ``tmp``) and
runs ``CASES[case](mesh, tmp, **kw)``, which writes its results to
``tmp/<case>-r<r>.npz``. A rank that raises fails the launch. Shared by
``tests/test_torch_sharded.py`` and ``tests/test_torch_mesh_train.py``;
imports torch, numpy and the port only, no JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# The model of ``__graft_entry__._build``, a global batch of 64 rows.
B_GLOBAL = 64
CAPACITY = 1 << 14
DIM = 16
HIDDEN = (256, 128, 64)
VOCAB = 5000
# The graft's 26 x 16-wide deep table (coalesced: 2**19 rows, 109 MB at
# full footprint) stays sharded; its dim-1 wide table (14.7 MB) is
# replicated.
REPLICATE_THRESHOLD = 16 << 20
LR = 0.05


def launch(case: str, world: int, tmp, **kw):
    tmp = str(tmp)
    store = os.path.join(tmp, f"store-{case}-{world}")
    mp.spawn(_entry, args=(case, world, tmp, store, kw), nprocs=world,
             join=True)


def result(case: str, tmp, rank: int) -> dict:
    with np.load(os.path.join(str(tmp), f"{case}-r{rank}.npz"),
                 allow_pickle=False) as z:
        return dict(z)


def _entry(rank, case, world, tmp, store, kw):
    from deeprec_tpu_torch.parallel import mesh as meshlib
    from deeprec_tpu_torch.parallel import multihost
    torch.set_num_threads(1)
    multihost.initialize(init_method=f"file://{store}", rank=rank,
                         world_size=world, device="cpu")
    try:
        out = CASES[case](meshlib.data_mesh(world, device="cpu"), tmp, **kw)
        np.savez(os.path.join(tmp, f"{case}-r{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


# -- the WDL model at the graft's sizes --------------------------------------

def wdl_parts(num_shards=None, placement="auto"):
    """(group, model, apply_fn, loss_fn, sparse_opt, dense_opt) of the
    graft WDL; with ``num_shards``, a mesh group of that many shards."""
    from deeprec_tpu_torch.feature_column.feature_column import (
        EmbeddingGroup)
    from deeprec_tpu_torch.layers.core import init_dense
    from deeprec_tpu_torch.models import wdl
    from deeprec_tpu_torch.optimizers import dense as dense_lib
    from deeprec_tpu_torch.optimizers import sparse as sparse_lib
    from deeprec_tpu_torch.train import losses

    cols = wdl.criteo_columns(embedding_dim=DIM, capacity=CAPACITY)
    mesh_kw = ({} if num_shards is None else dict(
        axis_name="data", num_shards=num_shards, placement=placement,
        replicate_threshold=REPLICATE_THRESHOLD))
    group = EmbeddingGroup(cols, coalesce=True, **mesh_kw)
    model = wdl.WDL(wdl.input_width(group), hidden=HIDDEN,
                    dtype=torch.float32, device="cpu")
    init_dense(model, torch.Generator().manual_seed(0))
    return (group, model, wdl.apply_fn(model, group),
            lambda out, b: losses.bce_with_logits(out, b["label"]),
            sparse_lib.SparseAdagrad(LR), dense_lib.Adagrad(LR))


def global_batches(n: int, seed: int = 0):
    """``n`` raw global batches of the graft's synthetic Criteo stream."""
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    data = SyntheticCriteo(B_GLOBAL, vocab=VOCAB, seed=seed)
    return [data.next_batch_np(wide=True) for _ in range(n)]


def local_slice(raw: dict, rank: int, world: int, rows=B_GLOBAL) -> dict:
    """Rank ``rank``'s rows of a raw global batch of ``rows`` rows."""
    b = rows // world
    return {k: np.asarray(v)[rank * b:(rank + 1) * b] for k, v in raw.items()}


def table_arrays(group, states, prefix: str = "") -> dict:
    """Every table's live keys and rows (``variable.export_arrays``)."""
    from deeprec_tpu_torch.embedding import variable as ev
    out = {}
    for t, cfg in group.tables.items():
        snap = ev.export_arrays(cfg, states[t])
        out[f"{prefix}keys/{t}"] = snap["keys"]
        out[f"{prefix}values/{t}"] = snap["values"]
    return out


def train_wdl(mesh, tmp, steps: int, micro: int, ckpt=None, eval_seed=1):
    """The graft WDL on the mesh: ``steps`` steps of ``micro``
    micro-batches over the global stream, each rank on its rows; then
    the sharded eval of a held-out batch and, with ``ckpt``, a save."""
    from deeprec_tpu_torch.train import checkpoint as ckptlib
    from deeprec_tpu_torch.train import loop as trainlib
    group, model, afn, loss_fn, sopt, dopt = wdl_parts(mesh.size)
    ts = trainlib.create_train_state(group, model.state_dict(), dopt, sopt,
                                     "cpu", mesh)
    step = trainlib.make_train_step(group, afn, loss_fn, sopt, dopt,
                                    micro_batch_num=micro, mesh=mesh)
    losses, overflow = [], []
    for raw in global_batches(steps):
        ts, m = step(ts, group.pack_batch_np(
            local_slice(raw, mesh.rank, mesh.size), "cpu"))
        losses.append(float(m["loss"]))
        overflow.append(int(m["n_overflow"]))
    ev_raw = local_slice(global_batches(1, eval_seed)[0], mesh.rank,
                         mesh.size)
    logits = trainlib.make_eval_step(group, afn, mesh)(
        ts, group.pack_batch_np(ev_raw, "cpu"))
    if ckpt is not None:
        ckptlib.CheckpointManager(ckpt, group, mesh=mesh).save(ts)
    return dict(table_arrays(group, ts.ev), loss=np.array(losses),
                n_overflow=np.array(overflow), logits=logits.numpy(),
                placement=np.array(sorted(group.placement_plan().items())))


def restore_eval(mesh, tmp, ckpts, eval_seed=1):
    """Restore each checkpoint of ``ckpts`` onto the mesh and score a
    held-out batch; results under ``logits/<i>``, ``step/<i>`` and
    ``keys<i>/<table>``."""
    from deeprec_tpu_torch.train import checkpoint as ckptlib
    from deeprec_tpu_torch.train import loop as trainlib
    group, model, afn, _, sopt, dopt = wdl_parts(mesh.size)
    tmpl = trainlib.create_train_state(group, model.state_dict(), dopt,
                                       sopt, "cpu", mesh)
    ev_raw = local_slice(global_batches(1, eval_seed)[0], mesh.rank,
                         mesh.size)
    out = {}
    for i, ckpt in enumerate(ckpts):
        ts = ckptlib.CheckpointManager(ckpt, group, mesh=mesh).restore(tmpl)
        logits = trainlib.make_eval_step(group, afn, mesh)(
            ts, group.pack_batch_np(ev_raw, "cpu"))
        out.update({k.replace("keys/", f"keys{i}/"): v for k, v in
                    table_arrays(group, ts.ev).items() if "keys/" in k})
        out[f"logits/{i}"] = logits.numpy()
        out[f"step/{i}"] = np.array(int(ts.step))
    return out


# -- function-level parity of embedding/sharded.py (S = 2) -------------------

PARITY_B = 16      # global rows a step
PARITY_L = 3
PARITY_DIM = 4
PARITY_STEPS = 2
PARITY_LR = 0.3
# Per-shard capacity (a replicated table's whole capacity), placement.
KINDS = {
    "ev": dict(capacity=64, static=False, sharded=True),
    "static": dict(capacity=32, static=True, sharded=True),
    "replicated": dict(capacity=128, static=False, sharded=False),
    "replicated_static": dict(capacity=64, static=True, sharded=False),
}
EV_FIELDS = ("key_rows", "values", "freqs", "versions", "default_bank",
             "bloom")


def kind_config(cfglib, kind: str):
    """The kind's table config in ``cfglib`` (either package's
    ``config``)."""
    k = KINDS[kind]
    return cfglib.TableConfig(name="t", dim=PARITY_DIM,
                              capacity=k["capacity"],
                              initializer="truncated_normal",
                              combiner="sum", static_buckets=k["static"])


def parity_batches(kind: str, world: int = 2):
    """``[(ids int64 [B, L], target float32 [B])]`` a step: EV ids of a
    40-id vocabulary, or a static table's global slots, ~20 % padding."""
    from deeprec_tpu_torch.utils import keys as keylib
    k = KINDS[kind]
    n_ids = k["capacity"] * (world if k["sharded"] else 1) if k["static"] \
        else 40
    rng = np.random.default_rng(7)
    out = []
    for _ in range(PARITY_STEPS):
        ids = rng.integers(0, n_ids, size=(PARITY_B, PARITY_L))
        ids[rng.random((PARITY_B, PARITY_L)) < 0.2] = keylib.EMPTY_ID
        out.append((ids.astype(np.int64),
                    rng.normal(size=(PARITY_B,)).astype(np.float32)))
    return out


def sharded_parity(mesh, tmp):
    """Every kind of ``KINDS`` for ``PARITY_STEPS`` steps from the
    initial states in ``tmp/parity_inputs.npz`` (``init/<kind>/<field>``,
    a sharded kind's with a leading shard axis): lookup, bag-sum loss
    against the target, row gradients, ``SparseAdagrad``; the routing
    integers of each step, the losses, the sharded kinds' inference
    embeddings and the final state."""
    from deeprec_tpu_torch import config as cfglib
    from deeprec_tpu_torch import convert
    from deeprec_tpu_torch.embedding import lookup as lkup
    from deeprec_tpu_torch.embedding import sharded
    from deeprec_tpu_torch.optimizers import sparse as sparse_lib
    from deeprec_tpu_torch.utils import keys as keylib
    with np.load(os.path.join(tmp, "parity_inputs.npz")) as z:
        inputs = dict(z)
    r, S = mesh.rank, mesh.size
    bl = PARITY_B // S
    opt = sparse_lib.SparseAdagrad(PARITY_LR)
    out = {}
    for kind, k in KINDS.items():
        cfg = kind_config(cfglib, kind)
        init = {f: inputs[f"init/{kind}/{f}"] for f in EV_FIELDS}
        state = convert.ev_state_from_numpy(
            convert.shard_of_stacked(init, r) if k["sharded"] else init,
            "cpu")
        slots = opt.init(cfg, "cpu")
        for step, (ids, target) in enumerate(parity_batches(kind, S)):
            hi, lo = keylib.split_ids(ids[r * bl:(r + 1) * bl].reshape(-1))
            hi = torch.from_numpy(hi).reshape(bl, PARITY_L)
            lo = torch.from_numpy(lo).reshape(bl, PARITY_L)
            tgt = torch.from_numpy(target[r * bl:(r + 1) * bl])
            pre = f"{kind}/{step}/"
            if k["sharded"]:
                fn = (sharded.bag_lookup_train_static if k["static"]
                      else sharded.bag_lookup_train)
                state, sbl = fn(cfg, state, hi, lo, step, mesh=mesh)
                lk, rt = sbl.lk, sbl.routing
                out.update({pre + "dest": rt.dest.numpy(),
                            pre + "owner_inverse": rt.owner_inverse.numpy(),
                            pre + "counts": sbl.counts.numpy(),
                            pre + "n_overflow": rt.n_overflow.numpy()})
                emb_of = lambda rows: sharded.combine(  # noqa: E731
                    rows, sbl, "sum", mesh=mesh)
            else:
                fn = (sharded.bag_lookup_train_replicated_static
                      if k["static"] else sharded.bag_lookup_train_replicated)
                state, (lk, rt) = fn(cfg, state, hi, lo, step, mesh=mesh)
                out[pre + "union_of_local"] = rt.union_of_local.numpy()
                emb_of = lambda rows: sharded.combine_replicated(  # noqa
                    rows, rt, "sum")
            out.update({pre + "slots": lk.slots.numpy(),
                        pre + "is_new": lk.is_new.numpy()})
            rows = lk.rows.detach().requires_grad_()
            loss = ((emb_of(rows).sum(dim=1) - tgt) ** 2).sum()
            (g,) = torch.autograd.grad(loss, [rows])
            if not k["sharded"]:
                mesh.all_reduce_(g)
            out[pre + "loss"] = mesh.all_reduce_(loss.detach()).numpy()
            slots, state.values = opt.apply(cfg, slots, state.values, lk, g,
                                            step)
        if k["sharded"]:
            ids = parity_batches(kind, S)[-1][0][r * bl:(r + 1) * bl]
            hi, lo = (torch.from_numpy(a).reshape(bl, PARITY_L)
                      for a in keylib.split_ids(ids.reshape(-1)))
            if k["static"]:
                rows, inv, msk = sharded.lookup_rows_infer_static(
                    cfg, state, hi, lo, mesh=mesh)
                emb = lkup.combine_bags(rows, inv, msk, "sum")
            else:
                emb = sharded.bag_lookup_infer(cfg, state, hi, lo, mesh=mesh)
            out[f"{kind}/infer"] = emb.numpy()
        for f, v in convert.ev_state_to_numpy(state).items():
            out[f"{kind}/final/{f}"] = v
        out[f"{kind}/final/accum"] = slots["accum"].numpy()
    return out


def mesh_suite(mesh, tmp, steps: int, micro: int, ckpt_s2: str,
               restore: list):
    """On 4 ranks: :func:`train_wdl` at S = 4 (``s4/``), then on the
    subgroup of ranks 0 and 1, at S = 2, :func:`train_wdl` saving to
    ``ckpt_s2`` (``s2/``) and :func:`restore_eval` of ``restore``
    (``restore/``). One launch: every spawned rank costs a start-up."""
    from deeprec_tpu_torch.parallel.mesh import Mesh
    out = {"s4/" + k: v for k, v in
           train_wdl(mesh, tmp, steps, micro).items()}
    pair = dist.new_group([0, 1])
    if mesh.rank < 2:
        m2 = Mesh(pair, device="cpu")
        out.update({"s2/" + k: v for k, v in
                    train_wdl(m2, tmp, steps, micro, ckpt=ckpt_s2).items()})
        out.update({"restore/" + k: v for k, v in
                    restore_eval(m2, tmp, restore).items()})
    dist.barrier()
    return out


def split_prefix(res: dict, prefix: str) -> dict:
    """The entries of ``res`` under ``prefix``, without it."""
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


# -- table variants on the mesh (tests/test_torch_variants_mesh.py) ----------

VARIANT_LR = 0.1


def variant_columns(kind: str):
    """The port's columns of a variant model: "adaptive" (an adaptive
    bag column of width 2 beside a plain one) or "dyn_dim" (a dyn-dim
    column split into a base and a ``#hot`` sibling, beside a plain
    one). Capacities leave room for every id of the test's vocabulary
    on each shard, so no id overflows on the mesh or off it."""
    from deeprec_tpu_torch.feature_column.feature_column import (
        EmbeddingColumn)
    if kind == "adaptive":
        return [EmbeddingColumn(name="a", dim=4, capacity=1 << 7,
                                combiner="mean", adaptive_hot_threshold=2,
                                adaptive_buckets=16),
                EmbeddingColumn(name="b", dim=3, capacity=1 << 7)]
    return [EmbeddingColumn(name="f", dim=8, capacity=128, init_scale=1.0,
                            dyn_dim_blocks=4, dyn_dim_thresholds=(2, 4, 6),
                            dyn_dim_hot_capacity=64),
            EmbeddingColumn(name="g", dim=4, capacity=64)]


def variant_apply(p, embs, b):
    return torch.cat([embs[k] for k in sorted(embs)], dim=1) @ p["w"] + p["b"]


def variants(mesh, tmp, kinds, steps: int):
    """Each kind of ``kinds`` trained ``steps`` steps on the mesh from
    ``tmp/variant-<kind>.npz`` (``p/<param>``, global batches
    ``b<i>/<leaf>``, the eval batch ``b<steps>/``), each rank on its
    rows: losses, tables, eval logits; then saved to
    ``tmp/ckpt-<kind>``."""
    from deeprec_tpu_torch.feature_column.feature_column import (
        EmbeddingGroup)
    from deeprec_tpu_torch.optimizers import dense as dense_lib
    from deeprec_tpu_torch.optimizers import sparse as sparse_lib
    from deeprec_tpu_torch.train import checkpoint as ckptlib
    from deeprec_tpu_torch.train import loop as trainlib
    from deeprec_tpu_torch.train import losses
    out = {}
    for kind in kinds:
        with np.load(os.path.join(tmp, f"variant-{kind}.npz")) as z:
            arrs = dict(z)
        params = {k[2:]: torch.from_numpy(v) for k, v in arrs.items()
                  if k.startswith("p/")}
        raw = [split_prefix(arrs, f"b{i}/") for i in range(steps + 1)]
        B = raw[0]["label"].shape[0]
        group = EmbeddingGroup(variant_columns(kind), axis_name="data",
                               num_shards=mesh.size)
        sopt = sparse_lib.SparseAdagrad(VARIANT_LR)
        dopt = dense_lib.Adagrad(VARIANT_LR)
        ts = trainlib.create_train_state(group, params, dopt, sopt, "cpu",
                                         mesh)
        step = trainlib.make_train_step(
            group, variant_apply,
            lambda o, b: losses.bce_with_logits(o, b["label"]), sopt, dopt,
            mesh=mesh)
        bl = B // mesh.size

        def local(r):
            return group.pack_batch_np(
                {k: v[mesh.rank * bl:(mesh.rank + 1) * bl]
                 for k, v in r.items()}, "cpu")

        losses_ = []
        for r in raw[:steps]:
            ts, m = step(ts, local(r))
            losses_.append(float(m["loss"]))
        logits = trainlib.make_eval_step(group, variant_apply, mesh)(
            ts, local(raw[steps]))
        ckptlib.CheckpointManager(os.path.join(tmp, f"ckpt-{kind}"), group,
                                  mesh=mesh).save(ts)
        out.update({f"{kind}/" + k: v for k, v in
                    table_arrays(group, ts.ev).items()})
        out[f"{kind}/loss"] = np.array(losses_)
        out[f"{kind}/logits"] = logits.numpy()
        out.update({f"{kind}/params/{k}": v.numpy()
                    for k, v in ts.params.items()})
        out[f"{kind}/placement"] = np.array(
            sorted(group.placement_plan().items()))
    return out


# -- multi-tier storage on the mesh (tests/test_torch_multi_tier_mesh.py) ----

TIER_B = 16          # global rows a step, one id a row
TIER_CAPACITY = 128  # the table's capacity (64 a shard at S = 2)
TIER_FLOOD = 6       # batches of fresh ids between the first and its return


class DenseSGD:
    """``optax.sgd`` for the port's dense params: ``p - lr * g``."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        return {}

    def apply(self, params, grads, state):
        for k, g in grads.items():
            params[k].sub_(self.lr * g)


def tier_batches():
    """Global id vectors: ids 1..16, ``TIER_FLOOD`` batches of fresh
    ids, then ids 1..16 again."""
    first = np.arange(1, TIER_B + 1, dtype=np.int64)
    flood = [np.arange(1000 + TIER_B * s, 1000 + TIER_B * (s + 1),
                       dtype=np.int64) for s in range(TIER_FLOOD)]
    return [first] + flood + [first]


def tier_model(cfgm, fc, num_shards=None):
    """The multi-tier test model's group in either package (``cfgm``,
    ``fc``: its ``config`` and ``feature_column``): one 4-wide HBM_HOST
    column, zeros initializer, a bag of one id a row."""
    evo = cfgm.EmbeddingVariableOption(storage_option=cfgm.StorageOption(
        storage_type=cfgm.StorageType.HBM_HOST))
    cols = [fc.EmbeddingColumn(name="f", dim=4, capacity=TIER_CAPACITY,
                               initializer="zeros", combiner="sum",
                               ev_option=evo)]
    kw = ({} if num_shards is None
          else dict(axis_name="data", num_shards=num_shards))
    return fc.EmbeddingGroup(cols, **kw)


def tier_run(mesh, ckpt=None, gather=True):
    """The port's tiered model trained on :func:`tier_batches` (on a
    mesh, each rank on its rows): the first batch, the flood (demotions
    every step at watermarks 0.5 / 0.25), a save to ``ckpt`` and the
    spill store then, and the first batch's ids promoted back. Returns
    the losses, the store's export after the flood (``spill/<field>``),
    the first step's eval embeddings (``first``), the same batch's
    after the promotion (``back``) and the keys each tier held just
    before it (``before/store``, ``before/resident``). ``gather=False``
    promotes only the ids of this rank's own rows (the all-gather
    skipped), for the test that needs the gather."""
    from deeprec_tpu_torch import config as tcfg
    from deeprec_tpu_torch.embedding import hash_table as ht
    from deeprec_tpu_torch.embedding import multi_tier as mt
    from deeprec_tpu_torch.feature_column import feature_column as fc
    from deeprec_tpu_torch.optimizers import sparse as sparse_lib
    from deeprec_tpu_torch.train import checkpoint as ckptlib
    from deeprec_tpu_torch.train import loop as trainlib
    from deeprec_tpu_torch.utils import keys as keylib
    group = tier_model(tcfg, fc, None if mesh is None else mesh.size)
    sopt, dopt = sparse_lib.SparseSGD(0.5), DenseSGD(0.1)
    ts = trainlib.create_train_state(group, {"w": torch.ones(4)}, dopt,
                                     sopt, "cpu", mesh)
    step = trainlib.make_train_step(
        group, lambda p, e, b: (e["f"] * p["w"]).sum(dim=1),
        lambda out, b: (out - b["label"]) ** 2, sopt, dopt, mesh=mesh)
    embs = trainlib.make_eval_step(group, lambda p, e, b: e["f"], mesh)
    tiered = mt.TieredGroup(group, ts.slots, high_watermark=0.5,
                            low_watermark=0.25, demote_every=1, mesh=mesh)
    if not gather:
        tiered._owned_ids = lambda t, ids: ids
    r, S = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    bl = TIER_B // S

    def local(ids):
        mine = ids[r * bl:(r + 1) * bl, None]
        return {"f": fc.SparseIds.from_numpy(mine, "cpu"),
                "label": torch.ones(bl)}

    batches = tier_batches()
    out, losses = {}, []
    for i, ids in enumerate(batches[:-1]):
        b = local(ids)
        ts = tiered.pre_step(ts, b)
        ts, m = step(ts, b)
        ts = tiered.post_step(ts)
        losses.append(float(m["loss"]))
        if i == 0:
            out["first"] = embs(ts, b).numpy()
    out["loss"] = np.array(losses)
    out.update({f"spill/{k}": v for k, v in
                tiered.export_spill()["f"][r].items()})
    if ckpt is not None:
        mgr = ckptlib.CheckpointManager(ckpt, group, mesh=mesh)
        mgr.attach_tiered(tiered)
        mgr.save(ts)
    first = batches[-1]
    out["before/store"] = first[tiered.tiered["f"].host.contains_batch(
        first)]
    hi, lo = keylib.split_ids(first)
    found = ht.find(ts.ev["f"].table, torch.from_numpy(hi),
                    torch.from_numpy(lo))
    out["before/resident"] = first[found.numpy() < group.tables["f"].capacity]
    b = local(first)
    ts = tiered.pre_step(ts, b)
    out["back"] = embs(ts, b).numpy()
    out["promoted"] = np.array(tiered.stats()["f"].promoted)
    return out


def tier_restore(mesh, ckpt):
    """A fresh tiered model on ``mesh`` (None: one device) restored from
    ``ckpt`` with its spill files: the store's export (``spill/``)."""
    from deeprec_tpu_torch import config as tcfg
    from deeprec_tpu_torch.embedding import multi_tier as mt
    from deeprec_tpu_torch.feature_column import feature_column as fc
    from deeprec_tpu_torch.optimizers import sparse as sparse_lib
    from deeprec_tpu_torch.train import checkpoint as ckptlib
    from deeprec_tpu_torch.train import loop as trainlib
    group = tier_model(tcfg, fc, None if mesh is None else mesh.size)
    sopt = sparse_lib.SparseSGD(0.5)
    ts = trainlib.create_train_state(group, {"w": torch.ones(4)},
                                     DenseSGD(0.1), sopt, "cpu", mesh)
    tiered = mt.TieredGroup(group, ts.slots, mesh=mesh)
    mgr = ckptlib.CheckpointManager(ckpt, group, mesh=mesh)
    mgr.attach_tiered(tiered)
    mgr.restore(ts)
    shard = 0 if mesh is None else mesh.rank
    return {f"spill/{k}": v for k, v in
            tiered.export_spill()["f"][shard].items()}


def multi_tier(mesh, tmp, ckpt_s2: str, ckpt_s1: str):
    """:func:`tier_run` with the all-gather (``gather/``, saving to
    ``ckpt_s2``) and without it (``local/``), then
    :func:`tier_restore` of the one-device checkpoint ``ckpt_s1``
    (``restore/``)."""
    out = {"gather/" + k: v for k, v in tier_run(mesh, ckpt_s2).items()}
    out.update({"local/" + k: v for k, v in
                tier_run(mesh, gather=False).items()})
    out.update({"restore/" + k: v for k, v in
                tier_restore(mesh, ckpt_s1).items()})
    return out


# -- serving from sharded tables (S = 2) ---------------------------------------

SERVE_B = 16      # global rows of the scored batch
SERVE_DIM = 4
SERVE_STEPS = (3, 5)  # the full checkpoint's step, the delta's


def serve_columns(fc):
    """The serving test model's columns in either package (``fc``): a
    numeric ``x``, an EV bag ``a`` (sum of 2 ids), a static hash-bucket
    column ``s`` (64 buckets) and an EV column ``r``."""
    return [fc.NumericColumn("x"),
            fc.EmbeddingColumn("a", dim=SERVE_DIM, capacity=128,
                               combiner="sum"),
            fc.EmbeddingColumn("s", dim=SERVE_DIM, capacity=64,
                               static_bucket=True, num_buckets=64),
            fc.EmbeddingColumn("r", dim=SERVE_DIM, capacity=64)]


def serve_group(fc, num_shards=None):
    """The group of :func:`serve_columns`; with ``num_shards``, a mesh
    group whose ``a`` and ``s`` are row-sharded and ``r`` replicated."""
    if num_shards is None:
        return fc.EmbeddingGroup(serve_columns(fc))
    return fc.EmbeddingGroup(serve_columns(fc), axis_name="data",
                             num_shards=num_shards,
                             placement={"r": "replicated"})


def serve_raw(i: int, rows: int = SERVE_B) -> dict:
    """Raw batch ``i`` of the serving model (a label, ids and ``x``)."""
    r = np.random.default_rng(300 + i)
    return {"x": r.normal(size=rows).astype(np.float32),
            "a": r.integers(0, 60, size=(rows, 2)).astype(np.int64),
            "s": r.integers(0, 1000, size=(rows, 1)).astype(np.int64),
            "r": r.integers(0, 40, size=(rows, 1)).astype(np.int64),
            "label": (r.random(rows) < 0.5).astype(np.float32)}


def serve_apply(p, embs, b):
    """The port's apply: ``sum(concat(a, s, r) * w) + x * v``."""
    h = torch.cat([embs["a"], embs["s"], embs["r"]], dim=1)
    return (h * p["w"]).sum(dim=1) + b["x"] * p["v"]


def serve_params():
    return {"w": torch.ones(3 * SERVE_DIM), "v": torch.full((1,), 0.5)}


def serving(mesh, tmp, ckpt: str, ckpt_s2: str, redis_url: str):
    """``ServingModel(mesh=)`` of :func:`serve_group` on this rank's rows
    of ``serve_raw(99)``: restored at the full checkpoint's step of
    ``ckpt`` (``s1/``), after ``delta_update`` (``delta/``), then saved
    at S = 2 into ``ckpt_s2`` and restored from there (``s2/``);
    :meth:`ServingModel.settle` of rank-dependent steps (``settled``);
    whether ``ModelWatcher`` refused the mesh model (``watcher_refused``);
    and the state's rows published into the Redis server at
    ``redis_url`` (``publish/<table>``: the keys this rank wrote)."""
    from deeprec_tpu_torch.feature_column import feature_column as fc
    from deeprec_tpu_torch.serving.feature_store import (RedisFeatureStore,
                                                         export_sparse,
                                                         publish_sparse)
    from deeprec_tpu_torch.serving.processor import (ModelWatcher,
                                                     ServingModel)
    from deeprec_tpu_torch.train import checkpoint as ckptlib
    from deeprec_tpu_torch.train import loop as trainlib
    group = serve_group(fc, mesh.size)
    tmpl = trainlib.create_train_state(group, serve_params(),
                                       device="cpu", mesh=mesh)
    batch = group.pack_batch_np(local_slice(serve_raw(99), mesh.rank,
                                            mesh.size, SERVE_B), "cpu")
    out = {}
    model = ServingModel(group, serve_apply, tmpl, ckpt, mesh=mesh)
    out["version/s1"] = np.array(model.full_update(step=SERVE_STEPS[0]))
    out["s1/logits"] = model.predict(batch).numpy()
    out["version/delta"] = np.array(model.delta_update())
    out["delta/logits"] = model.predict(batch).numpy()
    out["version/none"] = np.array(-1 if model.delta_update() is None
                                   else 0)
    out["settled"] = np.array(model.settle(SERVE_STEPS[1] - 2 * mesh.rank))
    try:
        ModelWatcher(model)
        out["watcher_refused"] = np.array(0)
    except ValueError:
        out["watcher_refused"] = np.array(1)
    ckptlib.CheckpointManager(ckpt_s2, group, mesh=mesh).save(model._ts)
    model2 = ServingModel(group, serve_apply, tmpl, ckpt_s2, mesh=mesh)
    out["version/s2"] = np.array(model2.full_update())
    out["s2/logits"] = model2.predict(batch).numpy()
    store = RedisFeatureStore(redis_url, prefix="mesh")
    counts = publish_sparse(model._ts, group, store, mesh=mesh)
    for t, (keys, rows) in export_sparse(model._ts, group,
                                         mesh=mesh).items():
        assert counts[t] == keys.size
        out[f"publish/{t}"] = keys
    return out


# -- the epoch step on the mesh (tests/test_torch_mesh_epoch.py) -------------

def _dense_arrays(params, prefix: str) -> dict:
    return {f"{prefix}dense/{k}": v.detach().numpy()
            for k, v in params.items()}


def epoch(mesh, tmp, pool: int, n_epochs: int):
    """The graft WDL on the mesh, trained from one state twice over a
    pool of ``pool`` local batches for ``n_epochs`` epochs: by
    ``make_train_step(mesh=)`` stepped over the pool (``step/``) and by
    ``make_epoch_step(mesh=)`` (``epoch/``, with its losses ``[E, K]``
    and ``captured``)."""
    from deeprec_tpu_torch.train import loop as trainlib
    group, model, afn, loss_fn, sopt, dopt = wdl_parts(mesh.size)
    ts = trainlib.create_train_state(group, model.state_dict(), dopt, sopt,
                                     "cpu", mesh)
    batches = [group.pack_batch_np(local_slice(raw, mesh.rank, mesh.size),
                                   "cpu")
               for raw in global_batches(pool)]
    stepped = trainlib.clone_state(ts)
    step = trainlib.make_train_step(group, afn, loss_fn, sopt, dopt,
                                    mesh=mesh)
    losses, overflow = [], []
    for i in range(n_epochs * pool):
        stepped, m = step(stepped, batches[i % pool])
        losses.append(float(m["loss"]))
        overflow.append(int(m["n_overflow"]))
    run = trainlib.make_epoch_step(group, afn, loss_fn, sopt, dopt,
                                   n_epochs=n_epochs, mesh=mesh)
    ts, ep_losses = run(ts, trainlib.stack_batches(batches))
    return dict(table_arrays(group, stepped.ev, "step/"),
                **_dense_arrays(stepped.params, "step/"),
                **table_arrays(group, ts.ev, "epoch/"),
                **_dense_arrays(ts.params, "epoch/"),
                **{"step/loss": np.array(losses),
                   "step/n_overflow": np.array(overflow),
                   "step/step": np.array(stepped.step),
                   "epoch/loss": ep_losses.numpy(),
                   "epoch/step": np.array(ts.step),
                   "epoch/captured": np.array(run.last_run["captured"]),
                   "epoch/replays": np.array(run.last_run["replays"]),
                   "placement": np.array(
                       sorted(group.placement_plan().items()))})


# -- a traced step (tests/test_torch_scaling_model.py) -----------------------

def step_trace(mesh, tmp, warm: int):
    """The graft WDL on the mesh: ``warm`` steps, then one with
    ``Mesh.trace`` on; the bytes each collective kind sent and its
    calls (``bytes/<kind>``, ``calls/<kind>``), with the dense params'
    bytes and the step's placement."""
    from deeprec_tpu_torch.train import loop as trainlib
    group, model, afn, loss_fn, sopt, dopt = wdl_parts(mesh.size)
    ts = trainlib.create_train_state(group, model.state_dict(), dopt, sopt,
                                     "cpu", mesh)
    step = trainlib.make_train_step(group, afn, loss_fn, sopt, dopt,
                                    mesh=mesh)
    for i, raw in enumerate(global_batches(warm + 1)):
        if i == warm:
            mesh.trace = []
        ts, _ = step(ts, group.pack_batch_np(
            local_slice(raw, mesh.rank, mesh.size), "cpu"))
    out = {"placement": np.array(sorted(group.placement_plan().items()))}
    for rec in mesh.trace:
        for k, v in (("bytes", rec["bytes"]), ("calls", 1)):
            key = f"{k}/{rec['kind']}"
            out[key] = out.get(key, 0) + v
    mesh.trace = None
    return {k: np.asarray(v) for k, v in out.items()}


CASES = {"mesh_suite": mesh_suite, "sharded_parity": sharded_parity,
         "variants": variants, "multi_tier": multi_tier,
         "serving": serving, "epoch": epoch, "step_trace": step_trace}
