"""Exchange bytes of the port's sharded training step, and a scaling model.

The port's counterpart of ``tools/scaling_model.py``. Every byte a rank
sends in a sharded training step is fixed by the group's configuration
and the local batch, because ``embedding/sharded.py`` sizes each
exchange on the host (``per_peer_slots``); this tool counts them, a
rank and a step, as ``Mesh.trace`` records them (each collective's
input, this rank's share included):

* a row-sharded EV table: one all-to-all of ``[S*K, 3]`` int32 ids
  (hi, lo, count), one way, with ``K = per_peer(n, S)`` for the
  ``n = B_local * width`` occurrences; then ``[S*K, dim]`` float32 rows
  back, and their gradient the same size back again (the exchange's
  backward). The JAX tool counts the ids both ways
  (``tools/scaling_model.py:119``); the port sends them once, as the
  owner answers with rows;
* a row-sharded static table: one ``[S*K]`` int32 plane of slots, with
  ``K = per_peer(U + 1, S)`` for the table's unique budget ``U`` (the
  padding sentinel is the ``+ 1``), then rows and gradient as above;
* a replicated table: an all-gather of the rank's ``[n, 3]`` ids
  (static: its ``[U + 1]`` slots), and its union rows' gradient,
  ``[S*n, dim]`` (static: ``[S*(U + 1), dim]``) float32, in the dense
  all-reduce;
* the dense all-reduce: every dense param's gradient (float32) and the
  replicated tables' row gradients, one call a dtype, then the loss and
  ``n_overflow`` as two float64, 16 bytes.

At S = 1 the headline's tables send 587,464,704 bytes of all-to-all a
step: ids 262,144 x 12 + 589,824 x 12 and rows 2 x (262,144 x 129 +
589,824 x 65) x 4.

The model: t_step(S) = t_compute + t_link, t_compute the median of
``T_COMPUTE_RUNS`` timings of the port's ``bench.py`` headline step on
the card (``bench.bench_device``, each on a fresh trainer; the runs and
their spread are written beside it), t_link the bytes that leave the
rank (an all-to-all's (S-1)/S, a ring all-reduce's 2(S-1)/S) over
``--link_gbps``, an assumption: one card gives no link to time. No
overlap of exchange and compute is assumed. The fields that follow from
the assumed link carry ``modelled_`` in their names, and each row states
the assumption.

``--anchor``: the S = 1 NCCL sharded headline step and the unsharded
step on the same global batches, timed between CUDA events; the
trace's all-to-all and all-reduce bytes of one sharded step against the
model's. It fails if they differ.

Usage: python3 tools/scaling_model_torch.py [--anchor] [--link_gbps GBPS]
           [--out FILE]
It runs on the card and fails without one. It writes
``SCALING_H100.json`` at the repository root (or ``--out``), with the
card's name and power limit: the headline's rows at S in ``SHARDS``
(bytes, modelled time), the static row's bytes, and with ``--anchor``
the anchor.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BATCH_PER_RANK = 16384  # bench.BATCH
CF = 2.0                # sharded.bag_lookup_train's capacity_factor
LOSS_BYTES = 16         # the loss and n_overflow, two float64
# An assumed per-rank link rate, GB/s: NVLink 4 on an H100 SXM is 450
# GB/s each way; a third of it is a conservative effective all-to-all
# rate. A flag, printed with every result, not a measurement.
LINK_GBPS = 150.0
ANCHOR_STEPS = 5        # timed steps of each anchor run (one traced)
SHARDS = (1, 2, 4, 8)   # the rows: one card, and a host's 2, 4, 8 cards
# Timings of the headline step whose median is t_compute: one run gives
# one reading, and readings of separate calls have differed by ~2x.
T_COMPUTE_RUNS = 5


def per_peer(n: int, S: int) -> int:
    """``sharded.per_peer_slots(n, S, CF)``: slots a peer, a multiple
    of 8."""
    K = max(8, int(-(-n * CF // S)))
    return -(-K // 8) * 8


def tables_of(group, b_local: int) -> list:
    """Per physical table of ``group`` (a mesh group, or a plain one,
    read as every table sharded), its columns one id a row each (the
    Criteo columns): ``name``, ``placement``, ``static``, ``dim``, ``n``
    (occurrences a rank and step) and ``budget`` (the unique budget,
    None for U = n)."""
    out = []
    for t, cols in group._columns_by_table().items():
        cfg = group.tables[t]
        if cfg.adaptive_hot_threshold is not None:
            raise ValueError(f"table {t}: the byte model counts EV and "
                             f"static tables, not adaptive ones")
        ws = [1] * len(cols)
        n = b_local * len(cols)
        out.append({
            "name": t, "dim": cfg.dim, "n": n,
            "static": bool(cfg.static_buckets),
            "placement": (group.placement.get(t, "sharded")
                          if group.axis_name is not None else "sharded"),
            "budget": group._unique_budget(cols, ws, (b_local, sum(ws)))})
    return out


def dense_bytes(params) -> int:
    """Bytes of the dense gradients: a state dict's floating params."""
    return sum(p.numel() * p.element_size() for p in params.values()
               if p.is_floating_point())


def step_bytes(tables, S: int, dense: int) -> dict:
    """Bytes this rank sends a step, by collective kind (``Mesh.trace``'s
    ``kind``), and the all-to-all's ids and rows apart."""
    ids = rows = gather = rep_grads = 0
    for t in tables:
        dim = t["dim"]
        u1 = (min(t["budget"], t["n"]) if t["budget"] is not None
              else t["n"]) + 1
        if t["placement"] == "replicated":
            gather += u1 * 4 if t["static"] else t["n"] * 3 * 4
            rep_grads += S * (u1 if t["static"] else t["n"]) * dim * 4
            continue
        if t["static"]:
            K = per_peer(u1, S)
            ids += S * K * 4
        else:
            K = per_peer(t["n"], S)
            ids += S * K * 3 * 4
        rows += 2 * S * K * dim * 4
    return {"all_to_all": ids + rows, "ids": ids, "rows": rows,
            "all_gather": gather,
            "all_reduce": dense + rep_grads + LOSS_BYTES}


def _headline_group(S: int, static: bool):
    """The ``bench.py`` headline (or static row) group at S shards,
    every table sharded (the default placement), and its towers on the
    meta device: no table or weight is built."""
    import torch

    from deeprec_tpu_torch import config as cfglib
    from deeprec_tpu_torch.feature_column.feature_column import (
        EmbeddingGroup)
    from deeprec_tpu_torch.models import wdl

    evo = cfglib.EmbeddingVariableOption(record_freq=False,
                                         record_version=False)
    cols = wdl.criteo_columns(embedding_dim=16, capacity=1 << 20,
                              reference_shapes=True, wide_in_deep=True,
                              ev_option=evo, static_buckets=static)
    group = EmbeddingGroup(cols, coalesce=True, axis_name="data",
                           num_shards=S)
    model = wdl.WDL(wdl.input_width(group), hidden=(1024, 512, 256),
                    dtype=torch.bfloat16, device="meta")
    return group, model.state_dict()


def wdl_tables(S: int, static: bool = False) -> list:
    """:func:`tables_of` the ``bench.py`` headline (static: the static
    row) at S shards, B = 16,384 a rank."""
    group, _ = _headline_group(S, static)
    return tables_of(group, BATCH_PER_RANK)


def model(S: int, static: bool = False, t_compute_ms=None,
          link_gbps: float = LINK_GBPS) -> dict:
    """The headline's (static row's) bytes a rank and step at S shards;
    with ``t_compute_ms``, the ``modelled_`` link time, weak-scaling
    efficiency and samples/s at ``link_gbps``, an assumption the row
    states."""
    group, params = _headline_group(S, static)
    b = step_bytes(tables_of(group, BATCH_PER_RANK), S,
                   dense_bytes(params))
    out = {"row": "static" if static else "headline", "shards": S,
           "bytes_per_rank_step": b}
    if t_compute_ms is not None:
        off = (S - 1) / S
        link = (b["all_to_all"] + b["all_gather"]) * off \
            + b["all_reduce"] * 2 * off
        t_link = link / (link_gbps * 1e9) * 1e3
        out.update(offchip_bytes=int(link), t_compute_ms=t_compute_ms,
                   link_gbps_assumed=link_gbps,
                   assumption=f"modelled: a link of {link_gbps} GB/s a "
                              f"rank, assumed, not measured; no overlap of "
                              f"exchange and compute",
                   modelled_t_link_ms=t_link,
                   modelled_weak_scaling_efficiency=t_compute_ms
                   / (t_compute_ms + t_link),
                   modelled_samples_per_s=S * BATCH_PER_RANK
                   / ((t_compute_ms + t_link) / 1e3))
    return out


def t_compute() -> dict:
    """The headline step's ms: the median of ``T_COMPUTE_RUNS`` runs of
    ``bench.bench_device``, each on a fresh trainer, with the runs and
    their spread (the largest over the least)."""
    import statistics

    import torch

    from deeprec_tpu_torch import bench
    runs = []
    for _ in range(T_COMPUTE_RUNS):
        tr = bench.build_wdl()
        runs.append(bench.bench_device(tr)["step_ms"])
        del tr
        torch.cuda.empty_cache()
    return {"t_compute_ms": statistics.median(runs),
            "t_compute_runs_ms": runs,
            "t_compute_spread": max(runs) / min(runs)}


def _step_ms(tr, batches) -> list:
    import torch
    ms = []
    for b in batches:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        tr.ts, m = tr.step(tr.ts, b)
        ev[1].record()
        ev[1].synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
        if int(m["n_overflow"]):
            raise AssertionError(f"n_overflow {int(m['n_overflow'])}")
    return ms


def anchor_run(mesh) -> dict:
    """On ``mesh`` (NCCL): the sharded ``bench.py`` headline and the
    unsharded one on the same global batches, ``ANCHOR_STEPS`` steps
    each (the ms between CUDA events of each step), the bytes of the
    sharded run's last step by collective kind from ``Mesh.trace``, and
    the model's bytes; raises if the all-to-all or all-reduce bytes
    differ from the model's."""
    import torch

    from deeprec_tpu_torch import bench
    S = mesh.size
    tr = bench.build_wdl(device=mesh.device, mesh=mesh)
    sharded = [tr.next_batch() for _ in range(ANCHOR_STEPS)]
    ms = _step_ms(tr, sharded[:-1])
    mesh.trace = []
    ms += _step_ms(tr, sharded[-1:])
    traced = {}
    for rec in mesh.trace:
        traced[rec["kind"]] = traced.get(rec["kind"], 0) + rec["bytes"]
    mesh.trace = None
    want = step_bytes(tables_of(tr.group, BATCH_PER_RANK), S,
                      dense_bytes(tr.ts.params))
    del tr
    torch.cuda.empty_cache()
    ref = bench.build_wdl(device=mesh.device, batch=BATCH_PER_RANK * S)
    ref_ms = _step_ms(ref, [ref.next_batch()
                                   for _ in range(ANCHOR_STEPS)])
    del ref
    torch.cuda.empty_cache()
    out = {"row": "headline", "shards": S, "sharded_step_ms": ms,
           "unsharded_step_ms": ref_ms, "traced_bytes": traced,
           "model_bytes": want}
    for kind in ("all_to_all", "all_reduce", "all_gather"):
        if traced.get(kind, 0) != want[kind]:
            raise AssertionError(
                f"anchor: {kind} bytes traced {traced.get(kind, 0)} "
                f"!= the model's {want[kind]}")
    return out


def anchor() -> dict:
    """:func:`anchor_run` on a one-rank NCCL group of this process."""
    import torch
    import torch.distributed as dist

    from deeprec_tpu_torch.parallel import mesh as meshlib
    from deeprec_tpu_torch.parallel import multihost
    if not torch.cuda.is_available():
        raise RuntimeError("--anchor needs a CUDA card")
    with tempfile.TemporaryDirectory(prefix="scaling_anchor_") as d:
        multihost.initialize(backend="nccl", rank=0, world_size=1,
                             init_method="file://" + os.path.join(d, "s"))
        try:
            return anchor_run(meshlib.data_mesh(1))
        finally:
            dist.destroy_process_group()


def main(argv=None) -> dict:
    import torch

    from model_benchmark_torch import card_facts
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--anchor", action="store_true")
    ap.add_argument("--link_gbps", type=float, default=LINK_GBPS,
                    help="assumed per-rank link rate, GB/s")
    ap.add_argument("--out", default=os.path.join(ROOT,
                                                  "SCALING_H100.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("scaling_model_torch.py runs on a CUDA card")
    tc = t_compute()
    t = tc["t_compute_ms"]
    out = {"card": card_facts(torch.device("cuda", 0)), **tc,
           "t_compute_source": f"the median of {T_COMPUTE_RUNS} runs of "
                               f"deeprec_tpu_torch.bench.bench_device in "
                               f"this call",
           "link_gbps_assumed": args.link_gbps,
           "rows": [model(S, False, t, args.link_gbps) for S in SHARDS],
           "static_rows": [model(S, True) for S in SHARDS]}
    if args.anchor:
        out["anchor"] = anchor()
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
