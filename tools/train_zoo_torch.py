"""Model-zoo training CLI of the PyTorch port: the counterpart of
``tools/train_zoo.py`` (the reference's ``modelzoo/<M>/train.py`` role),
one tool for every model of ``deeprec_tpu_torch/models/registry.py``:
wdl, deepfm, dlrm, din, dien, bst, dssm, esmm, mmoe, dbmtl and
simple_multitask, at the reference widths of ``COLUMN_KWARGS`` and
``MODULE_KWARGS``. Criteo models read the synthetic Criteo stream (the
multi-task ones its click/conversion variant), sequence models the
synthetic behavior stream (20,000 items, 1,000 categories, sequences
of 50).

It takes ``tools/train_zoo.py``'s flags and prints its JSON line
(``model``, ``steps``, ``batch_size``, ``backend``: the card's name or
``cpu``, ``final_loss``, ``train_s``, ``resumed_from`` after a resume,
and for single-logit models ``auc`` and ``accuracy`` after
``--eval_steps`` held-out batches):

  --ev / --filter_freq / --cbf / --steps_to_live / --l2_evict
        EmbeddingVariable options on every embedding column (CBF
        admission, eviction at checkpoint time)
  --static_bucket                static hash-bucket columns instead
  --no_emb_fusion                no table coalescing
  --interaction_op dot|cat       dlrm's interaction
  --smartstaged                  batches packed on a prefetch thread
  --bf16                         bf16 towers, fp32 params
  --checkpoint DIR --save_steps  CheckpointHook full saves (+ shrink)
  --incremental_ckpt N           delta saves between fulls
  --workqueue                    WorkQueue-driven data (each work item
                                 seeds a generator slice; the queue
                                 rides the checkpoints)
  --timeline DIR                 ProfilerHook (torch.profiler Chrome
                                 trace of steps 10-20)

Pointing ``--checkpoint`` at an earlier run's directory restores its
newest checkpoint and trains on to ``--steps``. The step log goes to
stderr. It runs on the CUDA card and fails without one; ``--cpu`` runs
on the CPU. ``--micro_batch N`` splits each step's dense forward and
backward into N micro-batches. ``--adaptive_emb`` raises
``NotImplementedError`` before a table is built.

Usage:
  python3 tools/train_zoo_torch.py wdl --steps 200 --batch_size 2048 \\
      --bf16 --ev --cbf --filter_freq 2 --steps_to_live 2000 \\
      --checkpoint /tmp/wdl_run --save_steps 100 --incremental_ckpt 25
  python3 tools/train_zoo_torch.py dien --steps 12 --batch_size 4096 --bf16
  python3 tools/train_zoo_torch.py dlrm --interaction_op cat --steps 20 \\
      --batch_size 256 --cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# tools/zoo_auc.py's settings (it imports JAX): reference Criteo shapes
# with a per-column capacity ceiling, the reference embedding widths
# (DLRM/DeepFM 16, DIN/DIEN 18, BST/DSSM 16) and towers.
COLUMN_KWARGS = {
    "wdl": dict(reference_shapes=True, capacity=1 << 18),
    "deepfm": dict(embedding_dim=16, reference_shapes=True,
                   capacity=1 << 18),
    "dlrm": dict(embedding_dim=16, reference_shapes=True,
                 capacity=1 << 18),
    "esmm": dict(embedding_dim=16, reference_shapes=True,
                 capacity=1 << 18),
    "mmoe": dict(embedding_dim=16, reference_shapes=True,
                 capacity=1 << 18),
    "dbmtl": dict(embedding_dim=16, reference_shapes=True,
                  capacity=1 << 18),
    "simple_multitask": dict(embedding_dim=16, reference_shapes=True,
                             capacity=1 << 18),
    "din": dict(embedding_dim=18, capacity=1 << 18),
    "dien": dict(embedding_dim=18, capacity=1 << 18),
    "bst": dict(embedding_dim=16, capacity=1 << 18),
    "dssm": dict(embedding_dim=16, capacity=1 << 18),
}
MODULE_KWARGS = {
    "wdl": dict(hidden=(1024, 512, 256)),
    "deepfm": dict(hidden=(1024, 512, 256)),
    "dlrm": dict(embedding_dim=16, bottom=(512, 256),
                 top=(1024, 1024, 512, 256)),
    "din": dict(hidden=(200, 80), att_hidden=(80, 40)),
    "dien": dict(gru_hidden=36, hidden=(200, 80)),
    "bst": dict(hidden=(256, 128, 64), num_blocks=1, num_heads=8),
    "dssm": dict(tower=(256, 128, 64)),
    "esmm": dict(tower=(256, 128)),
    "mmoe": dict(num_experts=4, expert=(256,), tower=(128,)),
    "dbmtl": dict(bottom=(256, 128), tower=(128,)),
    "simple_multitask": dict(tower=(256, 128)),
}
# The sequence models' stream, as tools/train_zoo.py builds it.
SEQ_DATA = dict(num_items=20_000, num_cats=1000, seq_len=50)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("model", help="zoo model name (see models/registry.py)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=2048)
    p.add_argument("--learning_rate", type=float, default=0.3,
                   help="sparse (embedding) Adagrad lr")
    p.add_argument("--dense", default="adam:2e-3",
                   help="dense-tower optimizer: adagrad | adam[:lr]")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--static_bucket", action="store_true",
                   help="reference DEFAULT column path (no --ev): "
                        "static mod-addressed hash-bucket matrices")
    p.add_argument("--ev", action="store_true",
                   help="enable EmbeddingVariable options below")
    p.add_argument("--filter_freq", type=int, default=0)
    p.add_argument("--cbf", action="store_true",
                   help="counting-Bloom admission instead of exact")
    p.add_argument("--steps_to_live", type=int, default=0)
    p.add_argument("--l2_evict", type=float, default=0.0)
    p.add_argument("--adaptive_emb", action="store_true",
                   help="adaptive embedding (not ported)")
    p.add_argument("--adaptive_threshold", type=int, default=3)
    p.add_argument("--adaptive_buckets", type=int, default=1 << 14)
    p.add_argument("--no_emb_fusion", action="store_true",
                   help="disable table coalescing")
    p.add_argument("--micro_batch", type=int, default=1)
    p.add_argument("--smartstaged", action="store_true")
    p.add_argument("--workqueue", action="store_true")
    p.add_argument("--checkpoint", default=None, help="model dir")
    p.add_argument("--save_steps", type=int, default=1000)
    p.add_argument("--incremental_ckpt", type=int, default=0,
                   help="delta-save interval (steps); 0 = off")
    p.add_argument("--timeline", default=None,
                   help="profiler trace dir (ProfilerHook)")
    p.add_argument("--eval_steps", type=int, default=10)
    p.add_argument("--log_steps", type=int, default=20)
    p.add_argument("--interaction_op", default="dot",
                   help="dlrm only: dot | cat")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def check_ported(args) -> None:
    """Exit for an unknown model; raise for what the port does not have,
    naming its ROADMAP item."""
    from deeprec_tpu_torch.models.registry import ZOO

    if args.model not in ZOO:
        raise SystemExit(f"unknown model {args.model!r}; "
                         f"choose from {sorted(ZOO)}")
    if args.adaptive_emb:
        raise NotImplementedError(
            "--adaptive_emb is not ported (ROADMAP queue 1 item 13)")


def columns(args):
    """The model's columns with the flags' EV options."""
    from deeprec_tpu_torch import config as cfglib
    from deeprec_tpu_torch.feature_column.feature_column import \
        EmbeddingColumn
    from deeprec_tpu_torch.models.registry import ZOO

    cols = ZOO[args.model].columns(**COLUMN_KWARGS[args.model])
    if args.static_bucket:
        if args.ev:
            raise SystemExit("--static_bucket excludes --ev")
        cols = [dataclasses.replace(c, static_bucket=True,
                                    num_buckets=c.num_buckets or c.capacity)
                if isinstance(c, EmbeddingColumn) else c for c in cols]
    if args.ev:
        evo = cfglib.EmbeddingVariableOption(
            filter_option=(
                cfglib.CBFFilter(filter_freq=args.filter_freq)
                if args.cbf and args.filter_freq else
                cfglib.CounterFilter(filter_freq=args.filter_freq)
                if args.filter_freq else None),
            evict_option=(
                cfglib.GlobalStepEvict(steps_to_live=args.steps_to_live)
                if args.steps_to_live else
                cfglib.L2WeightEvict(l2_weight_threshold=args.l2_evict)
                if args.l2_evict else None))
        cols = [dataclasses.replace(c, ev_option=evo)
                if isinstance(c, EmbeddingColumn) else c for c in cols]
    return cols


def device_of(args):
    """The flags' device: the CPU with ``--cpu``, else the CUDA card
    (exits when there is none)."""
    import torch

    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("train_zoo_torch: no CUDA card (torch.cuda."
                         "is_available() is false); pass --cpu")
    return torch.device("cuda")


def make_module(args, group, device):
    """The model's module for ``group`` on ``device``, uninitialized."""
    import torch

    from deeprec_tpu_torch.models.registry import ZOO

    mk = dict(MODULE_KWARGS[args.model])
    if args.model == "dlrm":
        mk["interaction_op"] = args.interaction_op
    if args.model == "bst":
        mk["seq_len"] = SEQ_DATA["seq_len"]
    return ZOO[args.model].make_module(
        group, dtype=torch.bfloat16 if args.bf16 else torch.float32,
        device=device, **mk)


def build(args, device):
    """The model of the flags on ``device``: ``(estimator, make_data,
    pack, work_queue)``. ``make_data(seed)`` is the model's synthetic
    stream at the flags' batch size, ``pack(stream, dev)`` its next
    batch packed for the group on ``dev`` (by default on the CPU with
    ``--smartstaged``, which moves batches on its prefetch thread, else
    on ``device``)."""
    import torch

    from deeprec_tpu_torch.data.criteo import CRITEO_HASH_BUCKETS
    from deeprec_tpu_torch.data.work_queue import WorkQueue
    from deeprec_tpu_torch.feature_column.feature_column import \
        EmbeddingGroup
    from deeprec_tpu_torch.layers.core import init_dense
    from deeprec_tpu_torch.models.registry import SEQUENCE_MODELS, ZOO
    from deeprec_tpu_torch.optimizers import dense as dense_lib
    from deeprec_tpu_torch.optimizers import sparse as sopt
    from deeprec_tpu_torch.train import estimator as estlib

    entry = ZOO[args.model]
    group = EmbeddingGroup(columns(args), coalesce=not args.no_emb_fusion)
    module = make_module(args, group, device)
    init_dense(module, torch.Generator().manual_seed(args.seed))

    if args.model in SEQUENCE_MODELS:
        def make_data(seed):
            return entry.make_data(batch_size=args.batch_size, seed=seed,
                                   **SEQ_DATA)

        def raw(d):
            return d.next_batch_np()
    else:
        wide = any(c.name.endswith("_wide") for c in group.embedding)

        def make_data(seed):
            return entry.make_data(batch_size=args.batch_size,
                                   vocab=CRITEO_HASH_BUCKETS, seed=seed)

        def raw(d):
            return d.next_batch_np(wide=wide)

    def pack(d, dev=None):
        if dev is None:
            dev = "cpu" if args.smartstaged else device
        return group.pack_batch_np(raw(d), dev)

    wq = (WorkQueue([f"shard:{s}" for s in range(64)], num_epochs=1,
                    shuffle=True, seed=args.seed) if args.workqueue else None)
    if args.dense.startswith("adam"):
        dlr = (float(args.dense.split(":", 1)[1]) if ":" in args.dense
               else 2e-3)
        dense_opt = dense_lib.Adam(dlr)
    else:
        dense_opt = dense_lib.Adagrad(args.learning_rate)
    est = estlib.Estimator(
        group, entry.make_apply(module, group), entry.loss,
        sopt.SparseAdagrad(learning_rate=args.learning_rate), dense_opt,
        module.state_dict(), micro_batch_num=args.micro_batch,
        model_dir=args.checkpoint, work_queue=wq, device=device)
    return est, make_data, pack, wq


def main(argv=None):
    args = parse_args(argv)
    check_ported(args)
    device = device_of(args)

    import torch

    from deeprec_tpu_torch.data.prefetch import staged
    from deeprec_tpu_torch.train import estimator as estlib

    est, make_data, pack, wq = build(args, device)
    group = est.group
    if wq is not None:
        # Work items are generator shards; each yields a bounded slice,
        # so the queue drains and training stops with it.
        def batches():
            while True:
                item = wq.take()
                if item is None:
                    return
                d = make_data(args.seed + int(item.split(":")[1]))
                for _ in range(16):
                    yield pack(d)
    else:
        def batches():
            d = make_data(args.seed)
            while True:
                yield pack(d)

    feed = (staged(batches, buffer_size=4, device=device)
            if args.smartstaged else batches())
    resumed = est.restore_if_available()
    if resumed is not None:
        print(f"resumed from step {resumed}", file=sys.stderr)

    hooks = [estlib.LoggingHook(
        every_steps=args.log_steps, batch_size=args.batch_size,
        log_fn=lambda s: print(s, file=sys.stderr, flush=True))]
    if est.manager is not None:
        hooks.append(estlib.CheckpointHook(
            est.manager, save_steps=args.save_steps,
            incremental_save_steps=args.incremental_ckpt or None))
    if args.timeline:
        hooks.append(estlib.ProfilerHook(
            start_step=10, stop_step=min(20, args.steps),
            logdir=args.timeline))

    t0 = time.perf_counter()
    try:
        metrics = est.train(feed, max_steps=args.steps, hooks=hooks)
    finally:
        if args.smartstaged:
            feed.close()
    if device.type == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0

    out = {"model": args.model, "steps": args.steps,
           "batch_size": args.batch_size,
           "backend": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
           "final_loss": round(metrics.get("loss", float("nan")), 4),
           "train_s": round(train_s, 1)}
    if resumed is not None:
        out["resumed_from"] = resumed

    if args.eval_steps:
        d_eval = make_data(args.seed + 10_001)

        def eval_batch():
            return pack(d_eval, device)

        probe = est.predict(eval_batch())
        # Single-logit models only: multi-task models give a dict, DSSM
        # its two towers, DIEN (logit, aux).
        if isinstance(probe, torch.Tensor) and probe.dim() == 1:
            ev = est.evaluate((eval_batch()
                               for _ in range(args.eval_steps + 1)),
                              steps=args.eval_steps)
            out.update({k: round(v, 4) for k, v in ev.items()})
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
