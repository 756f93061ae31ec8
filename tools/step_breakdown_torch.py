"""Per-phase device time of the headline WDL training step on the CUDA
card: the counterpart of ``tools/step_breakdown.py``.

The model is the JAX tool's: B = 16,384, reference-shaped coalesced WDL
(wide in deep, bf16 towers 1024/512/256, sparse and dense Adagrad at
0.05), every column's capacity capped at ``2**--cap``; ``--light``
takes the ``bench.py`` headline's LightHeader tables (no freq, no
version). Three steps on fresh batches warm the tables; then each phase
runs on its own, on copies of the warmed state and the first batch:

  probe       P1's ``find_or_insert`` of the batch's ids (every id of a
              table then present)
  dedup       the first-occurrence dedup and the compaction to the
              unique budget (``claim_dedup``, ``_compact``)
  gather      K1's fetch of the unique rows with the default select
  lookup      the whole lookup (``lookup_train_occ``: the three above,
              the row init and the masks); ``lookup_rest`` is what it
              takes beyond them
  dense       the combine, towers and loss, forward and backward into
              the dense params and the unique rows
  dense_apply dense Adagrad
  apply       K2's sparse Adagrad on the unique rows
  full        the training step (``make_train_step``)

Indexed phases are summed over the physical tables (``per_table`` has
each). ``phase_sum_ms`` (lookup, dense, dense_apply, apply) should come
close to ``full``. On the card a phase's time is device time, as
``chip_smoke.median_ms`` takes it: 10 calls captured in a CUDA graph,
the median of 20 replays over 10. With ``--cpu`` it is the host clock's
mean over ``--steps`` calls.

Usage: python3 tools/step_breakdown_torch.py [--cap LOG2] [--light]
           [--batch N] [--steps N] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=16384)
    p.add_argument("--steps", type=int, default=20,
                   help="calls a phase is timed over (--cpu)")
    p.add_argument("--cap", type=int, default=20,
                   help="log2 of each column's capacity ceiling")
    p.add_argument("--light", action="store_true",
                   help="LightHeader tables (no freq, no version)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    return p.parse_args(argv)


def make_timer(device, steps: int):
    """``time(fn) -> ms`` a call: device time on the card, the host
    clock's mean on the CPU."""
    if device.type == "cuda":
        import chip_smoke
        return chip_smoke.median_ms

    def host_ms(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        return (time.perf_counter() - t0) / steps * 1e3
    return host_ms


def build(args, device):
    """The JAX tool's model as a ``bench.Trainer`` on ``device``."""
    import torch

    from deeprec_tpu_torch import bench
    from deeprec_tpu_torch import config as cfglib
    from deeprec_tpu_torch.data.criteo import (CRITEO_HASH_BUCKETS,
                                               SyntheticCriteo)
    from deeprec_tpu_torch.models import wdl

    evo = (cfglib.EmbeddingVariableOption(record_freq=False,
                                          record_version=False)
           if args.light else None)
    cols = wdl.criteo_columns(embedding_dim=16, capacity=1 << args.cap,
                              reference_shapes=True, wide_in_deep=True,
                              ev_option=evo)
    data = SyntheticCriteo(args.batch, vocab=CRITEO_HASH_BUCKETS, seed=0)
    return bench._assemble(cols, (1024, 512, 256), torch.bfloat16, device,
                           "adagrad", data, wide=False,
                           metric="wdl_step_breakdown")


def breakdown(args, device) -> dict:
    import torch

    from deeprec_tpu_torch.embedding import hash_table as ht
    from deeprec_tpu_torch.embedding import variable as ev
    from deeprec_tpu_torch.ops.kernels import gather
    from deeprec_tpu_torch.train import loop as trainlib
    from deeprec_tpu_torch.utils import keys as keylib
    from model_benchmark_torch import card_facts

    tr = build(args, device)
    group = tr.group
    timer = make_timer(device, args.steps)
    b = tr.next_batch()
    for _ in range(3):
        tr.ts, _ = tr.step(tr.ts, tr.next_batch())
    ts0 = tr.ts
    gs = ts0.step

    per_table, n_ids = {}, 0
    for tname, tcols in group._columns_by_table().items():
        cfg = group.tables[tname]
        ids_hi, ids_lo, widths = group._packed_view(b, tname, tcols)
        qhi, qlo = ids_hi.reshape(-1), ids_lo.reshape(-1)
        n = qhi.shape[0]
        n_ids += n
        budget = group._unique_budget(tcols, widths, ids_hi.shape)
        U = n if budget is None else min(budget, n)
        salt = group.salts[tname]
        st = trainlib.clone_state(ts0.ev[tname])
        is_real = qhi != keylib.EMPTY_HI

        def lookup():
            ev.lookup_train_occ(cfg, st, qhi, qlo, gs, salt=salt,
                                budget=budget)

        def probe():
            ht.find_or_insert(st.table, qhi, qlo, is_real,
                              max_probes=cfg.max_probes)

        _, occ = ev.lookup_train_occ(cfg, st, qhi, qlo, gs, salt=salt,
                                     budget=budget)
        _, slots, _ = ht.find_or_insert(st.table, qhi, qlo, is_real,
                                        max_probes=cfg.max_probes)

        def dedup():
            tokens, _, rep_token, rep = ev.claim_dedup(slots, is_real,
                                                       cfg.capacity)
            if budget is not None:
                ev._compact(rep, rep_token, is_real, tokens, U)

        lk = occ.lk
        sel = ev._default_sel(st, lk.qhi, lk.qlo)

        def fetch():
            gather.gather_rows(st.values, lk.slots, lk.admitted,
                               st.default_bank, sel)

        t = {"lookup": timer(lookup), "probe": timer(probe),
             "dedup": timer(dedup), "gather": timer(fetch)}
        n_u = int(((lk.slots < cfg.capacity) & lk.admitted).sum())
        per_table[tname] = {"ids": n, "unique": n_u,
                            "unique_budget": budget,
                            "dim": int(st.values.shape[1]),
                            **{f"{k}_ms": round(v, 4) for k, v in t.items()}}
        print(f"[{tname}] {per_table[tname]}", file=sys.stderr, flush=True)
        del st

    # One lookup of the batch on a copy of the state: the rows and the
    # maps the dense and apply phases start from.
    states = trainlib.clone_state(ts0.ev)
    _, gl = group.lookup_train(states, b, gs)
    rows = {t: lk.rows.detach().requires_grad_() for t, lk in gl.lks.items()}
    params = {k: v.detach().requires_grad_() for k, v in ts0.params.items()}

    def dense():
        out = tr.apply_fn(params, group.combine(gl, rows), b)
        per_ex = tr.loss_fn(out, b)
        loss = per_ex.sum() / per_ex.shape[0]
        return torch.autograd.grad(loss, list(params.values())
                                   + list(rows.values()))

    grads = dense()
    p_grads = dict(zip(params, grads[:len(params)]))
    r_grads = dict(zip(rows, grads[len(params):]))
    d_params = trainlib.clone_state(ts0.params)
    d_state = trainlib.clone_state(ts0.dense_opt)
    slots = trainlib.clone_state(ts0.slots)
    full_ts = trainlib.clone_state(ts0)
    phases = {k: sum(pt[f"{k}_ms"] for pt in per_table.values())
              for k in ("probe", "dedup", "gather", "lookup")}
    phases["lookup_rest"] = (phases["lookup"] - phases["probe"]
                             - phases["dedup"] - phases["gather"])
    phases["dense"] = timer(dense)
    phases["dense_apply"] = timer(
        lambda: tr.dense_opt.apply(d_params, p_grads, d_state))
    phases["apply"] = timer(lambda: group.apply_gradients(
        tr.sparse_opt, slots, states, gl, r_grads, gs))
    phases["full"] = timer(lambda: tr.step(full_ts, b))
    total = sum(phases[k] for k in ("lookup", "dense", "dense_apply",
                                    "apply"))
    return {"metric": "wdl_step_breakdown", "batch": args.batch,
            "cap_log2": args.cap, "light": args.light,
            "ids_per_step": n_ids, **card_facts(device),
            "timing": ("device time: chip_smoke.median_ms (10 calls "
                       "captured in a CUDA graph, median of 20 replays)"
                       if device.type == "cuda" else
                       f"host clock, mean of {args.steps} calls"),
            "per_table": per_table,
            "phases_ms": {k: round(v, 4) for k, v in phases.items()},
            "phase_sum_ms": round(total, 4),
            "phase_sum_over_full": round(total / phases["full"], 3)}


def main(argv=None):
    args = parse_args(argv)
    import torch

    if args.cpu:
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        raise SystemExit("step_breakdown_torch: no CUDA card (torch.cuda."
                         "is_available() is false); pass --cpu")
    else:
        device = torch.device("cuda")
    out = breakdown(args, device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
