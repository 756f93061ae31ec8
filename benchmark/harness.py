"""One run of one cell: set-up, the trace, the measured window, the check.

The program under test is the port's captured epoch step,
``deeprec_tpu_torch.train.loop.make_epoch_step``, driven as its users
drive it: a call trains a pool of K batches stacked on the card (step 0
eager, the step captured in a CUDA graph, K - 1 replays).

Set-up builds the trainer (tables on the card, tower weights drawn from
the seed on the card), draws the first pool, trains its first three
steps as a call of one batch and a call of two (the readings the check
compares are taken after them), finishes the pool in a third call (a
stream's first pool; an epochs cell's first epoch), and draws the next
pool. A traced run first traces ``TRACE_CALLS`` calls (a stream's
early calls, where its inserts are). The window then makes whole pool
calls until ``seconds`` have passed: from a CUDA event recorded before
the first call to the end of the last call's replays, re-captures,
eager steps and the stream's next pools included.
Last, the program's state is freed and the reference follows the first
three steps from the same inputs.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from benchmark import check, devtrace, roofline
from benchmark.generator import ByColumn, ClickStream, sub_seed
from benchmark.manifest import Cell
from benchmark.reference import keys as keylib
from deeprec_tpu_torch.embedding import hash_table as ht
from deeprec_tpu_torch.feature_column.feature_column import (EmbeddingGroup,
                                                             SparseIds)
from deeprec_tpu_torch.optimizers import dense as dense_lib
from deeprec_tpu_torch.optimizers import sparse as sparse_lib
from deeprec_tpu_torch.train import loop as trainlib
from deeprec_tpu_torch.train import losses as losslib

SPANS = ("release", "pool_call", "draw_pool")
# Pool calls a traced run traces before its window.
TRACE_CALLS = 1


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _loss(fault: Optional[str]):
    """The per-example loss the step is given; ``fault`` plants a broken
    step for the check's own tests: "half_batch" keeps the first half of
    the batch (the mean then over it alone), "no_update" zeroes every
    gradient."""
    def loss(out, batch):
        per = losslib.bce_with_logits(out, batch["label"])
        if fault == "half_batch":
            return per[: per.shape[0] // 2]
        if fault == "no_update":
            return per * 0.0
        return per
    if fault not in (None, "half_batch", "no_update"):
        raise ValueError(f"unknown fault {fault!r}")
    return loss


@dataclasses.dataclass
class Trainer:
    group: EmbeddingGroup
    ts: trainlib.TrainState
    epoch: trainlib.EpochStep
    columns: list            # the embedding columns, in column order
    numeric: list            # the numeric columns' names, in order
    dense0: Dict[str, torch.Tensor]  # first tower weights, on the host
    batch: int


def dense_init(module, seed: int, device) -> Dict[str, torch.Tensor]:
    """Tower weights drawn on the device from the seed in one call: each
    matrix normal over sqrt(fan in), each bias zero."""
    shapes = {k: v.shape for k, v in module.state_dict().items()}
    n = sum(math.prod(s) for s in shapes.values() if len(s) == 2)
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, 4))
    flat = torch.randn(n, generator=g, device=device)
    out, off = {}, 0
    for k, s in shapes.items():
        if len(s) == 2:
            out[k] = flat[off:off + math.prod(s)].view(s) * s[1] ** -0.5
            off += math.prod(s)
        else:
            out[k] = torch.zeros(s, device=device)
    return out


def build(cell: Cell, seed: int, device, fault: Optional[str] = None
          ) -> Trainer:
    cfg = cell.cfg
    cols = cell.cfg_mod.columns(cfg)
    group = EmbeddingGroup(cols, coalesce=cfg["table"]["coalesce"])
    module, apply_fn = cell.cfg_mod.towers(cfg, group, device)
    params = dense_init(module, seed, device)
    so, do = cfg["sparse_optimizer"], cfg["dense_optimizer"]
    sopt = sparse_lib.SparseAdagrad(
        learning_rate=so["learning_rate"],
        initial_accumulator_value=so["initial_accumulator_value"])
    dopt = dense_lib.Adagrad(
        do["learning_rate"],
        initial_accumulator_value=do["initial_accumulator_value"],
        eps=do["eps"])
    ts = trainlib.create_train_state(group, params, dopt, sopt, device)
    epoch = trainlib.make_epoch_step(group, apply_fn, _loss(fault), sopt,
                                     dopt, n_epochs=1)
    emb = [c for c in cols if hasattr(c, "dim")]
    return Trainer(group=group, ts=ts, epoch=epoch, columns=emb,
                   numeric=[c.name for c in cols if not hasattr(c, "dim")],
                   dense0={k: v.detach().cpu().clone()
                           for k, v in params.items()},
                   batch=int(cfg["batch_size"]))


def traffic(cell: Cell, names, seed: int, device):
    """The cell's stream (``manifest``'s contract): its configuration's
    own ``stream``, or the Criteo draw over ``vocab(cfg)`` with
    embedding column ``names[j]`` taking one id a sample."""
    if hasattr(cell.cfg_mod, "stream"):
        return cell.cfg_mod.stream(cell.cfg, cell.traffic, seed, device)
    return ByColumn(ClickStream(cell.cfg_mod.vocab(cell.cfg), cell.traffic,
                                seed, device), names)


class Feed:
    """Pools of the cell's traffic, packed as the port's batches: each
    physical table's transformed ids ``SparseIds [K, B, L]`` (its
    columns' ``L_c`` ids side by side, in column order, padding kept as
    the EMPTY id), the label and each numeric column ``[K, B]``. A pool
    is written chunk by chunk into one of ``n_buffers`` pools allocated
    once, so drawing the next pool while one trains allocates nothing of
    a pool's size."""

    def __init__(self, cell: Cell, tr: Trainer, seed: int, device, K: int,
                 n_buffers: int):
        self.tr, self.K = tr, K
        self.stream = traffic(cell, [c.name for c in tr.columns], seed,
                              device)
        g, L = tr.group, self.stream.widths
        # (column, its table's pool key, first position, L_c)
        self.place, width = [], {}
        for c in tr.columns:
            key = g.PACKED_PREFIX + g.physical_table_of(c)
            self.place.append((c, key, width.get(key, 0), L[c.name]))
            width[key] = width.get(key, 0) + L[c.name]
        # A first packing records the tables' column widths on the group.
        g.pack_batch({c.name: SparseIds(*keylib.split(torch.zeros(
            1, L[c.name], dtype=torch.int64, device=device)))
            for c in tr.columns})
        B = tr.batch

        def alloc():
            pool = {k: SparseIds(*(torch.empty(K, B, n, dtype=torch.int32,
                                               device=device)
                                   for _ in range(2)))
                    for k, n in width.items()}
            for name in ["label"] + tr.numeric:
                pool[name] = torch.empty(K, B, device=device)
            return pool

        self.buffers = [alloc() for _ in range(n_buffers)]
        self.turn = 0

    def next(self, keep: int = 0):
        """The stream's next pool, and its first ``keep`` batches raw on
        the host: ``ids`` {column: [keep, B, L_c]}, ``ints`` [keep, B,
        n_int], ``labels`` [keep, B]."""
        pool = self.buffers[self.turn]
        self.turn = (self.turn + 1) % len(self.buffers)
        K, B = self.K, self.tr.batch
        flat = {k: (SparseIds(v.hi.view(K * B, -1), v.lo.view(K * B, -1))
                    if isinstance(v, SparseIds) else v.view(K * B))
                for k, v in pool.items()}
        kept = []
        for s, e, c in self.stream.chunks(K * B):
            if s < keep * B:
                m = keep * B - s
                kept.append((
                    {col.name: c["ids"][col.name][:m].cpu()
                     for col, _, _, _ in self.place},
                    c["ints"][:m].cpu(), c["labels"][:m].cpu()))
            flat["label"][s:e] = c["labels"]
            for i, name in enumerate(self.tr.numeric):
                flat[name][s:e] = c["ints"][:, i]
            for col, key, at, n in self.place:
                hi, lo = self.tr.group.transform_ids(
                    col, *keylib.split(c["ids"][col.name]))
                flat[key].hi[s:e, at:at + n] = hi
                flat[key].lo[s:e, at:at + n] = lo
        raw = None
        if kept:
            ids, ints, labels = zip(*kept)
            raw = {"ids": {col.name: torch.cat([i[col.name] for i in ids])
                           .view(keep, B, n)
                           for col, _, _, n in self.place},
                   "ints": torch.cat(ints).view(keep, B, ints[0].shape[1]),
                   "labels": torch.cat(labels).view(keep, B)}
        return pool, raw


def pool_slice(pool: Dict, a: int, b: int) -> Dict:
    return {k: (SparseIds(v.hi[a:b], v.lo[a:b]) if isinstance(v, SparseIds)
                else v[a:b]) for k, v in pool.items()}


class Runner:
    """A cell's trainer and feed, and the calls the window makes."""

    def __init__(self, cell: Cell, seed: int, device,
                 fault: Optional[str] = None):
        self.cell = cell
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.tr = build(cell, seed, self.device, fault)
        self.K = int(cell.traffic["pool_batches"])
        self.mode = cell.traffic["mode"]
        if self.mode not in ("stream", "epochs"):
            raise ValueError(f"traffic mode {self.mode!r}: stream | epochs")
        n_buffers = 1 if self.mode == "epochs" else 1 + TRACE_CALLS
        self.feed = Feed(cell, self.tr, seed, self.device, self.K, n_buffers)
        self.losses: List[torch.Tensor] = []

    def live(self) -> Dict[str, torch.Tensor]:
        """Each table's live keys, as device tensors (no host read)."""
        return {t: ht.num_live(st.table) for t, st in self.tr.ts.ev.items()}

    def call(self, pool) -> Dict:
        """One pool call, as the window makes it."""
        rec = torch.profiler.record_function
        c0 = time.perf_counter()
        with rec("release"):
            self.tr.epoch.release()
        c_rel = time.perf_counter()
        live0 = self.live()
        with rec("pool_call"):
            self.tr.ts, losses = self.tr.epoch(self.tr.ts, pool)
        c1 = time.perf_counter()
        run = self.tr.epoch.last_run
        self.losses.append(losses)
        ev = run.get("events") or (None, None)
        return {"wall_s": c1 - c0, "release_s": c_rel - c0,
                "enqueue_s": run.get("enqueue_s", 0.0),
                "begin": ev[0], "end": ev[1],
                "host_end": c1, "steps": run["steps"], "live0": live0,
                "live1": None}

    def next_pool(self, pool):
        """The pool after ``pool``: a stream's next draw, or the same."""
        if self.mode == "epochs":
            return pool
        with torch.profiler.record_function("draw_pool"):
            return self.feed.next()[0]

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()


def recapture_s(call: Dict) -> float:
    """Host seconds a call spends after its wait for the previous call
    and before its first replay: eager step 0 and the capture."""
    return call["wall_s"] - call["release_s"] - call["enqueue_s"]


def nvidia_smi() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def start(cell: Cell, seed: int, device, fault: Optional[str] = None):
    """Build, draw the first pool and train the checked steps. Returns
    the runner, the check's snapshot and the pool."""
    rn = Runner(cell, seed, device, fault)
    n = check.CHECK_STEPS
    pool, first = rn.feed.next(keep=n)
    snap = check.first_steps(rn, pool_slice(pool, 0, 1),
                             pool_slice(pool, 1, n), first)
    return rn, snap, pool


def setup(cell: Cell, seed: int, device):
    """:func:`start`, then the rest of the first pool and the next pool.
    Returns the runner, the check's snapshot and the window's first
    pool."""
    rn, snap, pool = start(cell, seed, device)
    rn.call(pool_slice(pool, check.CHECK_STEPS, rn.K))
    return rn, snap, rn.next_pool(pool)


def window(rn: Runner, pool, seconds: float):
    """Whole pool calls until ``seconds`` have passed. Returns the calls,
    the window's seconds and the pool that would come next."""
    rn.tr.epoch.release()
    rn.sync()
    start = torch.cuda.Event(enable_timing=True) if rn.cuda else None
    t0 = time.perf_counter()
    if start is not None:
        start.record()
    calls = []
    while not calls or time.perf_counter() - t0 < seconds:
        calls.append(rn.call(pool))
        last = pool
        pool = rn.next_pool(pool)
    rn.tr.epoch.release()
    rn.sync()
    if start is not None:
        secs = start.elapsed_time(calls[-1]["end"]) / 1e3
        for prev, c in zip([start] + [c["end"] for c in calls], calls):
            c["device_ms"] = prev.elapsed_time(c["end"])
            c["replays_ms"] = c["begin"].elapsed_time(c["end"])
    else:
        secs = calls[-1]["host_end"] - t0
    _close_live(rn, calls)
    return calls, secs, pool, last


def _close_live(rn: Runner, calls) -> None:
    """Each call's live keys after it: the next call's before, or now."""
    for i, c in enumerate(calls):
        c["live1"] = calls[i + 1]["live0"] if i + 1 < len(calls) \
            else rn.live()


def fresh_per_step(calls) -> List[float]:
    """New keys a step (every table) over the first and the last call."""
    out = []
    for c in (calls[0], calls[-1]):
        out.append(sum(int(c["live1"][t]) - int(c["live0"][t])
                       for t in c["live0"]) / c["steps"])
    return out


def lost_ids(rn: Runner, pool) -> int:
    """Ids of ``pool`` that the tables do not hold after training it:
    the ids the probe could not place (the step's ``n_overflow`` of the
    tables; the unique budgets of these cells drop none). Padding is no
    id: ``find`` gives it no slot, and it is taken off the count."""
    lost = 0
    for tname, st in rn.tr.ts.ev.items():
        s = pool[rn.tr.group.PACKED_PREFIX + tname]
        cap = rn.tr.group.tables[tname].capacity
        hi, lo = s.hi.reshape(-1), s.lo.reshape(-1)
        lost -= int(((hi == keylib.EMPTY_HI) & (lo == keylib.EMPTY_LO)).sum())
        slots = ht.find(st.table, hi, lo,
                        max_probes=rn.tr.group.tables[tname].max_probes)
        lost += int((slots >= cap).sum())
    return lost


def traced_calls(rn: Runner, pool, n_calls: int):
    """``n_calls`` calls under the profiler. Returns the trace, the calls,
    the pools they trained and the pool that comes next."""
    calls, pools = [], []

    def run():
        nonlocal pool
        for _ in range(n_calls):
            calls.append(rn.call(pool))
            pools.append(pool)
            pool = rn.next_pool(pool)
        rn.tr.epoch.release()

    trace = devtrace.record(run, SPANS)
    _close_live(rn, calls)
    return trace, calls, pools, pool


def table_stats(rn: Runner, calls, pools) -> List[Dict]:
    """Per table, the traced steps' byte-model counts and new keys."""
    out = []
    for tname, tc in rn.tr.group.tables.items():
        tot = {"dim": tc.dim, "capacity": tc.capacity, "ids": 0,
               "applied": 0, "key_rows": 0, "fresh": 0}
        for c, p in zip(calls, pools):
            s = p[rn.tr.group.PACKED_PREFIX + tname]
            K = s.hi.shape[0]
            keys = keylib.join(s.hi, s.lo).view(K, -1)
            for k, v in roofline.step_counts(keys, tc.capacity).items():
                tot[k] += v
            tot["fresh"] += int(c["live1"][tname]) - int(c["live0"][tname])
        out.append(tot)
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> Dict:
    """The whole run; returns the result line's fields and the check."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    if cuda:
        log(f"card: {nvidia_smi()}")
    rn, snap, pool = setup(cell, seed, dev)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")
    device_rec = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                  "count": cell.chips}
    trace_rec = None
    if trace:
        # The traced calls come first, on the pools the window would
        # start with: a stream's early calls, where its inserts are.
        tr, tcalls, tpools, pool = traced_calls(
            rn, pool, TRACE_CALLS)
        trace_rec = (tr, sum(c["steps"] for c in tcalls),
                     table_stats(rn, tcalls, tpools))
        device_rec.update(busy_s=tr.busy_us / 1e6,
                          window_s=tr.window_us / 1e6)
        del tpools
    calls, secs, pool, last = window(rn, pool, seconds)
    K, B = rn.K, rn.tr.batch
    steps = sum(c["steps"] for c in calls)
    losses = torch.cat(rn.losses[-len(calls):])
    failed = int((~torch.isfinite(losses)).sum())
    fresh = fresh_per_step(calls)
    log(f"window: {len(calls)} calls of {K} batches of {B}, {steps} steps "
        f"in {secs:.4f} s; fresh rows a step {fresh[0]:.1f} in the first "
        f"call, {fresh[1]:.1f} in the last")
    log("live rows after the window: " + "; ".join(
        f"{t} {int(n)} of {rn.tr.group.tables[t].capacity}"
        for t, n in calls[-1]["live1"].items()))
    if cuda:
        log("calls (device ms from the previous call's last replay to "
            "this one's; of it, replays; host ms of the wait for the "
            "previous call; host ms after it, before the first replay): "
            + "; ".join(f"{c['device_ms']:.1f} {c['replays_ms']:.1f} "
                        f"{1e3 * c['release_s']:.1f} "
                        f"{1e3 * recapture_s(c):.1f}" for c in calls))
    log(f"n_overflow (ids of the last pool the tables do not hold): "
        f"{lost_ids(rn, last)}")
    ctx = SimpleNamespace(
        cfg=cell.cfg, cfg_mod=cell.cfg_mod, batch=B, setup_s=setup_s,
        samples=steps * B, window_s=secs, calls=calls, trace=None,
        traced_steps=0, tables=None, peaks=roofline.PEAKS.get(kind))
    breakdown = None
    if trace_rec is not None:
        ctx.trace, ctx.traced_steps, ctx.tables = trace_rec
        breakdown = ctx.trace.breakdown()
    if cuda:
        device_rec["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(
            dev))
        log(f"memory peak {device_rec['memory_peak_bytes']} bytes; "
            f"card after the window: {nvidia_smi()}")
    entries = cell.metrics_layer if trace else cell.metrics_e2e
    metrics = {}
    for entry, mod in entries:
        v = mod.read(ctx)
        if v is not None:
            metrics[entry["name"]] = {"value": v, "unit": entry["unit"]}
    del rn, pool, last, calls, losses, ctx, trace_rec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = check.compare(check.program_readings(snap, cell, dev),
                            check.reference_readings(cell, snap, dev))
    result = {"correct": check.passes(numbers, cell.limits) and failed == 0,
              "attempted": steps, "failed": failed, "metrics": metrics,
              "device": device_rec}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = check.as_limits(numbers, cell.limits)
    return result


def print_result(result: Dict) -> None:
    for name, v in result["check"].items():
        log(f"check {name}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(result), flush=True)
