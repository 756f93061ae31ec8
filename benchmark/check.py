"""What decides ``correct``: the program's first three steps against the
plain reference's.

Set-up trains the cell's first three batches through the window's own
call (a pool call of batch 1, then of batches 2 and 3) and reads, before
any further step:

* each step's loss;
* after step 1, each leaf's gradient norm as the optimizer holds it:
  Adagrad's accumulators after one step are ``acc0 + g*g``, so the sum of
  ``acc - acc0`` over a leaf is its squared gradient norm (a table's:
  over the rows of the keys step 1 touched, found by the table's probe);
* after step 3, each tower weight, and the rows of every key the three
  steps touched, with how many of those keys the tables do not hold and
  how many keys they hold.

After the window the reference (``reference/train.py``) follows the
three steps from the same batches and first weights, and four numbers
are compared with the cell's limits (``limits/<workload>.json``):

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the worst leaf's gap between the two gradient norms;
* ``change_gap``: the worst leaf's gap between the two norms of the
  parameters' change over the three steps (a table's change: its rows
  less the first rows the reference derives for their keys). Leaves the
  reference's gradient leaves at rounding (norm under a thousandth of
  the median leaf's) are left out;
* ``keys_gap``: keys touched that the tables do not hold, plus the gap
  between the keys each table holds and the reference's (exact).

A leaf's gap is taken against the reference's norm of that leaf or of
the median leaf, whichever is larger. Tables are named ``emb<width>``.
"""

from __future__ import annotations

import statistics
from typing import Dict

import torch

from benchmark.reference import keys as keylib
from benchmark.reference import train as reflib
from deeprec_tpu_torch.embedding import hash_table as ht

CHECK_STEPS = 3
ORDER = ("loss_gap", "grad_gap", "change_gap", "keys_gap")
MOVED = 1e-3


def _held(acc: torch.Tensor, acc0: float) -> float:
    a0 = torch.tensor(acc0, dtype=torch.float32).double()
    return float((acc.double() - a0.to(acc.device)).sum())


def _table_keys(rn, first, n_batches: int):
    """Per physical table of the program: its distinct keys (the
    program's own transform) over the first ``n_batches`` checked
    batches, padding left out, as (hi, lo) on the device."""
    tr = rn.tr
    by_table: Dict[str, list] = {}
    for c in tr.columns:
        ids = first["ids"][c.name][:n_batches].reshape(-1).to(rn.device)
        hi, lo = tr.group.transform_ids(c, *keylib.split(ids))
        k = keylib.join(hi, lo)
        by_table.setdefault(tr.group.physical_table_of(c), []).append(
            k[k != keylib.EMPTY_KEY])
    return {t: keylib.split(torch.unique(torch.cat(ks)))
            for t, ks in by_table.items()}


def first_steps(rn, step1, steps23, first) -> Dict:
    """Train the checked steps, a call of ``step1`` (one batch) and a call
    of ``steps23`` (two), and read the program; ``first`` holds their raw
    batches on the host (``Feed.next``'s ``keep``: ids by column)."""
    tr, g = rn.tr, rn.tr.group
    snap = {"first": first, "dense0": tr.dense0, "grad_sq": {}, "rows": {},
            "live": {}, "missing": 0}
    rn.call(step1)
    d0 = rn.cell.cfg["dense_optimizer"]["initial_accumulator_value"]
    s0 = rn.cell.cfg["sparse_optimizer"]["initial_accumulator_value"]
    for n, acc in tr.ts.dense_opt["sum_of_squares"].items():
        snap["grad_sq"][n] = _held(acc, d0)
    for t, (hi, lo) in _table_keys(rn, first, 1).items():
        tc, st = g.tables[t], tr.ts.ev[t]
        slots = ht.find(st.table, hi, lo, max_probes=tc.max_probes)
        acc = tr.ts.slots[t]["accum"][slots.to(torch.int64)]
        snap["grad_sq"][f"emb{tc.dim}"] = _held(acc, s0)
    rn.call(steps23)
    rn.sync()
    snap["loss"] = [float(x) for x in torch.cat(rn.losses[-2:]).cpu()]
    for t, (hi, lo) in _table_keys(rn, first, CHECK_STEPS).items():
        tc, st = g.tables[t], tr.ts.ev[t]
        slots = ht.find(st.table, hi, lo, max_probes=tc.max_probes)
        snap["missing"] += int((slots >= tc.capacity).sum())
        snap["rows"][f"emb{tc.dim}"] = (
            keylib.join(hi, lo).cpu(),
            st.values[slots.to(torch.int64)].to(torch.float32).cpu())
        snap["live"][f"emb{tc.dim}"] = int(ht.num_live(st.table))
    snap["dense3"] = {k: v.detach().cpu().clone()
                      for k, v in tr.ts.params.items()}
    return snap


def program_readings(snap: Dict, cell, device) -> Dict:
    """The program's readings from a set-up snapshot, worked out once its
    state is freed (a table's change needs the first rows of its keys)."""
    salt = {s["dim"]: s["salt"] for s in keylib.tables_of(
        cell.ref_mod.columns(cell.cfg))}
    change = {n: float(((p - snap["dense0"][n]).double() ** 2).sum())
              for n, p in snap["dense3"].items()}
    for leaf, (keys, rows) in snap["rows"].items():
        dim = rows.shape[1]
        k = keys.to(device)
        d = rows.to(device) - keylib.init_rows(k, dim, salt[dim])
        change[leaf] = float((d.double() ** 2).sum())
    return {"loss": snap["loss"], "grad_sq": snap["grad_sq"],
            "change_sq": change, "live": snap["live"],
            "missing": snap["missing"]}


def reference_readings(cell, snap: Dict, device,
                       table_dtype=torch.float32) -> Dict:
    """The reference over the checked batches (``table_dtype``: the
    control's precision of the table rows)."""
    ref = reflib.Reference(cell.cfg, cell.ref_mod.columns(cell.cfg),
                           cell.ref_mod.forward, snap["dense0"], device,
                           table_dtype)
    first = snap["first"]
    batches = [{"ids": {c: v[i].to(device) for c, v in first["ids"].items()},
                "ints": first["ints"][i].to(device),
                "labels": first["labels"][i].to(device)}
               for i in range(first["labels"].shape[0])]
    return reflib.readings(ref, batches, snap["dense0"])


def as_program(ref: Dict) -> Dict:
    """Reference readings in the program's place (the control)."""
    return {"loss": ref["loss"], "grad_sq": ref["grad_sq"],
            "change_sq": ref["change_sq"], "live": dict(ref["distinct"]),
            "missing": 0}


def _worst(prog: Dict[str, float], ref: Dict[str, float], leaves) -> float:
    r = {k: ref[k] ** 0.5 for k in leaves}
    med = statistics.median(r.values())
    return max(abs(prog[k] ** 0.5 - r[k]) / max(r[k], med) for k in leaves)


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(prog["loss"], ref["loss"]))
    leaves = list(ref["grad_sq"])
    gmed = statistics.median(v ** 0.5 for v in ref["grad_sq"].values())
    moved = [k for k in leaves if ref["grad_sq"][k] ** 0.5 >= MOVED * gmed]
    keys_gap = prog["missing"] + sum(abs(prog["live"][t] - n)
                                     for t, n in ref["distinct"].items())
    return {"loss_gap": loss_gap,
            "grad_gap": _worst(prog["grad_sq"], ref["grad_sq"], leaves),
            "change_gap": _worst(prog["change_sq"], ref["change_sq"], moved),
            "keys_gap": keys_gap}


def passes(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] <= limits[k] for k in ORDER)


def as_limits(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    return {k: {"value": numbers[k], "limit": limits[k]} for k in ORDER}
