"""Plain PyTorch reference of the benchmark's training step.

It follows the first steps of a cell from the same inputs the program
gets (the batches' raw ids, numeric features and labels, and the first
tower weights) and from nothing the program made. Each embedding table
is an id -> row map held as sorted int64 keys beside their rows and
Adagrad accumulators: a step looks up the distinct keys of the batch
(padding is none), gives each new key its first row
(``keys.init_rows``), gathers a row per occurrence (a zero row at
padding), sums or averages each bag over its real ids and hands each
sequence on with its mask, runs the configuration's towers
(``reference/<config>.py``),
takes the mean sigmoid cross-entropy, and applies dense Adagrad (optax's:
``t = g*g + t``, ``p -= lr * g * rsqrt(t + eps)``) and sparse Adagrad on
the touched rows (``a = acc + g*g``, ``w -= lr * g * rsqrt(a)``, a new
row's accumulator starting at its initial value).

``table_dtype`` stores the rows in another precision (the control:
``torch.bfloat16``): each row is rounded to it when it is drawn and
after each update.

It imports neither the port nor JAX.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

import torch

from benchmark.reference import keys as keylib


@contextlib.contextmanager
def exact_float32():
    """float32 products in float32, not TF32, inside."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def bce(logits, labels):
    """Sigmoid cross-entropy per example. ``max(x, 0)`` is taken with
    ``torch.maximum``, whose gradient at a tie is one half to each side:
    so at ``x = 0`` (a logit of dead ReLUs and a zero bias) the gradient
    is ``sigmoid(0) - label``, as the loss's derivative is everywhere
    (``clamp`` would give ``1 - label`` there)."""
    x = logits.to(torch.float32)
    return (torch.maximum(x, torch.zeros_like(x)) - x * labels
            + torch.log1p(torch.exp(-torch.abs(x))))


class Table:
    """One physical table of the reference."""

    def __init__(self, name: str, spec: Dict, dtype, acc0: float, device):
        self.name = name
        self.dim = spec["dim"]
        self.salt = spec["salt"]
        self.members = spec["members"]
        self.dtype = dtype
        self.acc0 = acc0
        self.keys = torch.empty(0, dtype=torch.int64, device=device)
        self.rows = torch.empty(0, self.dim, dtype=dtype, device=device)
        self.acc = torch.empty(0, self.dim, dtype=torch.float32,
                               device=device)

    def key_of(self, member: str, ids: torch.Tensor) -> torch.Tensor:
        """Keys of the raw ``ids`` of a column of table ``member``."""
        return keylib.salted(ids, self.members[member])

    def lookup(self, keys: torch.Tensor):
        """Indices of ``keys`` (distinct) in the table, new keys added
        with their first rows."""
        pos = torch.searchsorted(self.keys, keys)
        at = torch.clamp(pos, max=max(self.keys.numel() - 1, 0))
        present = ((pos < self.keys.numel())
                   & (self.keys[at] == keys if self.keys.numel()
                      else torch.zeros_like(keys, dtype=torch.bool)))
        new = keys[~present]
        if new.numel():
            rows = keylib.init_rows(new, self.dim, self.salt).to(self.dtype)
            k = torch.cat([self.keys, new])
            order = torch.argsort(k)
            self.keys = k[order]
            self.rows = torch.cat([self.rows, rows])[order]
            self.acc = torch.cat([self.acc, torch.full(
                (new.numel(), self.dim), self.acc0, dtype=torch.float32,
                device=keys.device)])[order]
        return torch.searchsorted(self.keys, keys)


class Reference:
    """The reference trainer of one cell: ``forward(params, embs,
    numeric) -> logits`` is the configuration's towers; ``columns`` its
    embedding columns in column order, in any form ``keys.describe``
    takes; ``dense0`` the first tower weights by name."""

    def __init__(self, cfg: Dict, columns, forward: Callable,
                 dense0: Dict[str, torch.Tensor], device,
                 table_dtype=torch.float32):
        self.cfg = cfg
        self.forward = forward
        self.columns = keylib.describe(columns)
        sopt, dopt = cfg["sparse_optimizer"], cfg["dense_optimizer"]
        self.s_lr = sopt["learning_rate"]
        self.s_acc0 = sopt["initial_accumulator_value"]
        self.d_lr = dopt["learning_rate"]
        self.d_eps = dopt["eps"]
        self.tables: Dict[str, Table] = {}
        holder: Dict[str, Table] = {}
        for spec in keylib.tables_of(self.columns):
            t = Table(f"emb{spec['dim']}", spec, table_dtype, self.s_acc0,
                      device)
            self.tables[t.name] = t
            for m in spec["members"]:
                holder[m] = t
        self.table_of = {c["name"]: holder[c["table"]] for c in self.columns}
        self.params = {k: v.detach().to(device, torch.float32).clone()
                       for k, v in dense0.items()}
        self.dense_acc = {k: torch.full_like(v, dopt[
            "initial_accumulator_value"]) for k, v in self.params.items()}

    def _embed(self, ids):
        """Each column's embedding, differentiable in each table's rows of
        the batch's distinct keys: ``(embs, {table: (keys, indices,
        rows)})``. Padding is no key: it reads a zero row."""
        occ, uniq = {}, {}
        for t in self.tables.values():
            cols = [c for c in self.columns if self.table_of[c["name"]] is t]
            raw = torch.cat([ids[c["name"]] for c in cols], dim=1)
            real = raw != keylib.EMPTY_KEY
            k = torch.cat([t.key_of(c["table"], ids[c["name"]])
                           for c in cols], dim=1)
            u, inv_real = torch.unique(k[real], return_inverse=True)
            inv = torch.zeros_like(k)
            inv[real] = inv_real
            idx = t.lookup(u)
            uniq[t.name] = (u, idx,
                            t.rows[idx].to(torch.float32).requires_grad_())
            off = 0
            for c in cols:
                n = ids[c["name"]].shape[1]
                occ[c["name"]] = (t.name, inv[:, off:off + n],
                                  real[:, off:off + n])
                off += n
        embs = {}
        for c in self.columns:
            tname, inv, real = occ[c["name"]]
            x = uniq[tname][2][inv] * real[..., None]
            if c["kind"] == "sequence":
                embs[c["name"]] = (x, real)
            elif c["combiner"] == "mean":
                embs[c["name"]] = x.sum(dim=1) / torch.clamp(
                    real.sum(dim=1), min=1)[:, None]
            else:
                embs[c["name"]] = x.sum(dim=1)
        return embs, uniq

    def step(self, ids, ints, labels) -> float:
        """One training step on a batch: ``ids`` {column: [B, L_c] int64
        raw ids, EMPTY-padded}, ``ints`` [B, n_int], ``labels`` [B].
        Returns the loss."""
        B = labels.shape[0]
        embs, uniq = self._embed(ids)
        params = {k: v.clone().requires_grad_()
                  for k, v in self.params.items()}
        with exact_float32():
            logits = self.forward(params, embs, ints.to(torch.float32),
                                  self.cfg)
            loss = bce(logits, labels.to(torch.float32)).sum() / B
            names = list(params)
            grads = torch.autograd.grad(
                loss, [params[n] for n in names]
                + [uniq[t][2] for t in self.tables])
        with torch.no_grad():
            for n, g in zip(names, grads):
                t = g * g + self.dense_acc[n]
                self.dense_acc[n] = t
                self.params[n] = self.params[n] - self.d_lr * (
                    g * torch.rsqrt(t + self.d_eps))
            for tname, g in zip(self.tables, grads[len(names):]):
                tab = self.tables[tname]
                _, idx, rows = uniq[tname]
                a = tab.acc[idx] + g * g
                tab.acc[idx] = a
                tab.rows[idx] = (rows.detach() - self.s_lr * g
                                 * torch.rsqrt(a)).to(tab.dtype)
        return float(loss.detach())

    def grad_sq(self) -> Dict[str, float]:
        """Per leaf, the squared norm of the last step's gradient as the
        accumulators hold it (the sum of ``acc - acc0``), read after the
        first step."""
        def held(acc, acc0):
            a0 = torch.tensor(acc0, dtype=torch.float32).double()
            return float((acc.double() - a0).sum())

        d0 = self.cfg["dense_optimizer"]["initial_accumulator_value"]
        out = {n: held(t, d0) for n, t in self.dense_acc.items()}
        out.update({n: held(t.acc, self.s_acc0)
                    for n, t in self.tables.items()})
        return out


def readings(ref: Reference, batches: List[Dict],
             dense0: Dict[str, torch.Tensor]) -> Dict:
    """Run the reference over ``batches`` (three) and read what the
    program is compared on: each step's loss, each leaf's gradient norm
    squared after step 1, each leaf's change after the last step,
    squared (a table's: every key it holds, less the key's first row),
    and the keys each table holds."""
    losses, grad_sq = [], None
    for b in batches:
        losses.append(ref.step(b["ids"], b["ints"], b["labels"]))
        if grad_sq is None:
            grad_sq = ref.grad_sq()
    change_sq = {n: float(((p - dense0[n].to(p.device, torch.float32))
                           .double() ** 2).sum())
                 for n, p in ref.params.items()}
    for name, tab in ref.tables.items():
        d = (tab.rows.to(torch.float32)
             - keylib.init_rows(tab.keys, tab.dim, tab.salt))
        change_sq[name] = float((d.double() ** 2).sum())
    distinct = {name: int(tab.keys.numel())
                for name, tab in ref.tables.items()}
    return {"loss": losses, "grad_sq": grad_sq, "change_sq": change_sq,
            "distinct": distinct}
