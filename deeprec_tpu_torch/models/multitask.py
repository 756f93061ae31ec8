"""The multi-task family, port of ``deeprec_tpu/models/multitask.py``:
``SimpleMultiTask``, ``MMoE``, ``ESMM`` and ``DBMTL``.

Each takes the Criteo embedding dict and the numeric block and returns
a dict of per-task logits; the losses follow each model.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from deeprec_tpu_torch import config as cfglib
from deeprec_tpu_torch.data import criteo as criteo_data
from deeprec_tpu_torch.feature_column.feature_column import (EmbeddingColumn,
                                                             EmbeddingGroup,
                                                             NumericColumn)
from deeprec_tpu_torch.layers.core import MLP, LogitsHead, _linear
from deeprec_tpu_torch.train.losses import bce_with_logits

NUM_INT = 13
NUM_CAT = 26


def criteo_columns(embedding_dim: int = 16, capacity: int = 1 << 16,
                   ev_option=None, reference_shapes: bool = False):
    ev_option = ev_option or cfglib.EmbeddingVariableOption()
    cols = [NumericColumn(f"I{i}") for i in range(1, NUM_INT + 1)]
    cols += [EmbeddingColumn(
        name=f"C{i}", dim=embedding_dim,
        capacity=(criteo_data.capacity_for(
            criteo_data.CRITEO_HASH_BUCKETS[i - 1], ceiling=capacity)
            if reference_shapes else capacity),
        combiner="mean", ev_option=ev_option)
        for i in range(1, NUM_CAT + 1)]
    return cols


def input_width(group: EmbeddingGroup) -> int:
    """Width of the shared input: every embedding and the numerics."""
    return (sum(c.dim for c in group.embedding)
            + sum(c.shape for c in group.numeric))


def _inputs(embs, numeric):
    field = [v for _, v in sorted(embs.items())]
    return torch.cat(field + ([numeric] if numeric is not None else []),
                     dim=1)


class SimpleMultiTask(nn.Module):
    """Shared embeddings, independent per-task towers."""

    def __init__(self, in_features: int, tasks: Sequence[str] = ("ctr", "cvr"),
                 tower: Sequence[int] = (256, 196, 128, 64),
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.tasks = tuple(tasks)
        for t in self.tasks:
            self.add_module(f"tower_{t}", MLP(in_features, tower, dtype=dtype,
                                              device=device))
            self.add_module(f"head_{t}", LogitsHead(tower[-1], device=device))

    def forward(self, embs, numeric) -> Dict[str, torch.Tensor]:
        x = _inputs(embs, numeric)
        return {t: getattr(self, f"head_{t}")(
            F.relu(getattr(self, f"tower_{t}")(x))) for t in self.tasks}


class MMoE(nn.Module):
    """Multi-gate mixture of experts: shared experts, a float32 softmax
    gate per task."""

    def __init__(self, in_features: int, tasks: Sequence[str] = ("ctr", "cvr"),
                 num_experts: int = 4, expert: Sequence[int] = (256, 128),
                 tower: Sequence[int] = (64,),
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.tasks = tuple(tasks)
        self.num_experts = num_experts
        for e in range(num_experts):
            self.add_module(f"expert_{e}", MLP(in_features, expert,
                                               dtype=dtype, device=device))
        for t in self.tasks:
            self.add_module(f"gate_{t}", _linear(in_features, num_experts,
                                                 device))
            self.add_module(f"tower_{t}", MLP(expert[-1], tower, dtype=dtype,
                                              device=device))
            self.add_module(f"head_{t}", LogitsHead(tower[-1], device=device))

    def forward(self, embs, numeric) -> Dict[str, torch.Tensor]:
        x = _inputs(embs, numeric)
        experts = torch.stack(
            [F.relu(getattr(self, f"expert_{e}")(x))
             for e in range(self.num_experts)], dim=1)       # [B, E, H]
        out = {}
        for t in self.tasks:
            gate = torch.softmax(
                getattr(self, f"gate_{t}")(x.to(torch.float32)), dim=1)
            mixed = torch.einsum("be,beh->bh", gate.to(experts.dtype),
                                 experts)
            h = F.relu(getattr(self, f"tower_{t}")(mixed))
            out[t] = getattr(self, f"head_{t}")(h)
        return out


class ESMM(nn.Module):
    """Entire-space multi-task model: pCTR and pCVR towers; the loss
    supervises pCTR on clicks and pCTR * pCVR on conversions."""

    def __init__(self, in_features: int, tower: Sequence[int] = (256, 128, 64),
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.ctr_tower = MLP(in_features, tower, dtype=dtype, device=device)
        self.cvr_tower = MLP(in_features, tower, dtype=dtype, device=device)
        self.ctr_head = LogitsHead(tower[-1], device=device)
        self.cvr_head = LogitsHead(tower[-1], device=device)

    def forward(self, embs, numeric) -> Dict[str, torch.Tensor]:
        x = _inputs(embs, numeric)
        return {"ctr": self.ctr_head(F.relu(self.ctr_tower(x))),
                "cvr": self.cvr_head(F.relu(self.cvr_tower(x)))}


class DBMTL(nn.Module):
    """Shared bottom; the CVR tower also reads the CTR tower's hidden
    state."""

    def __init__(self, in_features: int, bottom: Sequence[int] = (512, 256),
                 tower: Sequence[int] = (128, 64),
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.bottom = MLP(in_features, bottom, dtype=dtype, device=device)
        self.ctr_tower = MLP(bottom[-1], tower, dtype=dtype, device=device)
        self.cvr_tower = MLP(bottom[-1] + tower[-1], tower, dtype=dtype,
                             device=device)
        self.ctr_head = LogitsHead(tower[-1], device=device)
        self.cvr_head = LogitsHead(tower[-1], device=device)

    def forward(self, embs, numeric) -> Dict[str, torch.Tensor]:
        x = _inputs(embs, numeric)
        shared = F.relu(self.bottom(x))
        ctr_h = F.relu(self.ctr_tower(shared))
        cvr_h = F.relu(self.cvr_tower(torch.cat([shared, ctr_h], dim=1)))
        return {"ctr": self.ctr_head(ctr_h), "cvr": self.cvr_head(cvr_h)}


def make_simple(group, **kw):
    return SimpleMultiTask(input_width(group), **kw)


def make_mmoe(group, **kw):
    return MMoE(input_width(group), **kw)


def make_esmm(group, **kw):
    return ESMM(input_width(group), **kw)


def make_dbmtl(group, **kw):
    return DBMTL(input_width(group), **kw)


def apply_fn(module, group: EmbeddingGroup):
    """``fn(params, embs, batch) -> {task: logits [B]}``."""
    def fn(params, embs, batch):
        return torch.func.functional_call(
            module, params, (embs, group.numeric_features(batch)))
    return fn


def multitask_loss(out: Dict[str, torch.Tensor], batch):
    """Sum of the per-task BCEs on ``click`` and ``conversion``."""
    return (bce_with_logits(out["ctr"], batch["click"])
            + bce_with_logits(out["cvr"], batch["conversion"]))


def esmm_loss(out: Dict[str, torch.Tensor], batch):
    """pCTR's BCE plus pCTCVR's over the whole exposure space, pCTCVR =
    pCTR * pCVR clipped to [1e-7, 1 - 1e-7]."""
    p_ctr = torch.sigmoid(out["ctr"].to(torch.float32))
    p_cvr = torch.sigmoid(out["cvr"].to(torch.float32))
    p_ctcvr = torch.clamp(p_ctr * p_cvr, 1e-7, 1 - 1e-7)
    ctr_loss = bce_with_logits(out["ctr"], batch["click"])
    y = batch["conversion"].to(torch.float32)
    ctcvr_loss = -(y * torch.log(p_ctcvr) + (1 - y) * torch.log1p(-p_ctcvr))
    return ctr_loss + ctcvr_loss
