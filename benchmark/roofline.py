"""Peaks of the card and the byte models of the port's kernels.

Frozen yardstick. Peaks are NVIDIA's data sheet for the H100 SXM part
(dense rates, no sparsity, at the 700 W limit). The byte models are the
least traffic a kernel's inputs need, each input byte read once and each
output byte written once:

* P1, the hash probe and insert (``csrc/hash_probe.cu``): one 512-byte
  key row (64 slots of two int32 halves) for each distinct row in which
  an id's probe starts, plus 14 bytes an id (its two halves, the insert
  mask, the slot and the new flag written). Padding is not counted.
* K2, the sparse Adagrad apply (``csrc/sparse_apply.cu``): 20 bytes an
  element of an applied row that held a value (read w, acc, g; write w,
  acc) and 16 of a new one (its slot row is not read), plus 6 bytes an
  applied row (its slot, update and new flags).
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference import keys as keylib

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}
KEY_ROW_BYTES = 512
PROBE_ID_BYTES = 14
APPLY_OLD_BYTES = 20
APPLY_NEW_BYTES = 16
APPLY_ROW_BYTES = 6


def probe_bytes(key_rows: int, ids: int) -> int:
    return KEY_ROW_BYTES * key_rows + PROBE_ID_BYTES * ids


def apply_bytes(dim: int, applied: int, fresh: int) -> int:
    return (dim * (APPLY_OLD_BYTES * (applied - fresh)
                   + APPLY_NEW_BYTES * fresh) + APPLY_ROW_BYTES * applied)


def _distinct_per_row(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Distinct values other than ``pad`` in each row of a 2-D int64
    tensor."""
    s, _ = torch.sort(x, dim=1)
    new = torch.ones_like(s, dtype=torch.bool)
    new[:, 1:] = s[:, 1:] != s[:, :-1]
    return (new & (s != pad)).sum(dim=1)


def step_counts(keys: torch.Tensor, capacity: int) -> Dict[str, int]:
    """Over the steps of ``keys`` ([steps, ids of a step] int64 keys of
    one table): the ids, the distinct keys (the rows the apply updates)
    and the distinct key rows where the probes start, each summed.
    Padding (``keys.EMPTY_KEY``, the least int64) is no id."""
    real = keys != keylib.EMPTY_KEY
    rows = keylib.home_row(keys.reshape(-1), capacity).view(keys.shape)
    rows.masked_fill_(~real, -1)
    return {"ids": int(real.sum()),
            "applied": int(_distinct_per_row(keys, keylib.EMPTY_KEY).sum()),
            "key_rows": int(_distinct_per_row(rows, -1).sum())}
