"""Frozen copy of the key arithmetic the tables of the port are defined by.

Written from the specification of ``deeprec_tpu_torch/utils/keys.py``,
``utils/stateless_random.py`` and the coalescing rule of
``feature_column.EmbeddingGroup``, so that the reference derives for
itself which key an id becomes and which row a new key starts from:

* Columns that name one table (``shared_name``) share its rows and
  are one member of it. Tables of one width share a physical table;
  physical tables are numbered in the order of their first column, from
  1 (the table's salt), and the members of a physical table, sorted by
  table name, XOR the two int32 halves of each id with the splitmix64
  salt of their position (both halves forced non-zero); a physical
  table of one member leaves its ids as they are. A salted id that lands
  on a sentinel pair flips bit 1 of its low half. The EMPTY id pads a
  bag or a sequence and is never a key.
* A new key's row is the truncated normal draw of its key: Box-Muller
  over two uint32 hash grids of the key (murmur3 finalizer; salts
  ``2 * table_salt + 1`` and ``+ 2``), clipped to 2 sigma, times
  ``1 / sqrt(dim)``.

uint32 lanes are held in int64 tensors with values in ``[0, 2**32)``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

MASK32 = 0xFFFFFFFF
MASK64 = (1 << 64) - 1
PHI32 = 0x9E3779B9
EMPTY_HI = -(2 ** 31)
EMPTY_LO = 0
TOMB_LO = 1
# The padding id and key: (EMPTY_HI, EMPTY_LO) joined, the int64 minimum.
EMPTY_KEY = EMPTY_HI * (1 << 32) + EMPTY_LO


def member_salt(i: int) -> Tuple[int, int]:
    """(hi, lo) int32 XOR salts of member ``i`` of a shared table."""
    x = ((i + 1) * 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    x ^= x >> 31
    hi, lo = (x >> 32) & MASK32, x & MASK32
    hi, lo = hi or 0x5851F42D, lo or 0x5851F42D
    return tuple(v - (1 << 32) if v >= (1 << 31) else v for v in (hi, lo))


def describe(columns: Sequence) -> List[Dict]:
    """Each embedding column of ``reference/<config>.columns(cfg)`` as
    ``{"name", "dim", "table", "kind", "combiner"}``: a ``(name, dim)``
    pair is a bag of its own table (``table`` = ``name``) whose ids are
    summed; a dict gives ``name`` and ``dim`` and may give ``table`` (a
    shared table's name), ``kind`` (``"bag"`` or ``"sequence"``) and a
    bag's ``combiner`` (``"sum"`` or ``"mean"`` over its real ids)."""
    out = []
    for c in columns:
        d = ({"name": c[0], "dim": c[1]} if isinstance(c, (tuple, list))
             else dict(c))
        d.setdefault("table", d["name"])
        d.setdefault("kind", "bag")
        d.setdefault("combiner", "sum")
        if d["kind"] not in ("bag", "sequence") or d["combiner"] not in (
                "sum", "mean"):
            raise ValueError(f"column {d['name']}: kind {d['kind']!r}, "
                             f"combiner {d['combiner']!r}")
        out.append(d)
    return out


def tables_of(columns: Sequence) -> List[Dict]:
    """Physical tables of ``columns`` (as :func:`describe` takes them, in
    column order): ``[{"dim", "salt", "members": {table name: (salt_hi,
    salt_lo) or None}}]``. A member is a table name: the columns that
    share it are one member, with one salt."""
    dims: Dict[str, int] = {}
    for c in describe(columns):
        if dims.setdefault(c["table"], c["dim"]) != c["dim"]:
            raise ValueError(f"table {c['table']}: columns of two dims")
    by_dim: Dict[int, List[str]] = {}
    for name, dim in dims.items():
        by_dim.setdefault(dim, []).append(name)
    out = []
    for t, (dim, names) in enumerate(by_dim.items()):
        members = ({names[0]: None} if len(names) == 1 else
                   {n: member_salt(i) for i, n in enumerate(sorted(names))})
        out.append({"dim": dim, "salt": t + 1, "members": members})
    return out


def split(ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64 ids -> their (hi, lo) int32 halves."""
    hi = ids >> 32
    lo = ((ids & MASK32) ^ (1 << 31)) - (1 << 31)
    return hi.to(torch.int32), lo.to(torch.int32)


def join(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) int32 halves -> the int64 key."""
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & MASK32)


def salted(ids: torch.Tensor, salt) -> torch.Tensor:
    """int64 keys of a member column's raw int64 ``ids``."""
    hi, lo = split(ids)
    if salt is None:
        return ids
    hi2 = hi ^ salt[0]
    lo2 = lo ^ salt[1]
    hit = (hi2 == EMPTY_HI) & ((lo2 == EMPTY_LO) | (lo2 == TOMB_LO))
    return join(hi2, torch.where(hit, lo2 ^ 2, lo2))


def _u32(x):
    return x.to(torch.int64) & MASK32


def _mul32(h, c: int):
    lo_part = h * (c & 0xFFFF)
    hi_part = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo_part + hi_part) & MASK32


def fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _grid(hi, lo, dim: int, salt: int):
    base = _u32(lo) ^ _mul32(_u32(hi), PHI32)
    base = base ^ ((salt * 0x85EBCA6B) & MASK32)
    cols = _mul32(torch.arange(dim, dtype=torch.int64, device=hi.device),
                  PHI32)[None, :]
    return fmix32(base[:, None] ^ cols)


def _unit(bits):
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24)) + \
        (1.0 / (1 << 25))


def init_rows(keys: torch.Tensor, dim: int, table_salt: int) -> torch.Tensor:
    """float32 [n, dim] first rows of int64 ``keys``."""
    hi, lo = split(keys)
    u1 = _unit(_grid(hi, lo, dim, table_salt * 2 + 1))
    u2 = _unit(_grid(hi, lo, dim, table_salt * 2 + 2))
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return dim ** -0.5 * torch.clamp(z, -2.0, 2.0)


def home_row(keys: torch.Tensor, capacity: int, width: int = 64):
    """The key row of a table of ``capacity`` slots, ``width`` a row,
    where the probe of each key starts (murmur3 of the key, salt 0)."""
    hi, lo = split(keys)
    h = fmix32(_u32(lo) ^ _mul32(_u32(hi), PHI32))
    return (h & (capacity - 1)) // min(width, capacity)
