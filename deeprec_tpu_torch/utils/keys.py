"""64-bit feature-id handling: (hi, lo) int32 pairs and id hashing.

Port of ``deeprec_tpu/utils/keys.py``. Ids travel as the two int32
halves of the int64 id, exactly as in the JAX package, so tables and
checkpoints are interchangeable between the two.

The hashes are bit-exact with the JAX ones. PyTorch has no working
uint32 shift or remainder on every backend, so uint32 lanes are held in
int64 tensors with values in ``[0, 2**32)``; :func:`_mul32` keeps every
intermediate product below ``2**63`` so nothing relies on signed
overflow.
"""

from __future__ import annotations

import numpy as np
import torch

# Sentinel halves. EMPTY == int64.min, TOMBSTONE == int64.min + 1.
EMPTY_HI = -(2**31)
EMPTY_LO = 0
TOMB_HI = -(2**31)
TOMB_LO = 1

EMPTY_ID = np.int64(np.iinfo(np.int64).min)
TOMB_ID = np.int64(np.iinfo(np.int64).min + 1)

_MASK32 = 0xFFFFFFFF


def split_ids(ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """int64[n] -> (hi int32[n], lo int32[n]) on host."""
    u = np.asarray(ids, dtype=np.int64).view(np.uint64)
    hi = (u >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return hi, lo


def join_ids(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi, lo) int32 pairs -> int64 ids on host."""
    hi_u = np.asarray(hi, dtype=np.int32).view(np.uint32).astype(np.uint64)
    lo_u = np.asarray(lo, dtype=np.int32).view(np.uint32).astype(np.uint64)
    return ((hi_u << np.uint64(32)) | lo_u).view(np.int64)


def split_ids_tensor(ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int32 ids on any device -> (hi, lo) int32 with ``hi`` the sign
    extension, so :func:`join_ids` gives back the same int64 value
    (``split_ids_jnp`` of the JAX package)."""
    if ids.dtype != torch.int32:
        raise TypeError(f"split_ids_tensor expects int32 ids, got "
                        f"{ids.dtype}; split int64 ids on the host with "
                        "split_ids()")
    return torch.where(ids < 0, -1, 0).to(torch.int32), ids


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 (or int64) lanes -> their uint32 value in int64 lanes
    (negative int32 wraps, as a uint32 cast does)."""
    return x.to(torch.int64) & _MASK32


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2**32`` for uint32 lanes ``h`` and a constant ``c``,
    split in 16-bit halves so no product reaches ``2**63``."""
    lo_part = h * (c & 0xFFFF)
    hi_part = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo_part + hi_part) & _MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """Murmur3 finalizer on uint32 lanes."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_mix(hi: torch.Tensor, lo: torch.Tensor, salt: int = 0):
    """Mix an id pair into a uint32 hash (int64 lanes). Different salts
    give independent hash functions."""
    h = _u32(lo) ^ _mul32(_u32(hi), 0x9E3779B9)
    h = h ^ ((salt * 0x9E3779B9) & _MASK32)
    return _fmix32(h)


def bucket_of(hi, lo, capacity: int, salt: int = 0):
    """Open-addressing start bucket in [0, capacity), int32. capacity
    must be a power of two."""
    return (hash_mix(hi, lo, salt) & (capacity - 1)).to(torch.int32)


def shard_of(hi, lo, num_shards: int):
    """Owner shard of an id (salt 1, independent of the bucket hash)."""
    return (hash_mix(hi, lo, salt=1) % num_shards).to(torch.int32)


def _fmix32_np(h: np.ndarray) -> np.ndarray:
    """numpy mirror of :func:`_fmix32` (uint32 lanes, wrapping)."""
    with np.errstate(over="ignore"):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))


def hash_mix_np(hi: np.ndarray, lo: np.ndarray, salt: int = 0) -> np.ndarray:
    """Host mirror of :func:`hash_mix`, uint32, bit-identical to it."""
    hi_u = np.asarray(hi, np.int32).view(np.uint32)
    lo_u = np.asarray(lo, np.int32).view(np.uint32)
    with np.errstate(over="ignore"):
        h = lo_u ^ (hi_u * np.uint32(0x9E3779B9))
        h = h ^ np.uint32((salt * 0x9E3779B9) & _MASK32)
    return _fmix32_np(h)


def shard_of_np(ids: np.ndarray, num_shards: int) -> np.ndarray:
    """Owner shard of int64 ids on the host, as :func:`shard_of` gives
    it on the device (checkpoint restore onto S shards)."""
    hi, lo = split_ids(np.asarray(ids, np.int64))
    return (hash_mix_np(hi, lo, salt=1) % np.uint32(num_shards)).astype(
        np.int32)


def mod_of(hi, lo, m: int):
    """Exact ``id mod m`` of the uint64 value ``hi*2^32 + lo``, int32.

    int64 lanes hold every partial exactly: ``(hi mod m) * (2^32 mod m)``
    is below ``2^62`` for ``m < 2^31``.
    """
    if not 1 <= m < (1 << 31):
        raise ValueError(f"mod_of requires 1 <= m < 2**31, got {m}")
    lo_u = _u32(lo)
    if m & (m - 1) == 0:
        return (lo_u & (m - 1)).to(torch.int32)
    acc = (_u32(hi) % m) * ((1 << 32) % m) + lo_u % m
    return (acc % m).to(torch.int32)
