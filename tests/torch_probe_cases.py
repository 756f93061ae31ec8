"""Hash-table probe cases shared by the parity tests and ``chip_smoke.py``.

Each case is a table capacity and a sequence of operations on a table
that starts empty:

* ``("insert", ids, mask)``: ``find_or_insert`` of int64 ``ids`` with
  the bool insert ``mask``;
* ``("find", ids)``: ``find`` of ``ids``;
* ``("remove", slots)``: tombstone the given slots (as eviction does).

The cases cover what decides the probe's outcome: duplicates, padding
and the other sentinel ids, lookup-only ids, collisions in one bucket
row (claims lost round after round), more ids pending after the fast
round than a straggler round takes, tombstones, a table filled until
ids run into the round cap, a one-row table, and dead ids (inserts
whose window has no free slot) ahead of and among live ones. Numpy
only.
"""

from __future__ import annotations

import numpy as np

EMPTY = np.iinfo(np.int64).min
TOMB = EMPTY + 1
_M32 = np.uint64(0xFFFFFFFF)


def _fmix32(h):
    h = h ^ (h >> np.uint64(16))
    h = (h * np.uint64(0x85EBCA6B)) & _M32
    h = h ^ (h >> np.uint64(13))
    h = (h * np.uint64(0xC2B2AE35)) & _M32
    return h ^ (h >> np.uint64(16))


def start_rows(ids, capacity: int) -> np.ndarray:
    """Bucket row each id's probe starts at (``keys.bucket_of``, salt 0,
    over rows of ``min(64, capacity)`` slots)."""
    u = np.asarray(ids, np.int64).view(np.uint64)
    hi, lo = u >> np.uint64(32), u & _M32
    h = _fmix32(lo ^ ((hi * np.uint64(0x9E3779B9)) & _M32))
    W = min(64, capacity)
    return ((h & np.uint64(capacity - 1)) // np.uint64(W)).astype(np.int64)


def _pad(ids, n):
    return np.concatenate([ids, np.full(n - ids.size, EMPTY, np.int64)])


def _ins(ids, mask=None):
    ids = np.asarray(ids, np.int64)
    return ("insert", ids,
            np.ones(ids.size, bool) if mask is None else np.asarray(mask))


def _same_row(rng, capacity, row, k, lo=1, hi=2**40):
    """``k`` distinct ids whose probe starts at bucket row ``row``."""
    out = []
    while len(out) < k:
        cand = rng.integers(lo, hi, size=1 << 16)
        out.extend(np.unique(cand[start_rows(cand, capacity) == row]).tolist())
        out = list(dict.fromkeys(out))
    return np.asarray(out[:k], np.int64)


def cases() -> dict:
    """``{name: (capacity, [operation, ...])}``."""
    r = np.random.default_rng(42)
    out = {}

    ids = _pad(r.integers(0, 60, size=200) * 7919 - 3000, 256)
    out["duplicates_padding"] = (1024, [_ins(ids), ("find", ids)])

    ids = np.unique(r.integers(-(2**40), 2**40, size=1200))[:920]
    ops = [_ins(_pad(ids[s:s + 256], 256)) for s in range(0, ids.size, 256)]
    absent = r.integers(2**41, 2**42, size=100)
    ops.append(("find", _pad(np.concatenate([ids[::3], absent]), 512)))
    out["chunked_high_load"] = (1024, ops)

    ids = np.unique(r.integers(0, 2**50, size=400))[:256]
    mask = np.ones(256, bool)
    mask[::5] = False                       # lookup-only ids
    out["overflow_lookup_only"] = (128, [_ins(ids, mask), ("find", ids)])

    ids = _pad(np.arange(40, dtype=np.int64) * 3, 64)
    out["single_row"] = (32, [_ins(ids), ("find", ids)])

    # 300 distinct ids of one bucket row with duplicates among 512: each
    # round one claim wins the window's first free slot; the window (two
    # rows, 128 slots) fills and the rest run to the round cap.
    row = _same_row(r, 4096, 17, 300)
    ids = np.concatenate([row, row[:150], r.integers(2**45, 2**46, 62)])
    ids = ids[r.permutation(ids.size)]
    mask = r.random(ids.size) < 0.9
    out["one_bucket_row"] = (4096, [_ins(ids, mask), ("find", ids),
                                    _ins(ids)])

    # 1,024 new ids three times each: ~2,000 duplicates pending after the
    # fast round, more than a straggler round takes (1,024).
    base = np.unique(r.integers(1, 2**52, size=1100))[:1024]
    ids = np.repeat(base, 3)[r.permutation(3072)]
    out["pending_beyond_budget"] = (8192, [_ins(ids), ("find", ids)])

    # A 256-slot table fed 768 distinct ids: full after the first
    # batches, the rest run into the 128-round cap.
    ids = np.unique(r.integers(1, 2**40, size=800))[:768]
    ops = [_ins(ids[s:s + 256]) for s in range(0, 768, 256)]
    ops += [("find", ids[:256]), ("find", ids[512:])]
    out["full_table_to_cap"] = (256, ops)

    # Tombstones: reusable, but no proof of absence on their own.
    ids = np.unique(r.integers(1, 2**40, size=400))[:300]
    new = np.unique(r.integers(2**41, 2**42, size=200))[:150]
    mix = np.concatenate([new, ids[:60], ids[200:260]])
    mix = _pad(mix[r.permutation(mix.size)], 300)
    mask = r.random(300) < 0.8
    out["tombstones"] = (512, [_ins(_pad(ids, 320)),
                               ("remove", np.arange(0, 512, 3)),
                               _ins(mix, mask), ("find", mix),
                               ("find", ids)])

    # Sentinels: EMPTY padding, the TOMBSTONE id, and other ids whose hi
    # half is EMPTY's: never found, never inserted.
    ids = np.concatenate([r.integers(1, 2**40, size=50),
                          [EMPTY, TOMB, EMPTY + 5, EMPTY + 2**31],
                          np.full(10, EMPTY)])
    ids = ids[r.permutation(ids.size)].astype(np.int64)
    out["sentinels"] = (256, [_ins(ids), ("find", ids)])

    # Dead ids (an insert whose two-row window holds neither its key nor
    # a free slot) never get a slot in a call, keep their place among
    # the pending ids and count toward the 1,024 a straggler round
    # takes. A 2,048-slot table is filled exactly (64 ids a row, each
    # placed in its own bucket row), then a few slots become tombstones.
    fill = np.stack([_same_row(r, 2048, row, 64) for row in range(32)])
    tombs = {5: [3, 40, 41], 20: [10, 63]}
    more = {5: [0, 7, 8], 12: [5, 6, 50], 20: [1, 2, 30, 31]}

    def filled(tombs):
        ops = [_ins(fill[:, :32].ravel()), _ins(fill[:, 32:].ravel())]
        return ops + [("remove", np.asarray(
            [row * 64 + c for row, cs in tombs.items() for c in cs]))]

    def new_ids(rows, k):
        """``k`` ids new to the table whose probe starts at ``rows``."""
        cand = r.integers(2**41, 2**42, size=1 << 17)
        return cand[np.isin(start_rows(cand, 2048), rows)][:k]

    def dead_rows(tombs):  # windows {row, row + 1} without a tombstone
        return [q for q in range(32)
                if q not in tombs and (q + 1) % 32 not in tombs]

    def live_rows(tombs):
        return [q for q in range(32) if q in tombs or (q + 1) % 32 in tombs]

    # More dead ids than a round takes ahead of live ones: every round's
    # window is all dead, so the live ids behind it (their windows hold
    # tombstones, so they could claim) keep slot = capacity.
    ids = np.concatenate([new_ids(dead_rows(tombs), 1100),
                          new_ids(live_rows(tombs), 300)])
    out["dead_ahead_of_live"] = (2048, filled(tombs) + [
        _ins(ids), ("find", ids)])

    # Dead ids spread among live inserts, lookup-only ids and present
    # ids: live ids take the 10 tombstones one round after another
    # while the dead ones sit in every window, until every id of the
    # window is dead.
    both = {**tombs, **{k: tombs.get(k, []) + v for k, v in more.items()}}
    dead = new_ids(dead_rows(both), 1400)
    live = new_ids(live_rows(both), 500)
    look = new_ids(list(range(32)), 100)
    ids = np.concatenate([dead, live, look, fill[::3, ::9].ravel()])
    order = r.permutation(ids.size)
    mask = np.ones(ids.size, bool)
    mask[dead.size + live.size:dead.size + live.size + look.size] = False
    out["dead_interleaved"] = (2048, filled(both) + [
        _ins(ids[order], mask[order]), ("find", ids[order])])
    return out


def tombstone(key_rows: np.ndarray, slots) -> np.ndarray:
    """A copy of ``key_rows`` ([capacity // W, 2W] int32) with the live
    keys among ``slots`` replaced by the TOMBSTONE pair, as the JAX
    package's ``hash_table.remove_slots`` does."""
    kp = np.array(key_rows).reshape(-1, 2)
    hi, lo = kp[:, 0], kp[:, 1]
    live = ~((hi == np.int32(-(2**31))) & ((lo == 0) | (lo == 1)))
    sel = np.zeros(kp.shape[0], bool)
    sel[np.asarray(slots)] = True
    kp[sel & live] = (-(2**31), 1)
    return kp.reshape(np.shape(key_rows))
