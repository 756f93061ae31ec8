"""Port parity: hash-table find / find_or_insert against the JAX package.

Integer state must match bit for bit: key rows, slots and is_new.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_probe_cases as probe_cases
from deeprec_tpu.embedding import hash_table as jht
from deeprec_tpu_torch.embedding import hash_table as tht
from deeprec_tpu_torch.utils import keys as tkeys

torch.set_num_threads(1)

_jfind = jax.jit(jht.find)
_jinsert = jax.jit(jht.find_or_insert)


def _pad(ids, n):
    return np.concatenate([ids, np.full(n - ids.size, tkeys.EMPTY_ID,
                                        np.int64)])


def _step(jtab, ttab, ids, insert_mask=None):
    """One find_or_insert on both sides; asserts bit-equal results."""
    hi, lo = tkeys.split_ids(ids)
    mask = (np.ones(ids.size, bool) if insert_mask is None
            else insert_mask)
    jtab, jslots, jnew = _jinsert(jtab, jnp.asarray(hi), jnp.asarray(lo),
                                  jnp.asarray(mask))
    ttab, tslots, tnew = tht.find_or_insert_reference(
        ttab, torch.from_numpy(hi), torch.from_numpy(lo),
        torch.from_numpy(mask))
    np.testing.assert_array_equal(ttab.key_rows.numpy(),
                                  np.asarray(jtab.key_rows))
    np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
    np.testing.assert_array_equal(tnew.numpy(), np.asarray(jnew))
    return jtab, ttab, tslots.numpy(), tnew.numpy()


def _find_both(jtab, ttab, ids):
    hi, lo = tkeys.split_ids(ids)
    want = np.asarray(_jfind(jtab, jnp.asarray(hi), jnp.asarray(lo)))
    got = tht.find_reference(ttab, torch.from_numpy(hi),
                             torch.from_numpy(lo))
    np.testing.assert_array_equal(got.numpy(), want)
    return got.numpy()


def _fresh(capacity):
    ttab = tht.create(capacity, "cpu")
    jtab = jht.create(capacity)
    np.testing.assert_array_equal(ttab.key_rows.numpy(),
                                  np.asarray(jtab.key_rows))
    return jtab, ttab


def test_duplicates_and_padding():
    jtab, ttab = _fresh(1024)
    r = np.random.default_rng(0)
    ids = r.integers(0, 60, size=200).astype(np.int64) * 7919 - 3000
    ids = _pad(ids, 256)
    _, _, slots, is_new = _step(jtab, ttab, ids)
    real = ids != tkeys.EMPTY_ID
    assert (slots[~real] == 1024).all()
    # one is_new per distinct id; every occurrence shares its slot
    assert is_new.sum() == np.unique(ids[real]).size
    for v in np.unique(ids[real]):
        assert np.unique(slots[ids == v]).size == 1


def test_high_load_chunked_inserts_and_find():
    # ~0.9 load in chunks: later chunks run the straggler (wide) rounds.
    capacity = 1024
    jtab, ttab = _fresh(capacity)
    r = np.random.default_rng(1)
    ids = np.unique(r.integers(-(2**40), 2**40, size=1200))[:920]
    for start in range(0, ids.size, 256):
        chunk = _pad(ids[start:start + 256], 256)
        jtab, ttab, slots, _ = _step(jtab, ttab, chunk)
    assert int(tht.live_mask(ttab).sum()) == np.asarray(
        jht.live_mask(jtab)).sum()
    absent = r.integers(2**41, 2**42, size=100)
    q = _pad(np.concatenate([ids[::3], absent]), 512)
    slots = _find_both(jtab, ttab, q)
    assert (slots[ids[::3].size:] == capacity).all()


def test_overflow_and_lookup_only_ids():
    # More distinct ids than slots: some overflow to the sentinel slot.
    capacity = 128
    jtab, ttab = _fresh(capacity)
    r = np.random.default_rng(2)
    ids = np.unique(r.integers(0, 2**50, size=400))[:256]
    mask = np.ones(256, bool)
    mask[::5] = False                     # lookup-only ids
    jtab, ttab, slots, is_new = _step(jtab, ttab, ids, mask)
    assert (slots == capacity).any()
    assert not is_new[~mask].any()
    _find_both(jtab, ttab, ids)


def test_reinsert_finds_existing():
    jtab, ttab = _fresh(256)
    ids = _pad(np.arange(100, dtype=np.int64) * 31 + 5, 128)
    jtab, ttab, s1, _ = _step(jtab, ttab, ids)
    jtab, ttab, s2, new2 = _step(jtab, ttab, ids[::-1].copy())
    assert not new2.any()
    np.testing.assert_array_equal(s2, s1[::-1])


def test_single_row_table():
    jtab, ttab = _fresh(32)   # capacity <= bucket width: one row
    ids = _pad(np.arange(40, dtype=np.int64) * 3, 64)
    jtab, ttab, _, _ = _step(jtab, ttab, ids)
    _find_both(jtab, ttab, ids)


PROBE_CASES = probe_cases.cases()


@pytest.mark.parametrize("name", sorted(PROBE_CASES))
def test_probe_cases_match_jax(name):
    """The shared probe cases (straggler-heavy batches, one crowded
    bucket row, more ids pending than a round takes, a table run into
    the 128-round cap, tombstones, lookup-only ids, sentinels): slots,
    is_new and key rows bit-exact after every operation."""
    capacity, ops = PROBE_CASES[name]
    jtab, ttab = _fresh(capacity)
    for op in ops:
        if op[0] == "insert":
            jtab, ttab, _, _ = _step(jtab, ttab, op[1], op[2])
        elif op[0] == "find":
            _find_both(jtab, ttab, op[1])
        else:
            sel = np.zeros(capacity, bool)
            sel[op[1]] = True
            jtab = jht.remove_slots(jtab, jnp.asarray(sel))
            ttab.key_rows.copy_(torch.from_numpy(probe_cases.tombstone(
                ttab.key_rows.numpy(), op[1])))
            np.testing.assert_array_equal(ttab.key_rows.numpy(),
                                          np.asarray(jtab.key_rows))
