"""The hash probe kernel P1 (``csrc/hash_probe.cu``) against its plain
version, and the host reads it removes.

On the card: every case of ``torch_probe_cases`` runs through
``hash_table.find_or_insert``/``find`` on CUDA tensors (the kernel) and
through ``find_or_insert_reference``/``find_reference`` on a copy of the
same table on the card; slots, ``is_new`` and key rows must be equal
bit for bit. Then ``find`` and ``lookup_train_occ`` run under
``torch.cuda.set_sync_debug_mode("error")``. Those tests are marked
``cuda`` and skip without a card; they import no JAX:
``python -m pytest --noconftest tests/test_torch_hash_probe.py -m cuda``.
Here, on the CPU: the wrappers refuse CPU tensors, and the table's CPU
path runs the plain version without touching the kernel; the plain
version equals the JAX package on the dead-id cases, and rounds after
the first round whose every id is dead change nothing (the rule that
lets the kernel stop there), on random tables with tombstones.
"""

import numpy as np
import pytest
import torch
from hypothesis import event, given, settings
from hypothesis import strategies as st

import torch_probe_cases as pc
from deeprec_tpu_torch.embedding import hash_table as ht
from deeprec_tpu_torch.ops.kernels import build, hash_probe
from deeprec_tpu_torch.utils import keys as keylib
from deeprec_tpu_torch.utils import trace

torch.set_num_threads(1)
CASES = pc.cases()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ids(ids, dev):
    hi, lo = keylib.split_ids(np.asarray(ids, np.int64))
    return torch.from_numpy(hi).to(dev), torch.from_numpy(lo).to(dev)


def _run_kernel_and_plain(capacity, ops, dev):
    """Each operation through the kernel on one table and through the
    plain version on another, both on ``dev``; asserts equal results,
    and that the kernel ran no more rounds than the plain version (it
    stops at the first round whose every id is dead)."""
    kt = ht.create(capacity, dev)
    pt = ht.create(capacity, dev)
    for op in ops:
        if op[0] == "remove":
            rows = torch.from_numpy(pc.tombstone(kt.key_rows.cpu().numpy(),
                                                 op[1])).to(dev)
            kt.key_rows.copy_(rows)
            pt.key_rows.copy_(rows)
            continue
        hi, lo = _ids(op[1], dev)
        if op[0] == "find":
            got = ht.find(kt, hi, lo)
            want = ht.find_reference(pt, hi, lo)
            assert torch.equal(got, want)
            continue
        mask = torch.from_numpy(op[2]).to(dev)
        (_, s_k, n_k), counters = trace.counted(
            lambda: ht.find_or_insert(kt, hi, lo, mask))
        stats = {}
        _, s_p, n_p = ht.find_or_insert_reference(pt, hi, lo, mask,
                                                  stats=stats)
        assert torch.equal(s_k, s_p)
        assert torch.equal(n_k, n_p)
        assert torch.equal(kt.key_rows, pt.key_rows)
        want = stats["first_dead_round"] or stats["rounds"]
        assert int(counters["probe_rounds"]) == want


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_on_card(cuda_device, name):
    before = dict(hash_probe.launches)
    _run_kernel_and_plain(*CASES[name], cuda_device)
    torch.cuda.synchronize()
    assert hash_probe.launches["find_or_insert"] > before["find_or_insert"]


@pytest.mark.cuda
def test_kernel_matches_plain_at_width(cuda_device):
    """A 2**16-slot table fed three batches of 16,384 ids with
    duplicates and padding, then looked up."""
    r = np.random.default_rng(5)
    ops = []
    for _ in range(3):
        ids = r.integers(1, 60_000, size=16384).astype(np.int64)
        ids[r.random(16384) < 0.05] = pc.EMPTY
        ops.append(("insert", ids, r.random(16384) < 0.95))
    ops.append(("find", r.integers(1, 80_000, size=16384)))
    _run_kernel_and_plain(1 << 16, ops, cuda_device)


@pytest.mark.cuda
def test_kernel_matches_plain_on_shrunk_table_with_mask(cuda_device):
    """A CBF table's inserts after an eviction: a 2**14-slot table with
    GlobalStepEvict filled by ``lookup_train``, shrunk (tombstones in
    the chains), then P1 inserts with an admission mask that leaves about
    a third of the ids out, and a ``delete_keys`` replay through P1's
    ``find``, each against the plain version on a copy."""
    from deeprec_tpu_torch import config as cfglib
    from deeprec_tpu_torch.embedding import lookup as lkup
    from deeprec_tpu_torch.embedding import variable as ev

    cfg = cfglib.TableConfig(
        name="t", dim=4, capacity=1 << 14,
        ev_option=cfglib.EmbeddingVariableOption(
            filter_option=cfglib.CBFFilter(filter_freq=2,
                                           num_counters=1 << 12),
            evict_option=cfglib.GlobalStepEvict(steps_to_live=1)))
    st = ev.create(cfg, cuda_device)
    r = np.random.default_rng(8)
    for step in range(4):
        ids = r.integers(step * 3000, step * 3000 + 6000, size=8192)
        dd = lkup.dedup(*_ids(ids, cuda_device))
        st, _ = ev.lookup_train(cfg, st, dd.uhi, dd.ulo, dd.counts, step)
    live = int(ev.num_live(st))
    ev.shrink(cfg, st, 4)
    assert 0 < int(ev.num_live(st)) < live
    hi, lo = _ids(r.integers(0, 20_000, size=8192), cuda_device)
    mask = torch.from_numpy(r.random(8192) < 0.66).to(cuda_device)
    pt = ht.HashTable(st.table.key_rows.clone())
    _, s_k, n_k = ht.find_or_insert(st.table, hi, lo, mask)
    stats = {}
    _, s_p, n_p = ht.find_or_insert_reference(pt, hi, lo, mask, stats=stats)
    assert torch.equal(s_k, s_p) and torch.equal(n_k, n_p)
    assert torch.equal(st.table.key_rows, pt.key_rows)
    assert bool((s_k[~mask] < cfg.capacity).any())   # found, not inserted
    keys = np.concatenate([r.permutation(20_000)[:9000],
                           r.integers(0, 20_000, size=100)])
    khi, klo = _ids(keys[:8192], cuda_device)
    assert torch.equal(ht.find(st.table, khi, klo),
                       ht.find_reference(st.table, khi, klo))
    before = hash_probe.launches["find"]
    ev.delete_keys(cfg, st, keys)
    # 9,000 distinct keys: two chunks of 8,192, one launch each.
    assert hash_probe.launches["find"] == before + 2
    assert bool((ht.find(st.table, khi, klo) == cfg.capacity).all())


@pytest.mark.cuda
def test_dedup_captures_in_cuda_graph(cuda_device):
    """``lookup.dedup`` reads nothing back to the host: it captures in a
    CUDA graph, and the replay equals the eager result."""
    from deeprec_tpu_torch.embedding import lookup as lkup

    ids = np.random.default_rng(9).integers(-50, 50, size=4096)
    ids[::5] = pc.EMPTY
    hi, lo = _ids(ids, cuda_device)
    want = lkup.dedup(hi, lo)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = lkup.dedup(hi, lo)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_no_host_sync_in_find_and_training_lookup(cuda_device):
    from deeprec_tpu_torch import config as cfglib
    from deeprec_tpu_torch.embedding import variable as ev

    r = np.random.default_rng(6)
    ids = r.integers(1, 5000, size=4096)
    ids[::7] = pc.EMPTY
    hi, lo = _ids(ids, cuda_device)
    for light in (True, False):
        evo = cfglib.EmbeddingVariableOption(record_freq=not light,
                                             record_version=not light)
        cfg = cfglib.TableConfig(name="t", dim=8, capacity=1 << 12,
                                 ev_option=evo)
        st = ev.create(cfg, cuda_device)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for step in range(3):
                st, occ = ev.lookup_train_occ(cfg, st, hi, lo, step,
                                              budget=2048)
            slots = ht.find(st.table, hi, lo)
            rows = ev.lookup(cfg, st, hi, lo)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert bool((slots[torch.from_numpy(ids != pc.EMPTY).to(
            cuda_device)] < cfg.capacity).all())
        assert rows.shape == (4096, 8)


def test_wrappers_take_cuda_tensors_only():
    kr = ht.create(256, "cpu").key_rows
    hi = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel for cpu"):
        hash_probe.find(kr, hi, hi, 2)
    with pytest.raises(ValueError, match="no kernel for cpu"):
        hash_probe.find_or_insert(kr, hi, hi, torch.ones(4, dtype=torch.bool),
                                  hash_probe.claim_buffer(256, "cpu"), 2, 4,
                                  128)


@pytest.mark.parametrize("name", ["one_bucket_row", "full_table_to_cap"])
def test_cpu_tables_take_the_plain_version(name):
    """On the CPU the table runs its plain version and never the kernel
    (which would raise): the same results as calling it directly."""
    before = dict(hash_probe.launches)
    capacity, ops = CASES[name]
    a, b = ht.create(capacity, "cpu"), ht.create(capacity, "cpu")
    for op in ops:
        if op[0] != "insert":
            continue
        hi, lo = _ids(op[1], "cpu")
        mask = torch.from_numpy(op[2])
        _, s1, n1 = ht.find_or_insert(a, hi, lo, mask)
        _, s2, n2 = ht.find_or_insert_reference(b, hi, lo, mask)
        assert torch.equal(s1, s2) and torch.equal(n1, n2)
        assert torch.equal(a.key_rows, b.key_rows)
    assert hash_probe.launches == before


def test_probe_kernel_is_registered():
    import os
    assert "hash_probe" in build.KERNELS
    for name in build.KERNELS:
        assert os.path.exists(os.path.join(build.CSRC_DIR, f"{name}.cu"))


def _plain_run(key_rows, ids, mask, max_rounds=128, stats=None):
    """The plain insert of ``ids`` into a copy of ``key_rows`` (CPU)."""
    table = ht.HashTable(key_rows.clone())
    hi, lo = _ids(ids, "cpu")
    _, slots, is_new = ht.find_or_insert_reference(
        table, hi, lo, torch.from_numpy(mask), max_rounds=max_rounds,
        stats=stats)
    return table.key_rows, slots, is_new


def _table_before(name):
    """Key rows of case ``name`` before its last insert, and that
    insert's ids and mask."""
    capacity, ops = CASES[name]
    table = ht.create(capacity, "cpu")
    last = max(i for i, op in enumerate(ops) if op[0] == "insert")
    for op in ops[:last]:
        if op[0] == "remove":
            table.key_rows.copy_(torch.from_numpy(
                pc.tombstone(table.key_rows.numpy(), op[1])))
        elif op[0] == "insert":
            hi, lo = _ids(op[1], "cpu")
            ht.find_or_insert_reference(table, hi, lo,
                                        torch.from_numpy(op[2]))
    return table.key_rows, ops[last][1], ops[last][2]


@pytest.mark.parametrize("name,first_dead", [("dead_ahead_of_live", 2),
                                             ("dead_interleaved", 8)])
def test_dead_id_cases_match_jax(name, first_dead):
    """The dead-id cases: the plain version equals the JAX package's
    ``find_or_insert`` (slots, is_new, key rows) at the 128-round cap;
    the first round whose every id is dead is the one the case is built
    for. Ahead of live: ids left without a slot include live ones whose
    window holds a tombstone, which a probe that dropped dead ids from
    the pending list would have placed. Interleaved: the live ids took
    every tombstone before the window went all dead."""
    jax = pytest.importorskip("jax")
    from deeprec_tpu.embedding import hash_table as jht

    rows, ids, mask = _table_before(name)
    stats = {}
    got_rows, slots, is_new = _plain_run(rows, ids, mask, stats=stats)
    hi, lo = keylib.split_ids(np.asarray(ids, np.int64))
    jtab, jslots, jnew = jax.jit(jht.find_or_insert)(
        jht.HashTable(key_rows=jax.numpy.asarray(rows.numpy())),
        jax.numpy.asarray(hi), jax.numpy.asarray(lo),
        jax.numpy.asarray(mask))
    np.testing.assert_array_equal(got_rows.numpy(), np.asarray(jtab.key_rows))
    np.testing.assert_array_equal(slots.numpy(), np.asarray(jslots))
    np.testing.assert_array_equal(is_new.numpy(), np.asarray(jnew))
    assert stats == {"rounds": 128, "first_dead_round": first_dead}
    # Live ids left at the cap: not found, with a reusable slot in their
    # wide window.
    capacity = CASES[name][0]
    thi, tlo = _ids(ids, "cpu")
    found, _, has_reuse, _, _ = ht._scan_wide(
        got_rows, thi, tlo, ht._start_slots(thi, tlo, capacity), 64)
    live_left = (slots == capacity) & torch.from_numpy(mask) & has_reuse
    assert not bool(found[slots == capacity].any())
    tombs = sum(op[1].size for op in CASES[name][1] if op[0] == "remove")
    if name == "dead_ahead_of_live":
        assert int(live_left.sum()) == 300 and not bool(is_new.any())
    else:
        assert int(is_new.sum()) == tombs and not bool(live_left.any())


def _random_table(rng, capacity, load, tomb_share):
    """Key rows of a ``capacity``-slot table: about ``load`` of each
    bucket row holds distinct ids that start in that row or the one
    before it, ``tomb_share`` of those slots are tombstones. Returns
    (key rows, ids present, ids never used)."""
    W = min(64, capacity)
    n_rows = capacity // W
    pool = np.unique(rng.integers(1, 2**50, size=40 * capacity))
    pool = pool[rng.permutation(pool.size)]
    starts = pc.start_rows(pool, capacity)
    used = np.zeros(pool.size, bool)
    kp = np.zeros((capacity, 2), np.int64)
    kp[:, 0], kp[:, 1] = pc.EMPTY >> 32, 0
    present = []
    for q in range(n_rows):
        k = int(round(load * W))
        at = rng.choice(W, size=k, replace=False)
        src = np.flatnonzero(~used & ((starts == q)
                                      | (starts == (q - 1) % n_rows)))[:k]
        used[src] = True
        hi, lo = keylib.split_ids(pool[src])
        kp[q * W + at[:src.size], 0] = hi
        kp[q * W + at[:src.size], 1] = lo
        present.append(pool[src])
    rows = kp.astype(np.int32).reshape(n_rows, 2 * W)
    live = np.flatnonzero(kp[:, 0] != (pc.EMPTY >> 32))
    rows = pc.tombstone(rows, live[rng.random(live.size) < tomb_share])
    return torch.from_numpy(rows), np.concatenate(present), pool[~used]


@settings(max_examples=12, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**32 - 1),
       capacity=st.sampled_from([256, 512, 1024]),
       load=st.floats(0.8, 1.0), tomb_share=st.floats(0.0, 0.15),
       n=st.integers(1025, 3000), insert_share=st.floats(0.7, 1.0))
def test_rounds_after_an_all_dead_round_change_nothing(
        seed, capacity, load, tomb_share, n, insert_share):
    """Property (b) of the kernel's header, on the plain version: on a
    random table with tombstones and a batch of 1,025-3,000 ids (new
    ones, present ones, duplicates, lookup-only ones), stopping at the
    first round whose every id is dead, or just before it, gives what
    the 128-round cap gives."""
    rng = np.random.default_rng(seed)
    rows, present, fresh = _random_table(rng, capacity, load, tomb_share)
    k_present = int(n * rng.uniform(0.0, 0.2))
    ids = np.concatenate([rng.choice(present, k_present),
                          fresh[:n - k_present]])
    dup = rng.random(n) < 0.1
    ids[dup] = ids[rng.integers(0, n, int(dup.sum()))]
    mask = rng.random(n) < insert_share
    stats = {}
    want = _plain_run(rows, ids, mask, stats=stats)
    first = stats["first_dead_round"]
    event(f"first all-dead round {'none' if first is None else 'found'}")
    if first is None:
        return
    for max_rounds in (first - 1, first):
        got = _plain_run(rows, ids, mask, max_rounds=max_rounds)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
