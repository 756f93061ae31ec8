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
path runs the plain version without touching the kernel.
"""

import numpy as np
import pytest
import torch

import torch_probe_cases as pc
from deeprec_tpu_torch.embedding import hash_table as ht
from deeprec_tpu_torch.ops.kernels import build, hash_probe
from deeprec_tpu_torch.utils import keys as keylib

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
    plain version on another, both on ``dev``; asserts equal results."""
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
        _, s_k, n_k = ht.find_or_insert(kt, hi, lo, mask)
        _, s_p, n_p = ht.find_or_insert_reference(pt, hi, lo, mask)
        assert torch.equal(s_k, s_p)
        assert torch.equal(n_k, n_p)
        assert torch.equal(kt.key_rows, pt.key_rows)


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
