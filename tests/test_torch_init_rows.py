"""The fresh-row draw P2 (``csrc/init_rows.cu``) and its plain version.

Here, on the CPU, ``init_rows.init_fresh`` runs its plain version: the
rows at the fresh entries' slots must equal the JAX package's
``init_rows`` draw of their ids (atol 1e-6 as in ``test_torch_keys``:
log and cos come from another math library), for every initializer, in
float32 and bfloat16; every other row, row C included, stays bit for bit
as it was. On the card (tests marked ``cuda``, skipped without one; they
import no JAX: ``python -m pytest --noconftest
tests/test_torch_init_rows.py -m cuda``): the kernel against the plain
version on the same inputs, over the initializers, the edge widths,
both dtypes, duplicate occurrences, fresh entries at row C, ragged and
empty n. Zeros, constant and uniform rows must be equal; the normal
kinds within ``NORMAL_ATOL``. Then a training lookup under
``set_sync_debug_mode("error")`` launches it and reads nothing back.
"""

import numpy as np
import pytest
import torch

from deeprec_tpu_torch.ops.kernels import build, init_rows
from deeprec_tpu_torch.utils import keys as keylib

torch.set_num_threads(1)

INITIALIZERS = ["zeros", "constant", "uniform", "normal",
                "truncated_normal"]
EDGE_WIDTHS = (1, 4, 17, 64, 65, 128, 129, 257)
# Kernel vs plain version on the card, normal kinds: the same float32
# operations in the same order, and logf/cosf/sqrtf of the CUDA math
# library on both sides; the bound leaves two float32 ulps at |z| = 2
# (times the scale) for a math library of another CUDA release.
NORMAL_ATOL = 5e-7


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(n, D, C, seed, dev, dtype=torch.float32, fresh_share=0.3):
    """values [C+1, D], then (fresh, slots, qhi, qlo) of n entries whose
    distinct ids sit at distinct slots; ids repeat, and of a fresh id's
    occurrences some (one, several or all) are fresh; some fresh entries
    carry slot C."""
    rng = np.random.default_rng(seed)
    values = torch.from_numpy(rng.standard_normal((C + 1, D)).astype(
        np.float32)).to(dtype).to(dev)
    n_ids = max(1, n // 2)
    ids = rng.integers(-2**63, 2**63 - 1, size=n_ids, dtype=np.int64)
    assert n_ids <= C + 1
    id_slot = rng.permutation(C + 1)[:n_ids]
    id_fresh = rng.random(n_ids) < fresh_share
    occ = rng.integers(0, n_ids, size=n)
    hi, lo = keylib.split_ids(ids[occ])
    fresh = torch.from_numpy(id_fresh[occ] & (rng.random(n) < 0.7)).to(dev)
    slots = torch.from_numpy(id_slot[occ].astype(np.int32)).to(dev)
    return values, (fresh, slots, torch.from_numpy(hi).to(dev),
                    torch.from_numpy(lo).to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("initializer", INITIALIZERS)
def test_plain_version_draws_jax_rows_at_fresh_slots(initializer, dtype):
    # Imported here: the card's machine runs the cuda tests without JAX.
    from deeprec_tpu.utils import stateless_random as jsr
    C, D = 300, 17
    values, (fresh, slots, qhi, qlo) = _case(400, D, C, 3, "cpu", dtype)
    before = values.clone()
    init_rows.init_fresh(values, fresh, slots, qhi, qlo, initializer, 0.3, 5)
    on = (fresh & (slots < C)).numpy()
    want = np.asarray(jsr.init_rows(initializer, qhi.numpy(), qlo.numpy(),
                                    D, 0.3, salt=5))
    written = np.zeros(C + 1, bool)
    written[slots.numpy()[on]] = True
    got = values.float().numpy()
    np.testing.assert_allclose(
        got[slots.numpy()[on]],
        torch.from_numpy(want[on]).to(dtype).float().numpy(),
        rtol=0, atol=1e-6 if dtype == torch.float32 else 1e-2)
    assert not written[C]
    assert torch.equal(values[torch.from_numpy(~written)],
                       before[torch.from_numpy(~written)])


def test_wrapper_takes_cpu_and_cuda_tensors_only():
    values, args = _case(8, 4, 16, 0, "cpu")
    with pytest.raises(ValueError, match="no kernel"):
        init_rows.init_fresh(values.to("meta"), *(a.to("meta") for a in args),
                             "uniform", 0.1, 0)
    assert "init_rows" in build.KERNELS


@pytest.mark.cuda
@pytest.mark.parametrize("initializer", INITIALIZERS)
def test_kernel_matches_plain_on_card(cuda_device, initializer):
    before = init_rows.launches
    cases = [(n, D, C, dtype) for D in EDGE_WIDTHS
             for n, C in ((5, 40), (777, 600), (4099, 100_000))
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(0, 16, 10, torch.float32), (31, 129, 15, torch.float32)]
    for k, (n, D, C, dtype) in enumerate(cases):
        values, args = _case(n, D, C, k, cuda_device, dtype)
        got, want = values.clone(), values.clone()
        init_rows.init_fresh(got, *args, initializer, 0.7, 3)
        init_rows.init_fresh_reference(want, *args, initializer, 0.7, 3)
        if initializer in ("normal", "truncated_normal") and n:
            # bfloat16: a float32 ulp apart may round one bf16 ulp apart.
            atol = NORMAL_ATOL * 0.7 if dtype == torch.float32 else 2**-7
            err = float((got.float() - want.float()).abs().max())
            assert err <= atol, (n, D, C, dtype, err)
        else:
            assert torch.equal(got, want), (n, D, C, dtype)
    assert init_rows.launches - before == sum(1 for c in cases if c[0])


@pytest.mark.cuda
def test_training_lookup_launches_p2_without_sync(cuda_device):
    from deeprec_tpu_torch import config as cfglib
    from deeprec_tpu_torch.embedding import variable as ev
    for record in (False, True):   # LightHeader and version-tracked
        cfg = cfglib.TableConfig(
            name="t", dim=33, capacity=1 << 12,
            ev_option=cfglib.EmbeddingVariableOption(
                record_freq=record, record_version=record))
        state = ev.create(cfg, cuda_device)
        hi, lo = keylib.split_ids(np.random.default_rng(1).integers(
            0, 3000, size=2048).astype(np.int64))
        hi = torch.from_numpy(hi).to(cuda_device)
        lo = torch.from_numpy(lo).to(cuda_device)
        before = init_rows.launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, _ = ev.lookup_train_occ(cfg, state, hi, lo, 1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert init_rows.launches - before == 1
        assert bool(torch.isfinite(state.values).all())
