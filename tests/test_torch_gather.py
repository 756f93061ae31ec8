"""Row gather: the port's plain version against the JAX package's Pallas
kernel (interpret mode, as the JAX tests run it on the CPU), and the
CUDA kernel against the plain version on the card.

A gather is a copy: every comparison is exact. JAX is imported inside
the parity tests so the ``cuda`` tests run where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_gather.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from deeprec_tpu_torch.ops.kernels import gather

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _table(C1, D, seed):
    r = np.random.default_rng(seed)
    return r.normal(size=(C1, D)).astype(np.float32)


@pytest.mark.parametrize("D", [1, 17, 65, 129])
def test_plain_matches_pallas_interpret(D):
    import jax.numpy as jnp
    from deeprec_tpu.ops.pallas.gather import gather_rows as jgather

    C1, n = 301, 333                      # ragged n: not a tile multiple
    values = _table(C1, D, D)
    r = np.random.default_rng(D + 1)
    slots = r.integers(0, C1 + 40, size=n).astype(np.int32)  # some > C
    want = np.asarray(jgather(jnp.asarray(values), jnp.asarray(slots),
                              interpret=True))
    got = gather.gather_rows(torch.from_numpy(values), torch.from_numpy(slots))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), values[np.minimum(slots, C1 - 1)])


def test_plain_clamps_negative_and_empty():
    values = torch.from_numpy(_table(11, 5, 0))
    slots = torch.tensor([-3, 0, 10, 11, 2**31 - 1], dtype=torch.int32)
    got = gather.gather_rows(values, slots)
    np.testing.assert_array_equal(got.numpy(),
                                  values.numpy()[[0, 0, 10, 10, 10]])
    empty = gather.gather_rows(values, torch.zeros(0, dtype=torch.int32))
    assert empty.shape == (0, 5)


@pytest.mark.parametrize("with_sel", [False, True])
def test_plain_select(with_sel):
    r = np.random.default_rng(3)
    values = _table(41, 9, 4)
    bank = r.normal(size=(3, 9)).astype(np.float32)
    slots = r.integers(-2, 50, size=77).astype(np.int32)
    admitted = r.random(77) < 0.6
    sel = r.integers(0, 3, size=77).astype(np.int32)
    got = gather.gather_rows(
        torch.from_numpy(values), torch.from_numpy(slots),
        torch.from_numpy(admitted), torch.from_numpy(bank),
        torch.from_numpy(sel) if with_sel else None)
    dflt = bank[sel] if with_sel else np.broadcast_to(bank[0], (77, 9))
    want = np.where(admitted[:, None], values[np.clip(slots, 0, 40)], dflt)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_path_launches_nothing():
    before = gather.launches
    gather.gather_rows(torch.zeros(3, 2), torch.zeros(4, dtype=torch.int32))
    assert gather.launches == before


def test_no_fallback_for_other_devices():
    # Only CPU tensors take the plain version; anything else must reach
    # a kernel or raise.
    with pytest.raises(ValueError, match="no kernel"):
        gather.gather_rows(torch.zeros(3, 2, device="meta"),
                           torch.zeros(4, dtype=torch.int32, device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 4, 17, 64, 65, 128, 129, 256, 257])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(cuda_device, D, dtype):
    # n below a warp, ragged against the kernel's 16-row tiles, and
    # empty; the table's last row (C) is read by clamped and exact slots.
    g = torch.Generator(device="cpu").manual_seed(D)
    C1 = 5003
    values = torch.randn(C1, D, generator=g).to(dtype).to(cuda_device)
    bank = torch.randn(4, D, generator=g).to(dtype).to(cuda_device)
    for n in (0, 1, 5, 31, 33, 1000, 4099):
        slots = torch.randint(-5, C1 + 9, (n,), generator=g,
                              dtype=torch.int32)
        slots[-1:] = C1 - 1
        slots = slots.to(cuda_device)
        admitted = (torch.rand(n, generator=g) < 0.5).to(cuda_device)
        sel = torch.randint(0, 4, (n,), generator=g,
                            dtype=torch.int32).to(cuda_device)
        before = gather.launches
        for args in ((), (admitted, bank), (admitted, bank, sel)):
            got = gather.gather_rows(values, slots, *args)
            torch.cuda.synchronize()
            assert torch.equal(got,
                               gather.gather_rows_reference(values, slots,
                                                            *args))
        assert gather.launches == before + (3 if n else 0)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda_device):
    values = torch.zeros(9, 4, device=cuda_device)
    with pytest.raises(TypeError):
        gather.gather_rows(values, torch.zeros(3, dtype=torch.int64,
                                               device=cuda_device))
    with pytest.raises(ValueError):
        gather.gather_rows(values, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        gather.gather_rows(values[:, :2], torch.zeros(3, dtype=torch.int32,
                                                      device=cuda_device))
