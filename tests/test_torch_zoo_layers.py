"""Port parity: the zoo's layers against the JAX package's flax modules.

``fm_interaction``, ``dot_interaction``, ``DINAttention`` (softmax and
sigmoid), ``GRU``, ``AUGRU`` (padded tails), ``TransformerBlock`` (a
masked sequence) and ``softmax_ce_in_batch`` take the same numpy-seeded
inputs on both sides; each flax module's params come from ``init`` and
cross by ``convert.params_from_numpy``. Tolerances: float32 rtol 1e-5 /
atol 1e-5; bfloat16 those of ``tests/test_torch_wdl.py`` (a few bf16
ulps: the frameworks round at other points). The gradients of a scalar
sum of GRU, AUGRU and TransformerBlock outputs, in the params and the
inputs, are held against ``jax.grad`` in float32, at the same
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprec_tpu.layers import core as jcore
from deeprec_tpu.train import losses as jlosses
from deeprec_tpu_torch import convert
from deeprec_tpu_torch.layers import core as tcore
from deeprec_tpu_torch.train import losses as tlosses

torch.set_num_threads(1)

FP32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
B, T, D, H = 6, 5, 8, 6


def _rng(seed=0):
    return np.random.default_rng(seed)


def _mask(r, lens=None):
    lens = r.integers(1, T + 1, size=B) if lens is None else lens
    return np.arange(T)[None, :] < np.asarray(lens)[:, None]


def _tol(dtype):
    return FP32_TOL if dtype == "float32" else BF16_TOL


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _np(x):
    return np.asarray(x.detach().to(torch.float32).numpy())


def _load(tmod, params):
    sd = convert.params_from_numpy(jax.tree.map(np.asarray, params))
    missing = tmod.load_state_dict(sd, strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys
    return sd


def test_fm_interaction():
    x = _rng().normal(size=(B, 7, D)).astype(np.float32)
    want = np.asarray(jcore.fm_interaction(jnp.asarray(x)))
    np.testing.assert_allclose(_np(tcore.fm_interaction(*_t(x))), want,
                               **FP32_TOL)


@pytest.mark.parametrize("self_interaction", [False, True])
def test_dot_interaction(self_interaction):
    x = _rng(1).normal(size=(B, 7, D)).astype(np.float32)
    want = np.asarray(jcore.dot_interaction(jnp.asarray(x),
                                            self_interaction))
    got = tcore.dot_interaction(*_t(x), self_interaction=self_interaction)
    assert got.shape == want.shape == (B, 28 if self_interaction else 21)
    np.testing.assert_allclose(_np(got), want, **FP32_TOL)
    # The triangle's indices are built once per (F, offset, device).
    again = tcore._triu_flat(7, 0 if self_interaction else 1, got.device)
    assert again is tcore._triu_flat(7, 0 if self_interaction else 1,
                                     got.device)


@pytest.mark.parametrize("use_softmax", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_din_attention(use_softmax, dtype):
    r = _rng(2)
    q = r.normal(size=(B, D)).astype(np.float32)
    keys = r.normal(size=(B, T, D)).astype(np.float32)
    mask = _mask(r)
    keys = keys * mask[..., None]
    jm = jcore.DINAttention(hidden=(8, 4), dtype=getattr(jnp, dtype),
                            use_softmax=use_softmax)
    args = (jnp.asarray(q), jnp.asarray(keys), jnp.asarray(mask))
    params = jm.init(jax.random.key(0), *args)["params"]
    want = np.asarray(jm.apply({"params": params}, *args))
    tm = tcore.DINAttention(D, hidden=(8, 4), dtype=getattr(torch, dtype),
                            use_softmax=use_softmax, device="cpu")
    _load(tm, params)
    got = tm(*_t(q, keys, mask))
    np.testing.assert_allclose(_np(got), want, **_tol(dtype))


def _gru_inputs(seed):
    r = _rng(seed)
    x = r.normal(size=(B, T, D)).astype(np.float32)
    # Padded tails of every length, one row full.
    mask = _mask(r, lens=[1, 2, 3, T, 4, 2])
    att = r.uniform(size=(B, T)).astype(np.float32) * mask
    return x, mask, att


def _grads_match(jfn, params, jargs, tmod, targs, sd):
    """The gradient of ``sum(outputs)`` in the params and the first
    input, on both sides."""
    jg_p, jg_x = jax.jit(jax.grad(jfn, argnums=(0, 1)))(params, *jargs)
    tx = targs[0].clone().requires_grad_()
    tp = {k: v.clone().requires_grad_() for k, v in sd.items()}
    out = torch.func.functional_call(tmod, tp, (tx, *targs[1:]))
    total = sum(o.sum() for o in (out if isinstance(out, tuple) else (out,)))
    grads = torch.autograd.grad(total, [tx] + list(tp.values()))
    np.testing.assert_allclose(_np(grads[0]), np.asarray(jg_x), **FP32_TOL)
    want = convert.params_from_numpy(jax.tree.map(np.asarray, jg_p))
    for k, g in zip(tp, grads[1:]):
        np.testing.assert_allclose(_np(g), want[k].numpy(), **FP32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru(dtype):
    x, mask, _ = _gru_inputs(3)
    jm = jcore.GRU(hidden=H, dtype=getattr(jnp, dtype))
    jargs = (jnp.asarray(x), jnp.asarray(mask))
    params = jm.init(jax.random.key(0), *jargs)["params"]
    wo, wf = jm.apply({"params": params}, *jargs)
    tm = tcore.GRU(D, H, dtype=getattr(torch, dtype), device="cpu")
    sd = _load(tm, params)
    go, gf = tm(*_t(x, mask))
    assert go.shape == (B, T, H) and gf.shape == (B, H)
    np.testing.assert_allclose(_np(go), np.asarray(wo, np.float32),
                               **_tol(dtype))
    np.testing.assert_allclose(_np(gf), np.asarray(wf, np.float32),
                               **_tol(dtype))
    # Padded steps output zeros and keep the state.
    assert not go[~torch.from_numpy(mask)].any()
    if dtype == "float32":
        def jfn(p, x_, m_):
            o, f = jm.apply({"params": p}, x_, m_)
            return o.sum() + f.sum()
        _grads_match(jfn, params, jargs, tm, _t(x, mask), sd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_augru(dtype):
    x, mask, att = _gru_inputs(4)
    jm = jcore.AUGRU(hidden=H, dtype=getattr(jnp, dtype))
    jargs = (jnp.asarray(x), jnp.asarray(att), jnp.asarray(mask))
    params = jm.init(jax.random.key(0), *jargs)["params"]
    want = jm.apply({"params": params}, *jargs)
    tm = tcore.AUGRU(D, H, dtype=getattr(torch, dtype), device="cpu")
    sd = _load(tm, params)
    got = tm(*_t(x, att, mask))
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **_tol(dtype))
    if dtype == "float32":
        def jfn(p, x_, a_, m_):
            return jm.apply({"params": p}, x_, a_, m_).sum()
        _grads_match(jfn, params, jargs, tm, _t(x, att, mask), sd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_block(dtype):
    r = _rng(5)
    x = r.normal(size=(B, T, D)).astype(np.float32)
    mask = _mask(r)
    jm = jcore.TransformerBlock(num_heads=2, dtype=getattr(jnp, dtype))
    jargs = (jnp.asarray(x), jnp.asarray(mask))
    params = jm.init(jax.random.key(0), *jargs)["params"]
    assert np.ndim(params["mha"]["query"]["kernel"]) == 3
    want = jm.apply({"params": params}, *jargs)
    tm = tcore.TransformerBlock(D, num_heads=2, dtype=getattr(torch, dtype),
                                device="cpu")
    sd = _load(tm, params)
    assert tm.ln1.eps == 1e-6
    got = tm(*_t(x, mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), **_tol(dtype))
    if dtype == "float32":
        def jfn(p, x_, m_):
            return jm.apply({"params": p}, x_, m_).sum()
        _grads_match(jfn, params, jargs, tm, _t(x, mask), sd)


def test_softmax_ce_in_batch():
    r = _rng(6)
    u = r.normal(size=(B, D)).astype(np.float32)
    v = r.normal(size=(B, D)).astype(np.float32)
    want = np.asarray(jlosses.softmax_ce_in_batch(jnp.asarray(u),
                                                  jnp.asarray(v), 0.2))
    got = tlosses.softmax_ce_in_batch(*_t(u, v), 0.2)
    assert got.shape == (B,)
    np.testing.assert_allclose(_np(got), want, **FP32_TOL)


def test_initializers_draw_flax_distributions():
    """Shapes, orthogonality and scales of the zoo's initializers (the
    draws themselves are the port's own: weights cross by convert)."""
    g = torch.Generator().manual_seed(0)
    q = tcore.orthogonal((H, 3 * H), g)
    assert q.shape == (H, 3 * H)
    np.testing.assert_allclose(_np(q @ q.T), np.eye(H), atol=1e-5)
    q = tcore.orthogonal((3 * H, H), g)
    np.testing.assert_allclose(_np(q.T @ q), np.eye(H), atol=1e-5)
    w = tcore.xavier_uniform((100, 300), g)
    assert float(w.abs().max()) <= (6 / 400) ** 0.5
    assert float(w.std()) == pytest.approx((2 / 400) ** 0.5, rel=0.05)
    p = tcore.normal((200, 50), 0.02, g)
    assert float(p.std()) == pytest.approx(0.02, rel=0.05)
    a = tcore.xavier_uniform((4, 4), torch.Generator().manual_seed(1))
    b = tcore.xavier_uniform((4, 4), torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
