"""Dense building blocks shared by the model zoo.

Port of ``deeprec_tpu/layers/core.py``: the MLP tower, the float32
logits head, the FM and DLRM interactions, DIN's attention unit, the
GRU and attention-update GRU of DIEN, and BST's post-norm transformer
block. With ``dtype=torch.bfloat16`` the parameters stay float32 and
each layer casts its input, weight and bias to bfloat16 before the
product, as flax's ``Dense(dtype=bfloat16, param_dtype=float32)`` does;
the logits head always computes in float32.

Parameter names and layouts follow the flax modules', so ``convert.py``
carries weights across: a ``Dense`` is an ``nn.Linear`` (``weight`` is
the transposed ``kernel``); every other parameter keeps the flax name
and layout (the GRUs' bare matrices, used as ``x @ w``; the attention's
``DenseGeneral`` kernels ``[D, H, Dh]`` and ``[H, Dh, D]``; LayerNorm's
``scale`` and ``bias``).

Layers are built without initialization; call :func:`init_dense` with a
``torch.Generator``, or load a state dict.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _linear(in_features: int, out_features: int, device) -> nn.Linear:
    return nn.utils.skip_init(nn.Linear, in_features, out_features,
                              device=device)


def _param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device))


# -- initializers (drawn on the CPU from an explicit generator) ----------
def xavier_uniform(shape, generator: torch.Generator) -> torch.Tensor:
    """flax ``xavier_uniform`` of a 2-D ``[fan_in, fan_out]`` matrix:
    uniform in +-sqrt(6 / (fan_in + fan_out))."""
    fan_in, fan_out = shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (2.0 * u - 1.0) * limit


def orthogonal(shape, generator: torch.Generator) -> torch.Tensor:
    """flax ``orthogonal`` of a 2-D matrix: Q of the QR of a normal
    matrix (of the taller orientation), columns' signs fixed by R's
    diagonal, transposed back when the matrix is wide."""
    rows, cols = shape
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=generator,
                    dtype=torch.float32)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return q.T.contiguous() if rows < cols else q


def normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    """flax ``normal(std)``."""
    return torch.randn(shape, generator=generator, dtype=torch.float32) * std


def lecun_normal(shape, fan_in: int, generator: torch.Generator):
    """Normal with std 1/sqrt(fan_in) (flax's Dense default up to
    truncation)."""
    return torch.randn(shape, generator=generator,
                       dtype=torch.float32) * fan_in ** -0.5


def init_dense(module: nn.Module, generator: torch.Generator):
    """Initialize every parameter under ``module`` from ``generator``,
    in module order: each ``nn.Linear`` LeCun-normal with a zero bias,
    and each zoo layer with parameters of its own (``init_params``) by
    the flax module's initializers."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                w = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(w * m.in_features ** -0.5)
                m.bias.zero_()
            elif hasattr(m, "init_params"):
                m.init_params(generator)


# -- towers -------------------------------------------------------------
class MLP(nn.Module):
    """Stack of Linear layers named ``dense_0 ..``, ReLU between them
    (none after the last)."""

    def __init__(self, in_features: int, units: Sequence[int],
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.dtype = dtype
        self.n_layers = len(units)
        for i, u in enumerate(units):
            self.add_module(f"dense_{i}", _linear(in_features, u, device))
            in_features = u

    def forward(self, x):
        x = x.to(self.dtype)
        for i in range(self.n_layers):
            layer = getattr(self, f"dense_{i}")
            x = F.linear(x, layer.weight.to(self.dtype),
                         layer.bias.to(self.dtype))
            if i < self.n_layers - 1:
                x = F.relu(x)
        return x


class LogitsHead(nn.Module):
    """Final projection to one logit per row, in float32."""

    def __init__(self, in_features: int, device="cuda"):
        super().__init__()
        self.logits = _linear(in_features, 1, device)

    def forward(self, x):
        return self.logits(x.to(torch.float32))[..., 0]


# -- interactions -------------------------------------------------------
def fm_interaction(field_emb):
    """FM second-order interaction: ``[B, F, D] -> [B, D]``,
    0.5 * ((sum_f v)^2 - sum_f v^2)."""
    s = field_emb.sum(dim=1)
    sq = (field_emb * field_emb).sum(dim=1)
    return 0.5 * (s * s - sq)


_TRIU: Dict[tuple, torch.Tensor] = {}


def _triu_flat(F_: int, k: int, device) -> torch.Tensor:
    """Flat ``i * F + j`` indices of the upper triangle (offset ``k``),
    in ``jnp.triu_indices``' row-major order; built once per (F, k,
    device) on that device."""
    key = (F_, k, str(device))
    idx = _TRIU.get(key)
    if idx is None:
        iu = torch.triu_indices(F_, F_, offset=k, device=device)
        idx = _TRIU[key] = iu[0] * F_ + iu[1]
    return idx


def dot_interaction(field_emb, self_interaction: bool = False):
    """DLRM pairwise dots: ``[B, F, D] -> [B, F*(F-1)/2]`` (``F*(F+1)/2``
    with ``self_interaction``), the upper triangle of one batched
    product."""
    B, F_, _ = field_emb.shape
    z = torch.bmm(field_emb, field_emb.transpose(1, 2))
    idx = _triu_flat(F_, 0 if self_interaction else 1, field_emb.device)
    return z.reshape(B, F_ * F_).index_select(1, idx)


# -- attention ----------------------------------------------------------
class DINAttention(nn.Module):
    """DIN's local activation unit: a score per position from
    MLP([q, k, q-k, q*k]), masked, softmax over the sequence (or a
    masked sigmoid), then the weighted sum of the keys. ``dim`` is the
    keys' width."""

    def __init__(self, dim: int, hidden: Sequence[int] = (80, 40),
                 dtype: torch.dtype = torch.float32,
                 use_softmax: bool = True, device="cuda"):
        super().__init__()
        self.use_softmax = use_softmax
        self.att_mlp = MLP(4 * dim, tuple(hidden) + (1,), dtype=dtype,
                           device=device)

    def forward(self, query, keys, mask):
        """query [B, D], keys [B, T, D], mask [B, T] -> [B, D]."""
        B, T, D = keys.shape
        q = query[:, None, :].expand(B, T, D)
        feats = torch.cat([q, keys, q - keys, q * keys], dim=-1)
        score = self.att_mlp(feats)[..., 0].to(torch.float32)
        score = torch.where(mask, score, torch.finfo(torch.float32).min)
        if self.use_softmax:
            w = torch.softmax(score / math.sqrt(D), dim=1)
        else:
            w = torch.where(mask, torch.sigmoid(score), 0.0)
        return torch.einsum("bt,btd->bd", w.to(keys.dtype), keys)


class _HeadsIn(nn.Module):
    """flax ``DenseGeneral(features=(H, Dh))``: kernel [D, H, Dh], bias
    [H, Dh]; [B, T, D] -> [B, T, H, Dh]."""

    def __init__(self, dim: int, heads: int, head_dim: int, device):
        super().__init__()
        self.kernel = _param((dim, heads, head_dim), device)
        self.bias = _param((heads, head_dim), device)

    def init_params(self, generator):
        self.kernel.copy_(lecun_normal(self.kernel.shape,
                                       self.kernel.shape[0], generator))
        self.bias.zero_()

    def forward(self, x, dtype):
        D, H, Dh = self.kernel.shape
        y = x.to(dtype) @ self.kernel.to(dtype).reshape(D, H * Dh)
        return y.reshape(*x.shape[:-1], H, Dh) + self.bias.to(dtype)


class _HeadsOut(nn.Module):
    """flax ``DenseGeneral(features=D, axis=(-2, -1))``: kernel
    [H, Dh, D], bias [D]; [B, T, H, Dh] -> [B, T, D]."""

    def __init__(self, heads: int, head_dim: int, dim: int, device):
        super().__init__()
        self.kernel = _param((heads, head_dim, dim), device)
        self.bias = _param((dim,), device)

    def init_params(self, generator):
        H, Dh, _ = self.kernel.shape
        self.kernel.copy_(lecun_normal(self.kernel.shape, H * Dh, generator))
        self.bias.zero_()

    def forward(self, x, dtype):
        H, Dh, D = self.kernel.shape
        y = x.reshape(*x.shape[:-2], H * Dh) @ self.kernel.to(dtype).reshape(
            H * Dh, D)
        return y + self.bias.to(dtype)


class MultiHeadAttention(nn.Module):
    """Self-attention as flax's ``MultiHeadDotProductAttention`` computes
    it, in explicit operations: query, key and value projections, the
    query scaled by 1/sqrt(head_dim) before the product, masked logits
    set to ``finfo(dtype).min``, the softmax in the compute dtype
    (``force_fp32_for_softmax=False``), the weighted values, the output
    projection."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"width {dim} does not split into {num_heads} "
                             "heads")
        hd = dim // num_heads
        self.dtype = dtype
        self.query = _HeadsIn(dim, num_heads, hd, device)
        self.key = _HeadsIn(dim, num_heads, hd, device)
        self.value = _HeadsIn(dim, num_heads, hd, device)
        self.out = _HeadsOut(num_heads, hd, dim, device)
        # 1/sqrt(head_dim) as flax rounds it: to the compute dtype.
        self._scale = float(torch.tensor(math.sqrt(hd)).to(dtype))

    def forward(self, x, mask):
        """x [B, T, D], mask [B, T] over the keys -> [B, T, D]."""
        dt = self.dtype
        q = self.query(x, dt) / self._scale
        k = self.key(x, dt)
        v = self.value(x, dt)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        w = torch.where(mask[:, None, None, :], w, torch.finfo(dt).min)
        w = torch.softmax(w, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return self.out(o, dt)


class LayerNorm(nn.Module):
    """flax ``LayerNorm(dtype=float32)``: epsilon 1e-6, the variance as
    E[x^2] - E[x]^2 clipped at 0 (``use_fast_variance``), in float32;
    parameters ``scale`` and ``bias``."""

    def __init__(self, dim: int, eps: float = 1e-6, device="cuda"):
        super().__init__()
        self.eps = eps
        self.scale = _param((dim,), device)
        self.bias = _param((dim,), device)

    def init_params(self, generator):
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        x = x.to(torch.float32)
        mu = x.mean(dim=-1, keepdim=True)
        mu2 = (x * x).mean(dim=-1, keepdim=True)
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        return (x - mu) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


class TransformerBlock(nn.Module):
    """BST's post-norm encoder block: self-attention over the sequence,
    residual and LayerNorm, FFN ``MLP((ff_mult * D, D))``, residual and
    LayerNorm, the output zeroed at masked positions."""

    def __init__(self, dim: int, num_heads: int = 2, ff_mult: int = 4,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.dtype = dtype
        self.mha = MultiHeadAttention(dim, num_heads, dtype=dtype,
                                      device=device)
        self.ln1 = LayerNorm(dim, device=device)
        self.ffn = MLP(dim, (dim * ff_mult, dim), dtype=dtype, device=device)
        self.ln2 = LayerNorm(dim, device=device)

    def forward(self, x, mask):
        """x [B, T, D], mask [B, T] -> [B, T, D] float32."""
        h = self.mha(x.to(self.dtype), mask)
        x = self.ln1(x + h)
        x = self.ln2(x + self.ffn(x))
        return x * mask[..., None].to(x.dtype)


# -- recurrences ----------------------------------------------------------
class GRU(nn.Module):
    """DIEN's interest extractor, as explicit steps over T (not
    ``torch.nn.GRU``, whose gates differ): ``z, r = sigmoid(..)``,
    ``hh = tanh(x Wh + r * (h Uh))``, ``h' = (1 - z) h + z hh``; a masked
    step keeps ``h`` and outputs zeros. The input projections of all T
    steps are one product. Parameters ``wi [D, 3H]``, ``wh [H, 3H]``,
    ``b [3H]`` (gate order z, r, h)."""

    def __init__(self, in_features: int, hidden: int,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
        self.wi = _param((in_features, 3 * hidden), device)
        self.wh = _param((hidden, 3 * hidden), device)
        self.b = _param((3 * hidden,), device)

    def init_params(self, generator):
        self.wi.copy_(xavier_uniform(self.wi.shape, generator))
        self.wh.copy_(orthogonal(self.wh.shape, generator))
        self.b.zero_()

    def forward(self, x, mask):
        """x [B, T, D], mask [B, T] -> (outputs [B, T, H], final [B, H])."""
        dt, H = self.dtype, self.hidden
        B, T, _ = x.shape
        gi = x.to(dt) @ self.wi.to(dt) + self.b.to(dt)          # [B, T, 3H]
        wh = self.wh.to(dt)
        h = torch.zeros((B, H), dtype=dt, device=x.device)
        outs = []
        for t in range(T):
            g = gi[:, t]
            gh = h @ wh
            z = torch.sigmoid(g[:, :H] + gh[:, :H])
            r = torch.sigmoid(g[:, H:2 * H] + gh[:, H:2 * H])
            hh = torch.tanh(g[:, 2 * H:] + r * gh[:, 2 * H:])
            hn = (1 - z) * h + z * hh
            m = mask[:, t, None]
            h = torch.where(m, hn, h)
            outs.append(torch.where(m, hn, 0.0))
        return torch.stack(outs, dim=1), h


class AUGRU(nn.Module):
    """DIEN's interest evolution: a GRU whose update gate is scaled by a
    per-step attention score, as explicit steps over T; a masked step
    keeps ``h``. The input projections of all T steps are one product.
    Parameters ``wz, wr, wh [D, H]``, ``uz, ur, uh [H, H]``, ``bz, br,
    bh [H]``."""

    def __init__(self, in_features: int, hidden: int,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
        for g in "zrh":
            setattr(self, f"w{g}", _param((in_features, hidden), device))
            setattr(self, f"u{g}", _param((hidden, hidden), device))
            setattr(self, f"b{g}", _param((hidden,), device))

    def init_params(self, generator):
        # flax draws in declaration order: wz, uz, bz, wr, ur, br, ...
        for g in "zrh":
            w, u, b = (getattr(self, f"{k}{g}") for k in "wub")
            w.copy_(xavier_uniform(w.shape, generator))
            u.copy_(orthogonal(u.shape, generator))
            b.zero_()

    def forward(self, x, att, mask):
        """x [B, T, D], att [B, T], mask [B, T] -> final state [B, H]."""
        dt, H = self.dtype, self.hidden
        B, T, _ = x.shape
        xw = x.to(dt) @ torch.cat([self.wz, self.wr, self.wh], 1).to(dt)
        uzr = torch.cat([self.uz, self.ur], 1).to(dt)
        uh = self.uh.to(dt)
        bz, br, bh = self.bz.to(dt), self.br.to(dt), self.bh.to(dt)
        at = att.to(dt)
        h = torch.zeros((B, H), dtype=dt, device=x.device)
        for t in range(T):
            xt = xw[:, t]
            hu = h @ uzr
            z = torch.sigmoid(xt[:, :H] + hu[:, :H] + bz)
            r = torch.sigmoid(xt[:, H:2 * H] + hu[:, H:] + br)
            hh = torch.tanh(xt[:, 2 * H:] + (r * h) @ uh + bh)
            z = at[:, t, None] * z
            hn = (1 - z) * h + z * hh
            h = torch.where(mask[:, t, None], hn, h)
        return h
