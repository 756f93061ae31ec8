"""Port parity: ``deeprec_tpu_torch/tools/low_precision.py`` against the
JAX package's ``tools/low_precision.py``.

On the same seeded inputs: int8 ``q`` and float32 ``scale`` bit-equal
for dense trees (per-channel on every axis, round-half-to-even ties
included) and for EV value tables (``quantize_ev_state`` on a restored
table); ``gather_quantized`` and ``dequantize_dense`` bit-equal;
``to_bf16`` casts the same leaves to the same values; the
``Calibrator``'s scales equal with and without ``percentile``; and
``accuracy_delta`` agrees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprec_tpu.embedding import variable as jev
from deeprec_tpu.tools import low_precision as jlp
from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch.embedding import variable as tev
from deeprec_tpu_torch.tools import low_precision as tlp

torch.set_num_threads(1)


def _tree(seed=0):
    r = np.random.default_rng(seed)
    w = r.normal(size=(16, 8)).astype(np.float32)
    w[0, :4] = [0.5, 1.5, -2.5, 127.0]  # ties and the row's own amax
    return {"deep": {"kernel": w, "bias": r.normal(size=8).astype(
                np.float32)},
            "conv": r.normal(size=(3, 4, 5)).astype(np.float32),
            "zero": np.zeros((4, 4), np.float32),
            "step": np.array(3, np.int32),
            "idx": r.integers(0, 9, size=(4, 4)).astype(np.int32)}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _np(x):
    return np.asarray(x.float() if x.dtype == torch.bfloat16 else x) \
        if isinstance(x, torch.Tensor) else np.asarray(
            x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_quantize_tensor_int8_bit_equal(axis):
    w = _tree()["deep"]["kernel"] * 3.0
    jq = jlp.quantize_tensor_int8(jnp.asarray(w), axis=axis)
    tq = tlp.quantize_tensor_int8(torch.from_numpy(w), axis=axis)
    assert tq.q.dtype == torch.int8 and tq.scale.dtype == torch.float32
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    np.testing.assert_array_equal(tq.dequantize().numpy(),
                                  np.asarray(jq.dequantize()))


def test_dense_trees_bit_equal():
    tree = _tree(1)
    jtree = jax.tree.map(jnp.asarray, tree)
    jq, tq = jlp.quantize_dense_int8(jtree), tlp.quantize_dense_int8(
        _to_torch(tree))
    for name, jl in _leaves(jq).items():
        tl = _leaves(tq)[name]
        assert isinstance(tl, tlp.QuantizedTensor) == isinstance(
            jl, jlp.QuantizedTensor), name
        if isinstance(jl, jlp.QuantizedTensor):
            np.testing.assert_array_equal(tl.q.numpy(), np.asarray(jl.q))
            np.testing.assert_array_equal(tl.scale.numpy(),
                                          np.asarray(jl.scale))
        else:
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    jd, td = jlp.dequantize_dense(jq), tlp.dequantize_dense(tq)
    for name, jl in _leaves(jd).items():
        np.testing.assert_array_equal(_leaves(td)[name].numpy(),
                                      np.asarray(jl))
    jb, tb = jlp.to_bf16(jtree), tlp.to_bf16(_to_torch(tree))
    for name, jl in _leaves(jb).items():
        tl = _leaves(tb)[name]
        assert (tl.dtype == torch.bfloat16) == (jl.dtype == jnp.bfloat16)
        np.testing.assert_array_equal(_np(tl), _np(jl), err_msg=name)


def test_ev_values_and_gather_bit_equal():
    cfg = tcfg.TableConfig(name="t", dim=12, capacity=64)
    state = tev.create(cfg, "cpu")
    r = np.random.default_rng(2)
    keys = np.arange(1, 41, dtype=np.int64) * 7919
    tev.import_arrays(cfg, state, {
        "keys": keys, "values": r.normal(size=(40, 12)).astype(np.float32),
        "freqs": np.ones(40, np.int32), "versions": np.zeros(40, np.int32)})
    values = state.values.numpy()
    qstate = tlp.quantize_ev_state(state)
    jqv = jlp.quantize_ev_values(jnp.asarray(values))
    np.testing.assert_array_equal(qstate.values.q.numpy(), np.asarray(jqv.q))
    np.testing.assert_array_equal(qstate.values.scale.numpy(),
                                  np.asarray(jqv.scale))
    assert qstate.values.nbytes() == 65 * (12 + 4)
    assert qstate.table is state.table
    # The JAX function on the JAX EVState type.
    jstate = jev.EVState(table=None, values=jnp.asarray(values), freqs=None,
                         versions=None, default_bank=None, bloom=None)
    jq = jlp.quantize_ev_state(jstate).values
    np.testing.assert_array_equal(np.asarray(jq.q), np.asarray(jqv.q))
    idx = r.integers(0, 65, size=50)
    np.testing.assert_array_equal(
        tlp.gather_quantized(qstate.values, torch.from_numpy(idx)).numpy(),
        np.asarray(jlp.gather_quantized(jqv, jnp.asarray(idx))))


@pytest.mark.parametrize("percentile", [None, 99.0, 50.0])
def test_calibrator_scales_equal(percentile):
    r = np.random.default_rng(3)
    jc, tc = jlp.Calibrator(percentile), tlp.Calibrator(percentile)
    for i in range(3):
        for name in ("h1", "h2"):
            x = (r.normal(size=(8, 5)) * (i + 1)).astype(np.float32)
            jc.observe(name, jnp.asarray(x))
            tc.observe(name, torch.from_numpy(x))
    assert tc.scales() == jc.scales()


def test_accuracy_delta_agrees():
    from deeprec_tpu_torch.train.metrics import batch_auc
    r = np.random.default_rng(4)
    batches = [{"x": r.normal(size=32).astype(np.float32),
                "label": (r.random(32) < 0.5).astype(np.float32)}
               for _ in range(3)]
    w = np.float32(1.7)

    def metric(y, p):
        return float(batch_auc(torch.from_numpy(p), torch.from_numpy(y)))

    want = jlp.accuracy_delta(
        lambda b: jnp.asarray(b["x"]) * w,
        lambda b: jnp.asarray(b["x"]).astype(jnp.bfloat16).astype(
            jnp.float32) * w, batches, metric)
    got = tlp.accuracy_delta(
        lambda b: b["x"] * w,
        lambda b: b["x"].to(torch.bfloat16).float() * w,
        [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches],
        metric)
    assert got == want
