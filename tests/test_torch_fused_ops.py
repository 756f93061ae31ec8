"""Port parity: ``ops/fused.py``, ``lookup.bag_lookup_infer`` and the
device-side ``EmbeddingGroup.pack_batch`` against the JAX package.

* ``fused_l2_normalize``: forward, and the backward through
  ``torch.autograd.grad`` against ``jax.grad`` of the JAX function (its
  hand-written VJP), on rows with all-zero entries (the ``epsilon``
  floor) and along either axis; rtol 1e-6, atol 1e-7 (float32 sums in
  another order).
* ``sparse_segment_sum``, ``_mean`` and ``_sqrtn`` with empty segments
  and out-of-range segment ids (dropped), values and gradients; rtol
  1e-6, atol 1e-7.
* ``bag_lookup_infer`` on a trained table (rows from an Adagrad step;
  unseen ids and padding in the bags): rtol 1e-6, atol 1e-7.
* ``pack_batch`` bit-equal to the JAX ``pack_batch`` and to the port's
  ``pack_batch_np`` on the same raw ids (coalesced EV and static tables),
  with the same recorded widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprec_tpu import config as jcfg
from deeprec_tpu.embedding import lookup as jlookup
from deeprec_tpu.embedding import variable as jev
from deeprec_tpu.feature_column import feature_column as jfc
from deeprec_tpu.ops import fused as jfused
from deeprec_tpu.optimizers import sparse as jsopt
from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch.embedding import lookup as tlookup
from deeprec_tpu_torch.embedding import variable as tev
from deeprec_tpu_torch.feature_column import feature_column as tfc
from deeprec_tpu_torch.ops import fused as tfused
from deeprec_tpu_torch.optimizers import sparse as tsopt

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("axis", [-1, 0])
def test_fused_l2_normalize_forward_and_backward(axis):
    r = np.random.default_rng(0)
    x = r.normal(size=(7, 5)).astype(np.float32)
    x[2] = 0.0           # a zero row: the epsilon floor
    x[:, 3] = 0.0        # a zero column (the rows of axis 0)
    w = r.normal(size=x.shape).astype(np.float32)

    def jloss(a):
        return jnp.sum(jfused.fused_l2_normalize(a, axis) * w)

    jy = np.asarray(jfused.fused_l2_normalize(jnp.asarray(x), axis))
    jg = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    ty = tfused.fused_l2_normalize(tx, axis)
    (tg,) = torch.autograd.grad((ty * torch.from_numpy(w)).sum(), tx)
    np.testing.assert_allclose(ty.detach().numpy(), jy, **TOL)
    np.testing.assert_allclose(tg.numpy(), jg, **TOL)
    assert np.all(np.isfinite(tg.numpy()))


@pytest.mark.parametrize("kind", ["sum", "mean", "sqrtn"])
def test_sparse_segment_reductions(kind):
    r = np.random.default_rng(1)
    data = r.normal(size=(9, 3)).astype(np.float32)
    indices = np.array([0, 3, 3, 8, 1, 5, 2], np.int32)
    # Segments 1 and 4 are empty; -1 and 6 are out of range.
    segs = np.array([0, 0, 2, 2, 3, -1, 6], np.int32)
    w = r.normal(size=(5, 3)).astype(np.float32)
    jfn = getattr(jfused, f"sparse_segment_{kind}")
    tfn = getattr(tfused, f"sparse_segment_{kind}")

    def jloss(d):
        return jnp.sum(jfn(d, jnp.asarray(indices), jnp.asarray(segs), 5)
                       * w)

    jout = np.asarray(jfn(jnp.asarray(data), jnp.asarray(indices),
                          jnp.asarray(segs), 5))
    jg = np.asarray(jax.grad(jloss)(jnp.asarray(data)))
    td = torch.from_numpy(data).requires_grad_()
    tout = tfn(td, torch.from_numpy(indices).long(),
               torch.from_numpy(segs), 5)
    (tg,) = torch.autograd.grad((tout * torch.from_numpy(w)).sum(), td)
    assert tout.shape == (5, 3)
    np.testing.assert_allclose(tout.detach().numpy(), jout, **TOL)
    np.testing.assert_array_equal(tout.detach().numpy()[[1, 4]], 0.0)
    np.testing.assert_allclose(tg.numpy(), jg, **TOL)


def test_unique_ids_is_the_lookup_dedup():
    assert tfused.unique_ids is tlookup.dedup


def test_bag_lookup_infer_on_trained_table():
    kw = dict(name="t", dim=4, capacity=64, combiner="mean")
    jc, tc = jcfg.TableConfig(**kw), tcfg.TableConfig(**kw)
    r = np.random.default_rng(2)
    ids = r.integers(0, 40, size=48).astype(np.int64)
    hi = np.zeros_like(ids, np.int32)
    lo = ids.astype(np.int32)
    # The JAX side jitted: eagerly, each of its ops compiles on its own.
    js, jocc = jax.jit(jev.lookup_train_occ, static_argnums=0,
                       static_argnames="salt")(
        jc, jev.create(jc, salt=1), jnp.asarray(hi), jnp.asarray(lo), 3,
        salt=1)
    ts, tocc = tev.lookup_train_occ(tc, tev.create(tc, "cpu", salt=1),
                                    torch.from_numpy(hi),
                                    torch.from_numpy(lo), 3, salt=1)
    np.testing.assert_array_equal(ts.table.key_rows.numpy(),
                                  np.asarray(js.table.key_rows))
    # One Adagrad step on the looked-up rows: a trained table.
    grads = r.normal(size=tocc.lk.rows.shape).astype(np.float32)
    jo, to = jsopt.SparseAdagrad(0.5), tsopt.SparseAdagrad(0.5)
    _, jvals = jax.jit(jo.apply, static_argnums=0)(
        jc, jo.init(jc), js.values, jocc.lk, jnp.asarray(grads), 3)
    js = js.replace(values=jvals)
    to.apply(tc, to.init(tc, "cpu"), ts.values, tocc.lk,
             torch.from_numpy(grads), 3)
    np.testing.assert_allclose(ts.values.numpy(), np.asarray(js.values),
                               **TOL)
    q = r.integers(0, 60, size=(6, 5)).astype(np.int64)  # unseen ids too
    qhi, qlo = np.zeros(q.shape, np.int32), q.astype(np.int32)
    qhi[:, 4], qlo[:, 4] = -(2**31), 0  # padding: the EMPTY id
    jout = np.asarray(jax.jit(jlookup.bag_lookup_infer, static_argnums=0)(
        jc, js, jnp.asarray(qhi), jnp.asarray(qlo)))
    tout = tlookup.bag_lookup_infer(tc, ts, torch.from_numpy(qhi),
                                    torch.from_numpy(qlo))
    assert tout.shape == (6, 4)
    np.testing.assert_allclose(tout.numpy(), jout, **TOL)


def _columns(m, cfg):
    ev = cfg.EmbeddingVariableOption()
    return [m.NumericColumn("x"),
            m.EmbeddingColumn("a", dim=4, capacity=64, ev_option=ev),
            m.EmbeddingColumn("b", dim=4, capacity=64, ev_option=ev),
            m.EmbeddingColumn("s1", dim=4, num_buckets=50,
                              static_bucket=True),
            m.EmbeddingColumn("s2", dim=4, num_buckets=30,
                              static_bucket=True)]


def test_device_pack_batch_matches_jax_and_host_pack():
    r = np.random.default_rng(3)
    raw = {"x": r.normal(size=8).astype(np.float32),
           "label": (r.random(8) < 0.5).astype(np.float32)}
    for name, width in (("a", 3), ("b", 2), ("s1", 1), ("s2", 2)):
        ids = r.integers(-2**40, 2**40, size=(8, width)).astype(np.int64)
        ids[r.random((8, width)) < 0.25] = -(2**63)  # EMPTY padding
        raw[name] = ids
    jg = jfc.EmbeddingGroup(_columns(jfc, jcfg), coalesce=True)
    tg = tfc.EmbeddingGroup(_columns(tfc, tcfg), coalesce=True)
    hg = tfc.EmbeddingGroup(_columns(tfc, tcfg), coalesce=True)
    jpacked = jg.pack_batch({
        k: (jfc.SparseIds.from_numpy(v) if k not in ("x", "label")
            else jnp.asarray(v)) for k, v in raw.items()})
    tpacked = tg.pack_batch({
        k: (tfc.SparseIds.from_numpy(v, "cpu") if k not in ("x", "label")
            else torch.from_numpy(v)) for k, v in raw.items()})
    hpacked = hg.pack_batch_np(raw, "cpu")
    assert set(tpacked) == set(jpacked) == set(hpacked)
    assert tg._pack_widths == jg._pack_widths == hg._pack_widths
    for k, v in tpacked.items():
        if isinstance(v, tfc.SparseIds):
            for f, jf, hf in zip(v, jpacked[k], hpacked[k]):
                assert f.dtype == torch.int32
                np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
                assert torch.equal(f, hf)
        else:
            assert torch.equal(v, hpacked[k])
