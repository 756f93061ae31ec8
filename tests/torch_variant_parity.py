"""Shared runner of the column-variant parity tests: one small model
trained by the JAX package and by the port on the same batches.

The model is a logistic regression over the concatenated column
embeddings (sorted by name): ``logit = x @ w + b``, with ``w`` drawn from a seeded normal and carried to both
packages. Columns are built by ``cols(pkg)`` from either package's
``feature_column`` and ``config`` modules (``pkg.fc``, ``pkg.cfg``);
batches are raw int64 id matrices (EMPTY padding allowed), float
weights and labels, made with numpy.

:func:`run_pair` trains both, step by step, and returns per step the
losses and the lookups' integer routing (adaptive ``hot``,
``newly_hot``, ``bucket``), and at the end both train states and eval
logits on a held-out batch. :func:`assert_states_match` holds the
tables bit for bit on their integer state (key rows, freqs, versions;
so every key sits at the same slot) and slot by slot on their rows and
optimizer slots within ``tol``.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from deeprec_tpu import config as jcfg
from deeprec_tpu.feature_column import feature_column as jfc
from deeprec_tpu.optimizers import sparse as jsopt
from deeprec_tpu.train import loop as jloop
from deeprec_tpu.train import losses as jlosses
from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import convert
from deeprec_tpu_torch.feature_column import feature_column as tfc
from deeprec_tpu_torch.optimizers import dense as tdense
from deeprec_tpu_torch.optimizers import sparse as tsopt
from deeprec_tpu_torch.train import loop as tloop
from deeprec_tpu_torch.train import losses as tlosses

JAX = types.SimpleNamespace(fc=jfc, cfg=jcfg)
PORT = types.SimpleNamespace(fc=tfc, cfg=tcfg)
TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-5
LR = 0.1

SPARSE = {
    "adagrad": lambda: (jsopt.SparseAdagrad(LR), tsopt.SparseAdagrad(LR)),
    "adam": lambda: (jsopt.SparseAdam(0.01), tsopt.SparseAdam(0.01)),
    "adam_async": lambda: (jsopt.SparseAdamAsync(0.01),
                           tsopt.SparseAdamAsync(0.01)),
}


def batches(rng, n, B, specs, vocab=40, pad=0.2):
    """``n`` raw batches: ``specs`` {column: L} of int64 ids below
    ``vocab`` with ``pad`` of them EMPTY (never a whole bag), a weight
    matrix ``<column>_w`` per column in [0, 2) and a label."""
    from deeprec_tpu_torch.utils import keys as keylib
    out = []
    for _ in range(n):
        b = {}
        for c, L in specs.items():
            ids = rng.integers(0, vocab, (B, L)).astype(np.int64)
            empty = rng.random((B, L)) < pad
            empty[:, 0] = False
            b[c] = np.where(empty, keylib.EMPTY_ID, ids)
            b[c + "_w"] = (rng.random((B, L)) * 2).astype(np.float32)
        b["label"] = (rng.random(B) < 0.5).astype(np.float32)
        out.append(b)
    return out


def jax_batch(raw):
    return {k: (jfc.SparseIds.from_numpy(v) if v.dtype == np.int64
                else jnp.asarray(v)) for k, v in raw.items()}


def port_batch(raw):
    return {k: (tfc.SparseIds.from_numpy(v, "cpu") if v.dtype == np.int64
                else torch.from_numpy(v)) for k, v in raw.items()}


def _x_jax(embs):
    return jnp.concatenate([embs[k] for k in sorted(embs)], axis=1)


def _x_port(embs):
    return torch.cat([embs[k] for k in sorted(embs)], dim=1)


def jax_apply(p, embs, b):
    return _x_jax(embs) @ p["w"] + p["b"]


def port_apply(p, embs, b):
    return _x_port(embs) @ p["w"] + p["b"]


def run_pair(cols, raw, sparse="adagrad", eval_raw=None, group_kw=None,
             steps=None):
    """Train the model of ``cols`` on ``raw`` in both packages (the JAX
    step jitted); returns a namespace of ``jg``, ``tg``, ``jts``,
    ``tts``, per-step ``jloss``/``tloss`` and ``jbits``/``tbits``, and
    with ``eval_raw`` the eval logits ``jeval``/``teval``."""
    group_kw = group_kw or {}
    jg = jfc.EmbeddingGroup(cols(JAX), **group_kw)
    tg = tfc.EmbeddingGroup(cols(PORT), **group_kw)
    width = sum(c.dim for c in jg.embedding if not c.name.endswith("#hot"))
    rng = np.random.default_rng(7)
    w = (rng.normal(size=(width,)) * 0.3).astype(np.float32)
    jparams = {"w": jnp.asarray(w), "b": jnp.zeros((), jnp.float32),
               **jg.adaptive_static_params()}
    tstatic = tg.adaptive_static_params("cpu")
    np_params = jax.tree.map(np.asarray, jparams)
    tparams = convert.params_from_numpy(np_params)
    assert set(tparams) == {"w", "b", *tstatic}
    for k, v in tstatic.items():
        np.testing.assert_allclose(v.numpy(), tparams[k].numpy(), **TOL)
    jopt, topt = SPARSE[sparse]()
    tx = optax.adagrad(LR)
    jts = jloop.create_train_state(jg, jparams, tx, jopt)
    jstep = jloop.make_train_step(
        jg, jax_apply, lambda o, b: jlosses.bce_with_logits(o, b["label"]),
        jopt, tx, donate=False)
    dopt = tdense.Adagrad(LR)
    tts = tloop.create_train_state(tg, tparams, dopt, topt, device="cpu")
    tstep = tloop.make_train_step(
        tg, port_apply, lambda o, b: tlosses.bce_with_logits(o, b["label"]),
        topt, dopt)

    @jax.jit
    def jbits(ts, b):
        _, gl = jg.lookup_train(ts.ev, b, ts.step)
        return {cl.table_name: tuple(cl.adp)
                for cl in gl.columns.values() if cl.adp is not None}

    def tbits(ts, b):
        _, gl = tg.lookup_train(tloop.clone_state(ts.ev), b, ts.step)
        return {cl.table_name: tuple(x.numpy() for x in cl.adp)
                for cl in gl.columns.values() if cl.adp is not None}

    out = types.SimpleNamespace(jg=jg, tg=tg, jloss=[], tloss=[], jbits=[],
                                tbits=[], params0={
                                    k: v.clone() for k, v in tparams.items()})
    for r in raw[:steps]:
        jb, tb = jax_batch(r), port_batch(r)
        if jg.adaptive_tables:
            out.jbits.append(jax.tree.map(np.asarray, jbits(jts, jb)))
            out.tbits.append(tbits(tts, tb))
        jts, jm = jstep(jts, jb)
        tts, tm = tstep(tts, tb)
        out.jloss.append(float(jm["loss"]))
        out.tloss.append(float(tm["loss"]))
    out.jts, out.tts = jts, tts
    if eval_raw is not None:
        out.jeval = np.asarray(jloop.make_eval_step(jg, jax_apply)(
            jts, jax_batch(eval_raw)))
        out.teval = tloop.make_eval_step(tg, port_apply)(
            tts, port_batch(eval_raw)).numpy()
    return out


def assert_states_match(jts, tts, tol=TOL):
    """Every table: key rows, freqs and versions bit for bit, rows and
    optimizer slots within ``tol``; dense params within ``tol``."""
    assert set(jts.ev) == set(tts.ev)
    for tname, jst in jts.ev.items():
        tst = tts.ev[tname]
        np.testing.assert_array_equal(tst.table.key_rows.numpy(),
                                      np.asarray(jst.table.key_rows))
        np.testing.assert_array_equal(tst.freqs.numpy(),
                                      np.asarray(jst.freqs))
        np.testing.assert_array_equal(tst.versions.numpy(),
                                      np.asarray(jst.versions))
        np.testing.assert_allclose(tst.values.numpy(),
                                   np.asarray(jst.values), **tol)
        np.testing.assert_array_equal(tst.bloom.numpy(),
                                      np.asarray(jst.bloom))
        tsl = convert.slots_to_numpy({tname: tts.slots[tname]})[tname]
        jsl = jax.tree.map(np.asarray, jts.slots[tname])
        assert set(tsl) == set(jsl)
        for k, v in jsl.items():
            np.testing.assert_allclose(tsl[k], v, **tol)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jts.params))
    assert set(tp) == set(tts.params)
    for k, v in tp.items():
        np.testing.assert_allclose(tts.params[k].numpy(), v.numpy(), **tol)


def assert_run_matches(out, tol=TOL):
    """Losses per step within ``LOSS_RTOL``, adaptive bits bit for bit,
    states (:func:`assert_states_match`) and eval logits within
    ``tol``."""
    np.testing.assert_allclose(out.tloss, out.jloss, rtol=LOSS_RTOL)
    assert all(np.isfinite(out.tloss))
    assert len(out.jbits) == len(out.tbits)
    for jb, tb in zip(out.jbits, out.tbits):
        assert set(jb) == set(tb)
        for t in jb:
            for a, b in zip(jb[t], tb[t]):
                np.testing.assert_array_equal(b, a)
    assert_states_match(out.jts, out.tts, tol)
    if hasattr(out, "jeval"):
        np.testing.assert_allclose(out.teval, out.jeval, **tol)
