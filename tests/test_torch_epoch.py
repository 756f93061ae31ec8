"""Port parity: micro-batches, the epoch step and the device step counter.

* ``make_epoch_step`` against the JAX package's, for E = 1 and E = 3 on
  a pool of 6 batches (as ``tests/test_wdl_training.py`` sets it up:
  WDL, dim-8 columns, towers 32/16 in float32, SparseAdagrad and
  Adagrad 0.05, B = 32), from the same tower weights and empty tables:
  losses ``[K]`` / ``[E, K]``, the final step, the tables key by key
  and the dense params. Tolerances are the multi-step ones of
  ``tests/test_torch_train.py``: losses rtol 1e-5; rows, accumulators
  and dense params rtol 1e-5, atol 1e-6; key rows, freqs and versions
  exact.
* ``stack_batches`` and ``batch_at``.
* ``micro_batch_num=4`` against the JAX package's over 3 batches (the
  tolerances above), and against the port's full-batch step as
  ``tests/test_train_features.py`` holds them (losses rtol 1e-5; params
  and tables rtol 1e-4, atol 1e-6).
* A step keeps every state tensor's storage, for every optimizer of
  ``optimizers/sparse.BY_NAME``, dense Adagrad and Adam, and EV, static
  and CBF tables; ``global_step`` as an int and as a 0-dim int32 tensor
  give bit-identical state (a ``GlobalStepEvict`` table's versions
  included).
* On a card (``cuda`` marker): the captured epoch equals the eager loop
  bit for bit.

JAX is imported inside the parity fixtures, so the ``cuda`` test runs
where JAX is not installed: ``python -m pytest --noconftest
tests/test_torch_epoch.py -m cuda``.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import convert
from deeprec_tpu_torch.data import criteo as tcriteo
from deeprec_tpu_torch.feature_column import feature_column as tfc
from deeprec_tpu_torch.models import wdl as twdl
from deeprec_tpu_torch.optimizers import dense as tdense
from deeprec_tpu_torch.optimizers import sparse as tsopt
from deeprec_tpu_torch.train import loop as tloop
from deeprec_tpu_torch.train import losses as tlosses

torch.set_num_threads(1)

B = 32
POOL = 6
HIDDEN = (32, 16)
LOSS_RTOL = 1e-5
TOL = dict(rtol=1e-5, atol=1e-6)
MB_TOL = dict(rtol=1e-4, atol=1e-6)  # tests/test_train_features.py:48-56


def _tloss(o, b):
    return tlosses.bce_with_logits(o, b["label"])


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    import optax

    from deeprec_tpu import config as jcfg
    from deeprec_tpu.feature_column.feature_column import EmbeddingGroup
    from deeprec_tpu.models import wdl
    from deeprec_tpu.optimizers import sparse as sopt
    from deeprec_tpu.train import loop, losses

    return types.SimpleNamespace(jax=jax, jnp=jnp, optax=optax, cfg=jcfg,
                                 Group=EmbeddingGroup, wdl=wdl, sopt=sopt,
                                 loop=loop, losses=losses)


def _pair(jx, n_batches):
    """Both packages' WDL of ``tests/test_wdl_training.py`` (coalesced),
    from the same tower weights: (JAX parts, port parts, raw batches)."""
    data = tcriteo.SyntheticCriteo(B, vocab=500, seed=0)
    raw = [data.next_batch_np(wide=True) for _ in range(n_batches)]
    jg = jx.Group(jx.wdl.criteo_columns(embedding_dim=8, capacity=1 << 12),
                  coalesce=True)
    jmodel = jx.wdl.WDL(hidden=HIDDEN)
    jb = [jg.pack_batch_np(r) for r in raw]
    embs0 = {c.name: jx.jnp.zeros((B, c.dim)) for c in jg.embedding}
    params = jmodel.init(jx.jax.random.key(0), embs0,
                         jg.numeric_features(jb[0]))["params"]
    tx = jx.optax.adagrad(0.05)
    jopt = jx.sopt.SparseAdagrad(0.05)
    jts = jx.loop.create_train_state(jg, params, tx, jopt)
    j = types.SimpleNamespace(
        g=jg, afn=jx.wdl.apply_fn(jmodel, jg), tx=tx, opt=jopt, ts=jts,
        b=jb, loss=lambda o, b: jx.losses.bce_with_logits(o, b["label"]))

    tg = tfc.EmbeddingGroup(
        twdl.criteo_columns(embedding_dim=8, capacity=1 << 12),
        coalesce=True)
    tmodel = twdl.WDL(twdl.input_width(tg), hidden=HIDDEN, device="cpu")
    dopt, topt = tdense.Adagrad(0.05), tsopt.SparseAdagrad(0.05)
    tts = tloop.create_train_state(
        tg, convert.wdl_params_from_numpy(
            jx.jax.tree.map(np.asarray, params)), dopt, topt, device="cpu")
    t = types.SimpleNamespace(
        g=tg, afn=twdl.apply_fn(tmodel, tg), dopt=dopt, opt=topt, ts=tts,
        b=[tg.pack_batch_np(r, "cpu") for r in raw])
    return j, t


def _assert_states_match(jx, jts, tts):
    assert tts.step == int(jts.step)
    for tname, jst in jts.ev.items():
        tst = tts.ev[tname]
        np.testing.assert_array_equal(tst.table.key_rows.numpy(),
                                      np.asarray(jst.table.key_rows))
        np.testing.assert_array_equal(tst.freqs.numpy(),
                                      np.asarray(jst.freqs))
        np.testing.assert_array_equal(tst.versions.numpy(),
                                      np.asarray(jst.versions))
        np.testing.assert_allclose(tst.values.numpy(),
                                   np.asarray(jst.values), **TOL)
        np.testing.assert_allclose(tts.slots[tname]["accum"].numpy(),
                                   np.asarray(jts.slots[tname]["accum"]),
                                   **TOL)
    jp = convert.wdl_params_from_numpy(
        jx.jax.tree.map(np.asarray, jts.params))
    assert set(jp) == set(tts.params)
    for k, v in jp.items():
        np.testing.assert_allclose(tts.params[k].numpy(), v.numpy(), **TOL)


@pytest.fixture(scope="module", params=[1, 3], ids=lambda e: f"E{e}")
def epochs(jx, request):
    E = request.param
    j, t = _pair(jx, POOL)
    jep = jx.loop.make_epoch_step(j.g, j.afn, j.loss, j.opt, j.tx,
                                  donate=False, n_epochs=E)
    jts, jl = jep(j.ts, jx.loop.stack_batches(j.b))
    tep = tloop.make_epoch_step(t.g, t.afn, _tloss, t.opt, t.dopt,
                                n_epochs=E)
    tts, tl = tep(t.ts, tloop.stack_batches(t.b))
    return E, jts, np.asarray(jl), tts, tl


def test_epoch_step_matches_jax(jx, epochs):
    E, jts, jl, tts, tl = epochs
    assert tuple(tl.shape) == jl.shape == ((POOL,) if E == 1 else (E, POOL))
    np.testing.assert_allclose(tl.numpy(), jl, rtol=LOSS_RTOL)
    assert tts.step == E * POOL
    _assert_states_match(jx, jts, tts)


def test_stack_batches_and_batch_at(jx):
    j, t = _pair(jx, 3)
    st = tloop.stack_batches(t.b)
    js = jx.loop.stack_batches(j.b)
    key = tfc.EmbeddingGroup.PACKED_PREFIX + next(iter(t.g.tables))
    assert isinstance(st[key], tfc.SparseIds)
    for name, leaf in st.items():
        fields = leaf if isinstance(leaf, tuple) else (leaf,)
        jfields = js[name] if isinstance(leaf, tuple) else (js[name],)
        for f, jf in zip(fields, jfields):
            assert f.shape[0] == 3
            np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    for k in range(3):
        for at in (tloop.batch_at(st, k),
                   tloop.batch_at(st, torch.tensor([k]))):
            assert set(at) == set(t.b[k])
            for name, leaf in at.items():
                for f, want in zip(*(
                        (x if isinstance(x, tuple) else (x,))
                        for x in (leaf, t.b[k][name]))):
                    assert torch.equal(f, want)


def test_micro_batches_match_jax(jx):
    j, t = _pair(jx, 3)
    jstep = jx.loop.make_train_step(j.g, j.afn, j.loss, j.opt, j.tx,
                                    donate=False, micro_batch_num=4)
    tstep = tloop.make_train_step(t.g, t.afn, _tloss, t.opt, t.dopt,
                                  micro_batch_num=4)
    jts, tts = j.ts, t.ts
    for jb, tb in zip(j.b, t.b):
        jts, jm = jstep(jts, jb)
        tts, tm = tstep(tts, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        assert int(tm["n_overflow"]) == int(jm["n_overflow"])
    _assert_states_match(jx, jts, tts)


def _small_wdl(batch=32):
    from deeprec_tpu_torch import bench

    return bench.build_small("cpu", batch=batch, capacity=1 << 10,
                             hidden=(16, 8), vocab=200)


def test_micro_batches_match_full_batch():
    tr = _small_wdl()
    full = tr.step
    micro = tloop.make_train_step(tr.group, tr.apply_fn, tr.loss_fn,
                                  tr.sparse_opt, tr.dense_opt,
                                  micro_batch_num=4)
    ts1, ts4 = tr.ts, tloop.clone_state(tr.ts)
    for _ in range(3):
        b = tr.next_batch()
        ts1, m1 = full(ts1, b)
        ts4, m4 = micro(ts4, b)
        np.testing.assert_allclose(float(m4["loss"]), float(m1["loss"]),
                                   rtol=LOSS_RTOL)
    for k, v in ts1.params.items():
        np.testing.assert_allclose(ts4.params[k].numpy(), v.numpy(),
                                   **MB_TOL)
    for tname, st in ts1.ev.items():
        assert torch.equal(ts4.ev[tname].table.key_rows, st.table.key_rows)
        np.testing.assert_allclose(ts4.ev[tname].values.numpy(),
                                   st.values.numpy(), **MB_TOL)
    with pytest.raises(ValueError, match="micro_batch_num"):
        tloop.make_train_step(tr.group, tr.apply_fn, tr.loss_fn,
                              tr.sparse_opt, tr.dense_opt,
                              micro_batch_num=2,
                              combine_fn=tr.group.combine_tables)


class _Event:
    def record(self):
        pass


def test_device_counter_path_equals_the_loop(monkeypatch):
    """The card's path with the capture replaced by a direct call: the
    step reads batch k through a device index, stamps the tensor global
    step, writes its loss slot and advances all three itself; it gives
    the CPU loop's bits."""
    tr = _small_wdl()
    pool = tloop.stack_batches([tr.next_batch() for _ in range(3)])
    monkeypatch.setattr(tloop, "_capture", lambda fn, mesh=None: fn)
    monkeypatch.setattr(tloop, "_no_host_sync", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "Event", lambda **kw: _Event())
    epoch = tloop.make_epoch_step(tr.group, tr.apply_fn, tr.loss_fn,
                                  tr.sparse_opt, tr.dense_opt, n_epochs=2)
    loop_ts = tloop.clone_state(tr.ts)
    dev_ts = tloop.clone_state(tr.ts)
    loop_ts, want = epoch(loop_ts, pool)
    got = epoch._captured(dev_ts, pool, 3, 2, torch.device("cpu"))
    assert epoch.last_run["replays"] == 5
    assert torch.equal(got.reshape(2, 3), want)
    a, d = dict(_leaves(loop_ts)), dict(_leaves(dev_ts))
    for p, t in a.items():
        assert torch.equal(t, d[p]), p


# -- the state a step leaves, and the step counter's two forms ------------

def _mixed_group():
    """One EV column with step eviction (versions tracked), one static
    column and one CBF column, each its own table."""
    evict = tcfg.EmbeddingVariableOption(
        evict_option=tcfg.GlobalStepEvict(steps_to_live=2))
    cbf = tcfg.EmbeddingVariableOption(filter_option=tcfg.CBFFilter(
        filter_freq=2, num_counters=256))
    return tfc.EmbeddingGroup([
        tfc.NumericColumn("x"),
        tfc.EmbeddingColumn("e", dim=4, capacity=64, ev_option=evict),
        tfc.EmbeddingColumn("s", dim=4, num_buckets=32, static_bucket=True),
        tfc.EmbeddingColumn("c", dim=4, capacity=64, ev_option=cbf)])


def _linear_apply(params, embs, batch):
    x = torch.cat([embs[n] for n in sorted(embs)]
                  + [batch["x"][:, None]], dim=1)
    return x @ params["w"] + params["b"]


def _mixed_batches(group, n, seed=0):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        raw = {"x": r.normal(size=16).astype(np.float32),
               "label": (r.random(16) < 0.5).astype(np.float32)}
        for c in ("e", "s", "c"):
            ids = r.integers(0, 24, size=(16, 2)).astype(np.int64)
            ids[r.random((16, 2)) < 0.2] = -(2**63)  # EMPTY padding
            raw[c] = ids
        out.append(group.pack_batch_np(raw, "cpu"))
    return out


def _sparse_named(name):
    if name == "adagrad_decay":
        return tsopt.make(name, decay_step=2)  # periods change every 2
    return tsopt.make(name)


def _mixed_state(name, dense):
    group = _mixed_group()
    r = np.random.default_rng(1)
    params = {"w": torch.from_numpy(r.normal(size=13).astype(np.float32)),
              "b": torch.zeros(())}
    sopt = _sparse_named(name)
    dopt = tdense.Adagrad(0.05) if dense == "adagrad" else tdense.Adam(0.01)
    ts = tloop.create_train_state(group, params, dopt, sopt, device="cpu")
    body = tloop._train_body(group, _linear_apply, _tloss, sopt, dopt, 1,
                             None)
    return group, ts, body


def _leaves(x, path=""):
    if isinstance(x, torch.Tensor):
        yield path, x
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{path}/{k}")
    elif hasattr(x, "__dataclass_fields__"):
        for k in x.__dataclass_fields__:
            yield from _leaves(getattr(x, k), f"{path}.{k}")


SPARSE_NAMES = sorted(set(tsopt.BY_NAME) - {"gradient_descent"})


@pytest.mark.parametrize("name", SPARSE_NAMES)
def test_step_keeps_every_state_tensor(name):
    for dense in ("adagrad", "adam"):
        group, ts, _ = _mixed_state(name, dense)
        step = tloop.make_train_step(group, _linear_apply, _tloss,
                                     _sparse_named(name),
                                     tdense.Adagrad(0.05) if dense ==
                                     "adagrad" else tdense.Adam(0.01))
        before = {p: (t, t.data_ptr()) for p, t in _leaves(ts)}
        snapshot = {p: t.clone() for p, (t, _) in before.items()}
        for b in _mixed_batches(group, 2):
            ts, _ = step(ts, b)
        after = dict(_leaves(ts))
        assert set(after) == set(before)
        for p, (t, ptr) in before.items():
            assert after[p] is t and t.data_ptr() == ptr, p
        changed = {p for p in after if not torch.equal(after[p],
                                                       snapshot[p])}
        assert {".ev/e.values", ".ev/s.values", ".ev/c.values"} <= changed
        if "adam" in name:
            assert ".slots/e/beta1_power" in changed
        if dense == "adam":
            assert ".dense_opt/count" in changed


@pytest.mark.parametrize("name", SPARSE_NAMES)
def test_global_step_int_and_tensor_bit_identical(name):
    group, ts_int, body = _mixed_state(name, "adam")
    ts_dev = tloop.clone_state(ts_int)
    for i, b in enumerate(_mixed_batches(group, 4, seed=2)):
        gs = 5 + 2 * i  # steps apart: eviction and decay periods move
        m_int = body(ts_int, b, gs)
        m_dev = body(ts_dev, b, torch.tensor(gs, dtype=torch.int32))
        assert torch.equal(m_int["loss"], m_dev["loss"])
    a, d = dict(_leaves(ts_int)), dict(_leaves(ts_dev))
    assert set(a) == set(d)
    for p, t in a.items():
        assert torch.equal(t, d[p]), p
    versions = ts_dev.ev["e"].versions
    assert int(versions.max()) == 11 and int((versions >= 0).sum()) > 1
    # The versions the two forms wrote drive the same eviction.
    assert torch.equal(group.shrink(ts_int.ev, 14)["e"].table.key_rows,
                       group.shrink(ts_dev.ev, 14)["e"].table.key_rows)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sparse", ["adagrad", "adam"])
def test_captured_epoch_equals_eager_loop(cuda_device, sparse):
    from deeprec_tpu_torch import bench

    tr = bench.build_small(cuda_device, sparse_opt=sparse, batch=256)
    if sparse == "adam":
        tr.dense_opt = tdense.Adam(0.01)
        tr.ts.dense_opt = tr.dense_opt.init(tr.ts.params)
    pool = [tr.next_batch() for _ in range(4)]
    eager, graph = tloop.clone_state(tr.ts), tloop.clone_state(tr.ts)
    step = tloop.make_train_step(tr.group, tr.apply_fn, tr.loss_fn,
                                 tr.sparse_opt, tr.dense_opt)
    want = []
    for _ in range(2):
        for b in pool:
            eager, m = step(eager, b)
            want.append(m["loss"])
    epoch = tloop.make_epoch_step(tr.group, tr.apply_fn, tr.loss_fn,
                                  tr.sparse_opt, tr.dense_opt, n_epochs=2)
    graph, losses = epoch(graph, tloop.stack_batches(pool))
    torch.cuda.synchronize()
    assert epoch.last_run["replays"] == 7
    assert torch.equal(losses, torch.stack(want).reshape(2, 4))
    assert graph.step == eager.step == 8
    a, g = dict(_leaves(eager)), dict(_leaves(graph))
    for p, t in a.items():
        assert torch.equal(t, g[p]), p
