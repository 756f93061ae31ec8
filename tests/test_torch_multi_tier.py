"""Port parity: multi-tier embedding storage against the JAX package.

The same numpy inputs from one seed go through
``deeprec_tpu.embedding.multi_tier`` and
``deeprec_tpu_torch.embedding.multi_tier``:

* ``native.hash64``, ``_NpIndex``, ``HostKV`` and ``DiskKV`` (host code,
  numpy in both) end in the same bits: probe tables, rows, free stacks,
  ``get_batch``, ``coldest`` and ``export``;
* ``TieredTable``: the cases of ``tests/test_multi_tier.py`` (demote and
  promote round trip, LFU, watermarks, resident skipping, ``keep_mask``,
  spill export and import, the three tiers' page-down, promotion from
  disk and reattach) run in both packages; at every demotion and
  promotion the table arrays (key rows, values, freqs, versions), the
  optimizer's slot rows, the spill tiers and ``TierStats`` are equal bit
  for bit;
* ``TieredGroup`` in training (the scenario of
  ``test_end_to_end_training_with_spill``, with weights carried through
  ``convert.py``): losses within 1e-6 a step, tables and spill stores
  key by key (integers exact, rows within 1e-6);
* spill checkpoints cross between the packages in both directions, and
  a restored store, saved again, writes the other package's spill
  arrays exactly.

Small sizes (C = 16-64, D = 4); one CPU thread.
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_mesh_cases as mc
from deeprec_tpu import config as jcfg
from deeprec_tpu import native as jnative
from deeprec_tpu.embedding import hash_table as jht
from deeprec_tpu.embedding import multi_tier as jmt
from deeprec_tpu.embedding import variable as jev
from deeprec_tpu.feature_column import feature_column as jfc
from deeprec_tpu.optimizers import sparse as jsopt
from deeprec_tpu.train import loop as jloop
from deeprec_tpu.train.checkpoint import CheckpointManager as JCkpt
from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import convert
from deeprec_tpu_torch import native as tnative
from deeprec_tpu_torch.embedding import hash_table as tht
from deeprec_tpu_torch.embedding import multi_tier as tmt
from deeprec_tpu_torch.embedding import variable as tev
from deeprec_tpu_torch.feature_column import feature_column as tfc
from deeprec_tpu_torch.optimizers import sparse as tsopt
from deeprec_tpu_torch.train import loop as tloop
from deeprec_tpu_torch.train.checkpoint import CheckpointManager as TCkpt
from deeprec_tpu_torch.utils import keys as keylib

torch.set_num_threads(1)

E2E_TOL = dict(rtol=1e-6, atol=1e-6)


# -- host code ---------------------------------------------------------------

@pytest.mark.parametrize("salt", [0, 1, 2**63 + 5])
def test_hash64_matches_jax(salt):
    ids = np.random.default_rng(0).integers(
        np.iinfo(np.int64).min, np.iinfo(np.int64).max, size=4096,
        dtype=np.int64)
    ids[:2] = (keylib.EMPTY_ID, keylib.TOMB_ID)
    np.testing.assert_array_equal(tnative.hash64(ids, salt),
                                  jnative.hash64(ids, salt))


def _index_state(idx):
    return (idx._cap, idx._n_live, idx._n_tomb, idx._keys.copy(),
            idx._rows.copy())


def _assert_index_equal(a, b):
    sa, sb = _index_state(a), _index_state(b)
    assert sa[:3] == sb[:3]
    np.testing.assert_array_equal(sa[3], sb[3])
    np.testing.assert_array_equal(sa[4], sb[4])


def test_npindex_matches_jax():
    """Inserts that collide and grow the index, deletes that rehash it
    in place (tombstones past a quarter), re-inserts into tombstones."""
    rng = np.random.default_rng(1)
    ids = np.unique(rng.integers(-(2**62), 2**62, size=600))
    rng.shuffle(ids)
    j, t = jmt._NpIndex(cap=8), tmt._NpIndex(cap=8)
    ops = [("insert", ids[:100]), ("insert", ids[100:400]),
           ("delete", ids[50:250]), ("insert", ids[400:450]),
           ("delete", ids[:40]), ("insert", ids[50:120]),
           ("delete", ids[::7])]
    for op, part in ops:
        if op == "insert":
            part = part[j.lookup(part) < 0]
            rows = rng.integers(0, 1 << 20, size=part.size).astype(np.int32)
            j.insert(part, rows)
            t.insert(part, rows)
        else:
            np.testing.assert_array_equal(t.delete(part), j.delete(part))
        _assert_index_equal(j, t)
        np.testing.assert_array_equal(t.lookup(ids), j.lookup(ids))
        np.testing.assert_array_equal(t.live_keys(), j.live_keys())


def _kv_state(kv, prefix=""):
    """Every field of a HostKV/DiskKV: index, free stack, column rows."""
    if kv is None:
        return {}
    out = {prefix + "cap": np.array([kv._cap]),
           prefix + "free": np.array(kv._free, np.int64),
           prefix + "values": np.array(kv._values[:kv._cap]),
           prefix + "freqs": np.array(kv._freqs[:kv._cap]),
           prefix + "versions": np.array(kv._versions[:kv._cap])}
    s = _index_state(kv._index)
    out.update({prefix + "index_meta": np.array(s[:3]),
                prefix + "index_keys": s[3], prefix + "index_rows": s[4]})
    for n, a in kv._slots.items():
        out[f"{prefix}slot/{n}"] = np.array(a[:kv._cap])
    return out


def _assert_dicts_equal(got, want, what=""):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


def _kv_pair(kind, tmp_path):
    shapes, dtypes = {"accum": (4,)}, {"accum": np.float32}
    if kind == "host":
        return (jmt.HostKV(4, shapes, dtypes), tmt.HostKV(4, shapes, dtypes))
    return (jmt.DiskKV(4, shapes, dtypes, str(tmp_path / "j")),
            tmt.DiskKV(4, shapes, dtypes, str(tmp_path / "t")))


@pytest.mark.parametrize("kind", ["host", "disk"])
def test_kv_store_matches_jax(kind, tmp_path):
    """Puts past the first growth, overwrites, deletes and reuse of
    freed rows: every field, ``get_batch``, ``coldest`` and ``export``
    equal; a disk store reattached from its directory too."""
    rng = np.random.default_rng(2)
    j, t = _kv_pair(kind, tmp_path)
    ids = np.unique(rng.integers(1, 1 << 40, size=jmt.HostKV.GROW + 900))
    rng.shuffle(ids)

    def put(part):
        n = part.size
        vals = rng.normal(size=(n, 4)).astype(np.float32)
        args = (part, vals, rng.integers(0, 9, n).astype(np.int32),
                rng.integers(0, 50, n).astype(np.int32),
                {"accum": rng.random((n, 4)).astype(np.float32)})
        j.put_batch(*args)
        t.put_batch(*args)

    put(ids[:1000])
    put(ids[1000:])                        # grows past GROW
    put(ids[500:1500])                     # overwrites
    j.delete_batch(ids[200:900])
    t.delete_batch(ids[200:900])
    put(ids[300:600])                      # reuses freed rows
    _assert_dicts_equal(_kv_state(t), _kv_state(j), kind)
    ask = np.concatenate([ids[::3], [7, 9]])
    for a, b in zip(t.get_batch(ask), j.get_batch(ask)):
        if isinstance(a, dict):
            _assert_dicts_equal(a, b, "slots")
        else:
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.coldest(777), j.coldest(777))
    _assert_dicts_equal(t.export(), j.export(), "export")
    if kind == "disk":
        j.sync()
        t.sync()
        j2, t2 = _kv_pair(kind, tmp_path)
        _assert_dicts_equal(_kv_state(t2), _kv_state(j2), "reattached")
        _assert_by_key(t2.export(), t.export(), "reattached export")


# -- TieredTable: the JAX tests' cases in both packages ----------------------

PAD = 48  # ids a lookup or find of the cases takes, padded
_jax_lookup = jax.jit(jev.lookup_train, static_argnums=0)
_jax_find = jax.jit(jht.find)


class _Side:
    """One package's calls for the TieredTable cases. ``jax`` selects
    the JAX package; the port runs on the CPU. Every method returns the
    (possibly new) state: the JAX package's is functional, the port's
    updates in place."""

    def __init__(self, jax_side: bool):
        self.jax = jax_side
        self.cfgm = jcfg if jax_side else tcfg
        self.mt = jmt if jax_side else tmt

    def cfg(self, capacity, dim=4):
        return self.cfgm.TableConfig(name="t", dim=dim, capacity=capacity,
                                     initializer="zeros")

    def create(self, cfg, opt):
        if self.jax:
            return jev.create(cfg), opt.init(cfg)
        return tev.create(cfg, "cpu"), opt.init(cfg, "cpu")

    def opt(self, name, **kw):
        mod = jsopt if self.jax else tsopt
        return getattr(mod, name)(**kw)

    def _split(self, ids):
        """Ids padded with the EMPTY id to ``PAD`` (one shape for every
        call: the JAX side compiles once a table), as (hi, lo)."""
        ids = np.asarray(ids, np.int64)
        pad = np.full(PAD - ids.size, keylib.EMPTY_ID, np.int64)
        hi, lo = keylib.split_ids(np.concatenate([ids, pad]))
        if self.jax:
            return jnp.asarray(hi), jnp.asarray(lo)
        return torch.from_numpy(hi), torch.from_numpy(lo)

    def lookup(self, cfg, st, ids, step):
        hi, lo = self._split(ids)
        if self.jax:
            return _jax_lookup(cfg, st, hi, lo, jnp.ones(PAD, jnp.int32),
                               jnp.int32(step))
        return tev.lookup_train(cfg, st, hi, lo,
                                torch.ones(PAD, dtype=torch.int32), step)

    def train(self, cfg, st, slots, ids, step):
        """The training lookup of ``ids`` at ``step``, then their rows and
        slot rows set to draws seeded by ``step``: the same bits in both
        packages (their optimizers' arithmetic may differ in the last
        bit; the tiers only move rows)."""
        st, lk = self.lookup(cfg, st, ids, step)
        rng = np.random.default_rng(step)
        n = len(ids)
        rows = rng.normal(size=(n, cfg.dim)).astype(np.float32)
        draws = {k: rng.random((n, cfg.dim)).astype(np.float32)
                 for k in sorted(slots)}
        idx = np.asarray(lk.slots)[:n]
        assert (idx < cfg.capacity).all()
        if self.jax:
            st = st.replace(values=st.values.at[idx].set(rows))
            slots = {k: v.at[idx].set(draws[k]) for k, v in slots.items()}
        else:
            st.values[idx] = torch.from_numpy(rows)
            for k, v in slots.items():
                v[idx] = torch.from_numpy(draws[k])
        return st, slots

    def find(self, st, ids) -> np.ndarray:
        hi, lo = self._split(ids)
        if self.jax:
            return np.asarray(_jax_find(st.table, hi, lo))[:len(ids)]
        return tht.find(st.table, hi, lo).numpy()[:len(ids)]

    def snap(self, st, slots, tiered) -> dict:
        """Table arrays, slot rows, spill tiers and stats, as numpy."""
        if self.jax:
            out = {k: np.asarray(v) for k, v in (
                ("key_rows", st.table.key_rows), ("values", st.values),
                ("freqs", st.freqs), ("versions", st.versions))}
            out.update({f"slot/{k}": np.asarray(v) for k, v in slots.items()})
        else:
            out = {"key_rows": st.table.key_rows.numpy(),
                   "values": st.values.numpy(), "freqs": st.freqs.numpy(),
                   "versions": st.versions.numpy()}
            out.update({f"slot/{k}": v.numpy() for k, v in slots.items()})
        out.update(_kv_state(tiered.host, "host/"))
        out.update(_kv_state(tiered.cold, "cold/"))
        out["stats"] = np.array(dataclasses.astuple(tiered.stats))
        return {k: np.array(v) for k, v in out.items()}


def case_roundtrip(s, tmp):
    cfg = s.cfg(64)
    opt = s.opt("SparseAdagrad", learning_rate=0.1)
    st, slots = s.create(cfg, opt)
    t = s.mt.TieredTable(cfg, slots, policy="lru", high_watermark=0.5,
                         low_watermark=0.25)
    snaps = []
    ids_a = list(range(1, 21))
    st, slots = s.train(cfg, st, slots, ids_a, 0)
    st, slots = s.train(cfg, st, slots, list(range(100, 130)), 1)
    st, slots = t.maybe_demote(st, slots)
    snaps.append(s.snap(st, slots, t))
    demoted = [i for i, sl in zip(ids_a, s.find(st, ids_a))
               if sl == cfg.capacity]
    assert demoted and t.stats.demoted > 0
    payload = t.prepare_promotion(st, np.asarray(demoted, np.int64))
    st, slots = t.apply_promotion(st, slots, payload)
    snaps.append(s.snap(st, slots, t))
    return snaps


def case_lfu(s, tmp):
    cfg = s.cfg(32)
    opt = s.opt("SparseSGD")
    st, slots = s.create(cfg, opt)
    t = s.mt.TieredTable(cfg, slots, policy="lfu", high_watermark=0.5,
                         low_watermark=0.25)
    hot, cold = list(range(1, 9)), list(range(100, 112))
    for step in range(5):
        st, _ = s.lookup(cfg, st, hot, step)
    st, _ = s.lookup(cfg, st, cold, 5)
    st, slots = t.maybe_demote(st, slots)
    assert set(t.host.keys().tolist()) <= set(cold) and len(t.host)
    return [s.snap(st, slots, t)]


def case_watermarks(s, tmp):
    cfg = s.cfg(64)
    opt = s.opt("SparseSGD")
    st, slots = s.create(cfg, opt)
    t = s.mt.TieredTable(cfg, slots, high_watermark=0.75, low_watermark=0.5)
    st, _ = s.lookup(cfg, st, list(range(1, 41)), 0)
    st, slots = t.maybe_demote(st, slots)
    snaps = [s.snap(st, slots, t)]
    st, slots = t.maybe_demote(st, slots)     # under the watermark now
    snaps.append(s.snap(st, slots, t))
    assert t.stats.hbm_live <= int(0.75 * cfg.capacity)
    return snaps


def case_resident_skip(s, tmp):
    """Nothing spilled: no payload. Then a spilled id, a resident id
    whose stale spill copy is dropped, and an unknown id."""
    cfg = s.cfg(32)
    opt = s.opt("SparseSGD")
    st, slots = s.create(cfg, opt)
    t = s.mt.TieredTable(cfg, slots)
    st, _ = s.lookup(cfg, st, [1, 2, 3], 0)
    assert t.prepare_promotion(st, np.array([1, 2, 99], np.int64)) is None
    t.host.put_batch(np.array([5, 2], np.int64),
                     np.arange(8, dtype=np.float32).reshape(2, 4),
                     np.array([3, 4]), np.array([0, 1]), {})
    payload = t.prepare_promotion(st, np.array([1, 5, 2, 99, 5], np.int64))
    assert payload["ids"].tolist() == [5] and 2 not in t.host
    st, slots = t.apply_promotion(st, slots, payload)
    return [s.snap(st, slots, t)]


def case_keep_mask(s, tmp):
    cfg = s.cfg(32)
    opt = s.opt("SparseSGD")
    st, slots = s.create(cfg, opt)
    t = s.mt.TieredTable(cfg, slots, high_watermark=0.5, low_watermark=0.25)
    pinned = list(range(1, 9))
    st, _ = s.lookup(cfg, st, pinned, 0)
    st, _ = s.lookup(cfg, st, list(range(50, 62)), 1)
    pin = np.zeros(cfg.capacity, bool)
    pin[s.find(st, pinned)] = True
    st, slots = t.maybe_demote(st, slots, keep_mask=pin)
    assert (s.find(st, pinned) < cfg.capacity).all()
    return [s.snap(st, slots, t)]


def case_spill_checkpoint(s, tmp):
    cfg = s.cfg(32)
    opt = s.opt("SparseAdagrad")
    st, slots = s.create(cfg, opt)
    t1 = s.mt.TieredTable(cfg, slots)
    t1.host.put_batch(np.array([11, 12], np.int64),
                      np.arange(8, dtype=np.float32).reshape(2, 4),
                      np.array([2, 3]), np.array([7, 8]),
                      {"accum": np.full((2, 4), 0.5, np.float32)})
    t2 = s.mt.TieredTable(cfg, slots)
    t2.import_spill(t1.export_spill())
    return [s.snap(st, slots, t1), s.snap(st, slots, t2)]


def case_three_tier(s, tmp):
    """Waves of ids past host_capacity page down to disk; ids paged all
    the way down come back; the disk tier's directory reattaches."""
    cfg = s.cfg(32)
    opt = s.opt("SparseAdagrad", learning_rate=0.1)
    st, slots = s.create(cfg, opt)
    path = os.path.join(tmp, "jax" if s.jax else "port", "cold")
    t = s.mt.TieredTable(cfg, slots, policy="lru", high_watermark=0.5,
                         low_watermark=0.25, disk_path=path, host_capacity=8)
    snaps = []
    for wave in range(5):
        ids = list(range(100 * wave + 1, 100 * wave + 13))
        st, slots = s.train(cfg, st, slots, ids, wave)
        st, slots = t.maybe_demote(st, slots)
        snaps.append(s.snap(st, slots, t))
    assert t.stats.paged_down > 0 and len(t.cold) and len(t.host) <= 8
    cold_ids = t.cold.keys()[:6]
    st, slots = t.apply_promotion(st, slots,
                                  t.prepare_promotion(st, cold_ids))
    assert (s.find(st, cold_ids) < cfg.capacity).all()
    snaps.append(s.snap(st, slots, t))
    t.cold.sync()
    again = s.mt.DiskKV(cfg.dim, {"accum": (cfg.dim,)},
                        {"accum": np.float32}, path)
    snaps.append(_kv_state(again, "reattached/"))
    return snaps


def case_export_disk(s, tmp):
    cfg = s.cfg(16)
    opt = s.opt("SparseSGD")
    st, slots = s.create(cfg, opt)
    path = os.path.join(tmp, "jax" if s.jax else "port", "cold")
    t = s.mt.TieredTable(cfg, slots, disk_path=path, host_capacity=4)
    ids = np.arange(1, 11, dtype=np.int64)
    t.host.put_batch(ids, np.ones((10, cfg.dim), np.float32),
                     np.ones(10, np.int32), np.arange(10, dtype=np.int32), {})
    t._maybe_page_down()
    blob = t.export_spill()
    assert sorted(blob["keys"].tolist()) == ids.tolist()
    return [s.snap(st, slots, t), blob]


CASES = {"roundtrip_lru": case_roundtrip, "lfu": case_lfu,
         "watermarks": case_watermarks, "resident_skip": case_resident_skip,
         "keep_mask": case_keep_mask, "spill_checkpoint": case_spill_checkpoint,
         "three_tier": case_three_tier, "export_disk": case_export_disk}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiered_table_matches_jax(case, tmp_path):
    want = CASES[case](_Side(True), str(tmp_path))
    got = CASES[case](_Side(False), str(tmp_path))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_dicts_equal(g, w, f"{case} snapshot {i}")


# -- TieredGroup in training; spill checkpoints across packages --------------

def _e2e_columns(fc, cfgm):
    evo = cfgm.EmbeddingVariableOption(storage_option=cfgm.StorageOption(
        storage_type=cfgm.StorageType.HBM_HOST))
    return [fc.EmbeddingColumn(name="f", dim=4, capacity=32,
                               initializer="zeros", combiner="sum",
                               ev_option=evo)]


def _e2e_batches():
    """Ids 1..8, a flood of four batches of fresh ids, ids 1..8 again."""
    first = list(range(1, 9))
    flood = [list(range(100 + 8 * s, 108 + 8 * s)) for s in range(4)]
    return [np.asarray(ids, np.int64)[:, None]
            for ids in [first] + flood + [first]]


def _jax_e2e():
    group = jfc.EmbeddingGroup(_e2e_columns(jfc, jcfg))
    opt, tx = jsopt.SparseSGD(0.5), optax.sgd(0.1)
    ts = jloop.create_train_state(group, {"w": jnp.ones((4,))}, tx, opt)
    step = jloop.make_train_step(
        group, lambda p, e, b: jnp.sum(e["f"] * p["w"], axis=1),
        lambda out, b: (out - b["label"]) ** 2, opt, tx, donate=False)
    tiered = jmt.TieredGroup(group, ts.slots, high_watermark=0.5,
                             low_watermark=0.25, demote_every=1)
    ev_step = jloop.make_eval_step(group, lambda p, e, b: e["f"])
    return types.SimpleNamespace(group=group, ts=ts, step=step,
                                 tiered=tiered, eval=ev_step, tx=tx, opt=opt)


def _port_e2e():
    group = tfc.EmbeddingGroup(_e2e_columns(tfc, tcfg))
    opt, dopt = tsopt.SparseSGD(0.5), mc.DenseSGD(0.1)
    params = convert.params_from_numpy({"w": np.ones((4,), np.float32)})
    ts = tloop.create_train_state(group, params, dopt, opt, "cpu")
    step = tloop.make_train_step(
        group, lambda p, e, b: (e["f"] * p["w"]).sum(dim=1),
        lambda out, b: (out - b["label"]) ** 2, opt, dopt)
    tiered = tmt.TieredGroup(group, ts.slots, high_watermark=0.5,
                             low_watermark=0.25, demote_every=1)
    ev_step = tloop.make_eval_step(group, lambda p, e, b: e["f"])
    return types.SimpleNamespace(group=group, ts=ts, step=step,
                                 tiered=tiered, eval=ev_step, opt=opt,
                                 dopt=dopt)


def _jbatch(ids):
    return {"f": jfc.SparseIds.from_numpy(ids),
            "label": jnp.ones((ids.shape[0],), jnp.float32)}


def _tbatch(ids):
    return {"f": tfc.SparseIds.from_numpy(ids, "cpu"),
            "label": torch.ones((ids.shape[0],), dtype=torch.float32)}


def _by_key(arrays):
    order = np.argsort(arrays["keys"], kind="stable")
    return {k: np.asarray(v)[order] for k, v in arrays.items()}


def _assert_by_key(got, want, what):
    got, want = _by_key(got), _by_key(want)
    assert sorted(got) == sorted(want), what
    for k in want:
        if np.issubdtype(np.asarray(want[k]).dtype, np.floating):
            np.testing.assert_allclose(got[k], want[k], **E2E_TOL,
                                       err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{what} {k}")


def _run_e2e():
    """Both packages through the scenario, pre_step / step / post_step,
    with the ids 1..8 back in the last batch (pre_step only: promotion
    restores the first step's trained rows)."""
    j, t = _jax_e2e(), _port_e2e()
    batches = _e2e_batches()
    out = {"jloss": [], "tloss": []}
    for i, ids in enumerate(batches[:-1]):
        j.ts = j.tiered.pre_step(j.ts, _jbatch(ids))
        j.ts, jm = j.step(j.ts, _jbatch(ids))
        j.ts = j.tiered.post_step(j.ts)
        t.ts = t.tiered.pre_step(t.ts, _tbatch(ids))
        t.ts, tm = t.step(t.ts, _tbatch(ids))
        t.ts = t.tiered.post_step(t.ts)
        out["jloss"].append(float(jm["loss"]))
        out["tloss"].append(float(tm["loss"]))
        if i == 0:
            out["first"] = t.eval(t.ts, _tbatch(ids)).numpy()
            out["jfirst"] = np.asarray(j.eval(j.ts, _jbatch(ids)))
    j.ts = j.tiered.pre_step(j.ts, _jbatch(batches[-1]))
    t.ts = t.tiered.pre_step(t.ts, _tbatch(batches[-1]))
    out["back"] = t.eval(t.ts, _tbatch(batches[-1])).numpy()
    out["jback"] = np.asarray(j.eval(j.ts, _jbatch(batches[-1])))
    return j, t, out


@pytest.fixture(scope="module")
def e2e():
    return _run_e2e()


def test_end_to_end_training_with_spill_matches_jax(e2e):
    j, t, out = e2e
    np.testing.assert_allclose(out["tloss"], out["jloss"], **E2E_TOL)
    jst, tst = j.tiered.stats()["f"], t.tiered.stats()["f"]
    assert dataclasses.astuple(tst) == dataclasses.astuple(jst)
    assert tst.demoted > 0 and tst.promoted > 0
    # The ids' trained rows came back: bit for bit in the port, and as
    # the JAX package's.
    np.testing.assert_array_equal(out["back"], out["first"])
    np.testing.assert_allclose(out["back"], out["jback"], **E2E_TOL)
    assert np.abs(out["first"]).sum() > 0
    _assert_by_key(tev.export_arrays(t.group.tables["f"], t.ts.ev["f"]),
                   jax.tree.map(np.asarray, jev.export_arrays(
                       j.group.tables["f"], j.ts.ev["f"])), "table")
    # Integer state bit for bit, slot by slot.
    np.testing.assert_array_equal(t.ts.ev["f"].table.key_rows.numpy(),
                                  np.asarray(j.ts.ev["f"].table.key_rows))
    np.testing.assert_array_equal(t.ts.ev["f"].freqs.numpy(),
                                  np.asarray(j.ts.ev["f"].freqs))
    np.testing.assert_array_equal(t.ts.ev["f"].versions.numpy(),
                                  np.asarray(j.ts.ev["f"].versions))
    _assert_by_key(t.tiered.export_spill()["f"][0],
                   j.tiered.export_spill()["f"][0], "spill store")


def _spill_files(d):
    ckpt = sorted(os.listdir(d))[-1]
    out = {}
    for fn in os.listdir(os.path.join(d, ckpt)):
        if fn.startswith("spill-"):
            with np.load(os.path.join(d, ckpt, fn)) as z:
                out[fn] = dict(z)
    return out


def test_spill_checkpoints_cross_packages(e2e, tmp_path):
    """The JAX package's checkpoint restores into the port (tables and
    spill store), the port's into the JAX package; each restored store,
    saved again, writes the same spill arrays as the other package."""
    j, t, _ = e2e
    # The stores hold rows at the end of the scenario.
    assert len(j.tiered.tiered["f"][0].host) and len(t.tiered.tiered["f"].host)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jm = JCkpt(jd, j.group)
    jm.attach_tiered(j.tiered)
    jm.save(j.ts)
    tm = TCkpt(td, t.group)
    tm.attach_tiered(t.tiered)
    tm.save(t.ts)
    j_files, t_files = _spill_files(jd), _spill_files(td)
    assert sorted(j_files) == sorted(t_files) == ["spill-f-s0.npz"]
    for k in j_files["spill-f-s0.npz"]:
        assert k in t_files["spill-f-s0.npz"], k
    _assert_by_key(t_files["spill-f-s0.npz"], j_files["spill-f-s0.npz"],
                   "spill files")

    # JAX -> port.
    t2 = _port_e2e()
    m = TCkpt(jd, t2.group)
    m.attach_tiered(t2.tiered)
    ts2 = m.restore(t2.ts)
    _assert_by_key(t2.tiered.export_spill()["f"][0],
                   j.tiered.export_spill()["f"][0], "JAX -> port store")
    _assert_by_key(tev.export_arrays(t2.group.tables["f"], ts2.ev["f"]),
                   jax.tree.map(np.asarray, jev.export_arrays(
                       j.group.tables["f"], j.ts.ev["f"])), "JAX -> port")
    again = str(tmp_path / "port_again")
    m2 = TCkpt(again, t2.group)
    m2.attach_tiered(t2.tiered)
    m2.save(ts2)
    _assert_dicts_equal(_spill_files(again)["spill-f-s0.npz"],
                        j_files["spill-f-s0.npz"], "port resave of JAX")

    # port -> JAX.
    j2 = _jax_e2e()
    m = JCkpt(td, j2.group)
    m.attach_tiered(j2.tiered)
    jts2 = m.restore(j2.ts)
    _assert_by_key(j2.tiered.export_spill()["f"][0],
                   t.tiered.export_spill()["f"][0], "port -> JAX store")
    _assert_by_key(jax.tree.map(np.asarray, jev.export_arrays(
        j2.group.tables["f"], jts2.ev["f"])),
        tev.export_arrays(t.group.tables["f"], t.ts.ev["f"]), "port -> JAX")
    again = str(tmp_path / "jax_again")
    m2 = JCkpt(again, j2.group)
    m2.attach_tiered(j2.tiered)
    m2.save(jts2)
    _assert_dicts_equal(_spill_files(again)["spill-f-s0.npz"],
                        t_files["spill-f-s0.npz"], "JAX resave of port")


def test_restored_promotion_brings_rows_back(e2e, tmp_path):
    """A port checkpoint restored into a fresh port state: the first
    batch's rows, demoted before the save, come back from the restored
    spill store bit for bit."""
    _, t, out = e2e
    d = str(tmp_path / "ckpt")
    t_new = _port_e2e()
    m = TCkpt(d, t.group)
    m.attach_tiered(t.tiered)
    m.save(t.ts)
    m = TCkpt(d, t_new.group)
    m.attach_tiered(t_new.tiered)
    ts = m.restore(t_new.ts)
    ids = _e2e_batches()[0]
    want = t.eval(t.ts, _tbatch(ids)).numpy()
    ts = t_new.tiered.pre_step(ts, _tbatch(ids))
    np.testing.assert_array_equal(t_new.eval(ts, _tbatch(ids)).numpy(), want)


def test_batch_ids_from_any_batch_form():
    """``pre_step`` reads a table's ids alike from the raw numpy batch,
    a per-column batch of ``SparseIds``, a packed one and a compact one
    (coalesced salts applied on the host)."""
    evo = tcfg.EmbeddingVariableOption(storage_option=tcfg.StorageOption(
        storage_type=tcfg.StorageType.HBM_HOST))
    cols = [tfc.EmbeddingColumn(name=n, dim=4, capacity=64, ev_option=evo)
            for n in ("a", "b")]
    group = tfc.EmbeddingGroup(cols, coalesce=True)
    slots = group.init_optimizer(tsopt.SparseSGD(), "cpu")
    tg = tmt.TieredGroup(group, slots)
    rng = np.random.default_rng(4)
    raw = {"a": rng.integers(0, 1000, (6, 2)).astype(np.int64),
           "b": rng.integers(0, 1000, (6, 3)).astype(np.int64)}
    raw["a"][0, 1] = keylib.EMPTY_ID
    forms = [raw, {c: tfc.SparseIds.from_numpy(v, "cpu")
                   for c, v in raw.items()},
             group.pack_batch_np(raw, "cpu"),
             group.pack_batch_np(raw, "cpu", compact=True)]
    (tname,) = tg.tiered
    got = [np.sort(tg._batch_ids_for(tname, f)) for f in forms]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    # The salted keys, as the table stores them.
    his, los = zip(*(group.transform_ids_np(c, raw[c.name].reshape(-1))
                     for c in cols))
    np.testing.assert_array_equal(got[0], np.sort(keylib.join_ids(
        np.concatenate(his), np.concatenate(los))))


def test_replicated_table_on_a_mesh_group_raises():
    class _Mesh:
        size, rank, axis_name = 2, 0, "data"

    evo = tcfg.EmbeddingVariableOption(storage_option=tcfg.StorageOption(
        storage_type=tcfg.StorageType.HBM_HOST))
    group = tfc.EmbeddingGroup(
        [tfc.EmbeddingColumn(name="f", dim=4, capacity=64, ev_option=evo)],
        axis_name="data", num_shards=2, placement={"f": "replicated"})
    with pytest.raises(ValueError, match="sharded"):
        tmt.TieredGroup(group, {"f": {}}, mesh=_Mesh())


def test_bench_hostkv_tool_rows():
    """``tools/bench_hostkv_torch.py`` at a tiny size: the JAX tool's
    four operations, rates above 0, the store empty after the deletes."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    import bench_hostkv_torch
    rows = bench_hostkv_torch.run(5000, 4)
    assert [r["metric"] for r in rows] == [
        f"hostkv_{op}_ids_per_sec" for op in ("put", "get", "contains",
                                               "delete")]
    assert all(r["value"] > 0 and r["unit"] == "ids/s" for r in rows)
    assert rows[0]["n"] == 5000 and rows[-1]["len_after"] == 0
