"""Port parity: CBF admission, the sorted training lookup and eviction
against the JAX package.

The same ids, drawn from a numpy seed, go through both packages from
empty tables: ``lookup.dedup``; the CBF counter positions and the
counters after five steps; ``variable.lookup_train`` step by step (CBF,
counter filter and no filter, with and without eviction); ``shrink``
under each policy and under none; ``hash_table.remove_slots``,
``delete_keys`` and ``num_live``; inserts after a shrink, which reuse
tombstones; and the CBF branch of ``bag_lookup_train``. Integer state
and outputs are bit-exact (key rows, slots, ``is_new``, ``admitted``,
freqs, versions, ``prev_versions``, counters, ``inverse``). The
fetched rows and table values are equal where the JAX side runs eagerly
(``EAGER``: the draw is the same arithmetic) and the initializer is
uniform or constant; under ``jax.jit`` XLA fuses the uniform draw's
multiply and add, and the truncated normal takes log and cos from
another math library, so those rows are held within rtol 1e-6, atol
1e-7 (a few float32 ulps). The other cases run the JAX side jitted, to
stay fast.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprec_tpu import config as jcfg
from deeprec_tpu.embedding import hash_table as jht
from deeprec_tpu.embedding import lookup as jlookup
from deeprec_tpu.embedding import variable as jev
from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch.embedding import hash_table as tht
from deeprec_tpu_torch.embedding import lookup as tlookup
from deeprec_tpu_torch.embedding import variable as tev
from deeprec_tpu_torch.utils import keys as tkeys

torch.set_num_threads(1)

EMPTY = np.iinfo(np.int64).min
N = 64
# The JAX side compiled once per config (eagerly, each step's probe
# loop compiles anew: seconds a step).
_jlookup_train = jax.jit(jev.lookup_train, static_argnums=(0,),
                         static_argnames=("salt",))
_jbag_lookup_train = jax.jit(jlookup.bag_lookup_train, static_argnums=(0,),
                             static_argnames=("salt",))
EAGER = ("cbf",)  # lookup_train cases whose JAX side runs eagerly


def _split(ids):
    hi, lo = tkeys.split_ids(np.asarray(ids, np.int64))
    return hi, lo


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(t, j, what):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=what)


def _rows_eq(cfg, t, j, what, exact=False):
    if not (exact and cfg.initializer in ("uniform", "constant")):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-7, err_msg=what)
    else:
        _eq(t, j, what)


# -- dedup ------------------------------------------------------------------

def _dedup_case(name):
    r = np.random.default_rng(len(name))
    if name == "padding_negative":
        hi = r.integers(-3, 3, N)
        lo = r.integers(-(2**31), 2**31, N)
        pad = r.random(N) < 0.3
        hi[pad], lo[pad] = -(2**31), 0
    elif name == "negative_small":
        hi, lo = r.integers(-2, 2, N), r.integers(-3, 3, N)
    elif name == "all_distinct":
        ids = r.choice(2**40, N, replace=False) - 2**39
        return _split(ids)
    elif name == "all_equal":
        hi, lo = np.full(N, -5), np.full(N, 7)
    elif name == "all_padding":
        hi, lo = np.full(N, -(2**31)), np.zeros(N)
    else:  # sentinel-adjacent: hi = int32 min with lo around the EMPTY id
        hi = np.full(N, -(2**31))
        lo = r.integers(-2, 3, N)
    return hi.astype(np.int32), lo.astype(np.int32)


@pytest.mark.parametrize("name", ["padding_negative", "negative_small",
                                  "all_distinct", "all_equal",
                                  "all_padding", "sentinel_adjacent"])
def test_dedup_bit_exact(name):
    hi, lo = _dedup_case(name)
    want = jlookup.dedup(jnp.asarray(hi), jnp.asarray(lo))
    got = tlookup.dedup(_t(hi), _t(lo))
    for field in ("uhi", "ulo", "counts", "inverse"):
        _eq(getattr(got, field), getattr(want, field), field)
    assert got.inverse.dtype == torch.int64


# -- configs ----------------------------------------------------------------

def _cfg(mod, filt=None, evict=None, initializer="uniform", cap=256, dim=4,
         dvd=1, **ev_kw):
    f = {"cbf": lambda: mod.CBFFilter(filter_freq=3, num_counters=512,
                                      num_hash_func=2),
         "cbf3": lambda: mod.CBFFilter(filter_freq=2, num_counters=64,
                                       num_hash_func=3),
         "counter": lambda: mod.CounterFilter(filter_freq=2),
         None: lambda: None}[filt]()
    e = {"step": lambda: mod.GlobalStepEvict(steps_to_live=2),
         "l2": lambda: mod.L2WeightEvict(l2_weight_threshold=0.3),
         None: lambda: None}[evict]()
    return mod.TableConfig(
        name="t", dim=dim, capacity=cap, initializer=initializer,
        init_scale=0.5, ev_option=mod.EmbeddingVariableOption(
            filter_option=f, evict_option=e, default_value_dim=dvd,
            **ev_kw))


def _steps(seed, steps, vocab, pad_frac=0.2):
    """Per step: the dedup of a batch of N ids (hi, lo, counts)."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        ids = r.integers(0, vocab, N).astype(np.int64)
        ids[r.random(N) < pad_frac] = EMPTY
        hi, lo = _split(ids)
        dd = jlookup.dedup(jnp.asarray(hi), jnp.asarray(lo))
        out.append(tuple(np.asarray(a) for a in dd[:3]))
    return out


def _assert_state(cfg, tst, jst, what="", exact=False):
    _eq(tst.table.key_rows, jst.table.key_rows, what + " key rows")
    _eq(tst.freqs, jst.freqs, what + " freqs")
    _eq(tst.versions, jst.versions, what + " versions")
    _eq(tst.bloom, jst.bloom, what + " bloom")
    _rows_eq(cfg, tst.values, jst.values, what + " values", exact)


def _assert_lookup(cfg, tlk, jlk, what, exact=False):
    for field in ("slots", "admitted", "is_new", "prev_versions"):
        _eq(getattr(tlk, field), getattr(jlk, field), f"{what} {field}")
    _rows_eq(cfg, tlk.rows, jlk.rows, f"{what} rows", exact)


def _run(jc, tc, steps, salt=3, eager=False):
    """Both packages' lookup_train over ``steps``; asserts every output."""
    jfn = jev.lookup_train if eager else _jlookup_train
    jst, tst = jev.create(jc, salt=salt), tev.create(tc, "cpu", salt=salt)
    for s, (hi, lo, counts) in enumerate(steps):
        jst, jlk = jfn(jc, jst, jnp.asarray(hi), jnp.asarray(lo),
                       jnp.asarray(counts), s, salt=salt)
        tst, tlk = tev.lookup_train(tc, tst, _t(hi), _t(lo), _t(counts), s,
                                    salt=salt)
        _assert_lookup(tc, tlk, jlk, f"step {s}", eager)
        _assert_state(tc, tst, jst, f"step {s}", eager)
    return jst, tst


def test_bloom_positions_and_counters_after_five_steps():
    jc, tc = _cfg(jcfg, "cbf3"), _cfg(tcfg, "cbf3")
    r = np.random.default_rng(5)
    hi, lo = _split(r.integers(-(2**40), 2**40, 200))
    _eq(tev._bloom_positions(tc.ev_option.filter_option, _t(hi), _t(lo)),
        jev._bloom_positions(jc.ev_option.filter_option, jnp.asarray(hi),
                             jnp.asarray(lo)), "positions")
    # 64 counters: positions collide, so the adds must accumulate.
    jst, tst = _run(jc, tc, _steps(6, 5, 90))
    assert int(tst.bloom.sum()) > 0
    assert tst.bloom.shape == (64,)


CASES = {
    "cbf": dict(filt="cbf"),
    "cbf_evict_bank": dict(filt="cbf", evict="step", dvd=3,
                           initializer="constant"),
    "counter_evict": dict(filt="counter", evict="step"),
    "none_light": dict(record_freq=False, record_version=False),
    "cbf_tnormal": dict(filt="cbf", initializer="truncated_normal"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lookup_train_steps_bit_exact(case):
    kw = CASES[case]
    _run(_cfg(jcfg, **kw), _cfg(tcfg, **kw), _steps(7, 6, 48),
         eager=case in EAGER)


@pytest.mark.parametrize("policy", ["step", "l2", None])
def test_shrink_then_reinsert_bit_exact(policy):
    jc, tc = _cfg(jcfg, "cbf", policy), _cfg(tcfg, "cbf", policy)
    jst, tst = _run(jc, tc, _steps(8, 5, 60, pad_frac=0.0))
    jst = jev.shrink(jc, jst, 6)
    tst = tev.shrink(tc, tst, 6)
    _assert_state(tc, tst, jst, "after shrink")
    assert tst.freqs.dtype == torch.int32
    n_live = tev.num_live(tst)
    assert n_live.dtype == torch.int32 and n_live.dim() == 0
    assert int(n_live) == int(jev.num_live(jst))
    if policy is not None:
        assert int(n_live) < int(tht.live_mask(tst.table).numel())
        tombs = (tst.table.key_lo == tkeys.TOMB_LO) & (
            tst.table.key_hi == tkeys.TOMB_HI)
        assert bool(tombs.any())
    # New ids land in the tombstoned slots: both packages agree.
    for s, (hi, lo, counts) in enumerate(_steps(9, 3, 200, 0.0), 7):
        jst, jlk = _jlookup_train(jc, jst, jnp.asarray(hi), jnp.asarray(lo),
                                    jnp.asarray(counts), s, salt=3)
        tst, tlk = tev.lookup_train(tc, tst, _t(hi), _t(lo), _t(counts), s,
                                    salt=3)
        _assert_lookup(tc, tlk, jlk, f"step {s}")
        _assert_state(tc, tst, jst, f"reinsert step {s}")


def test_remove_slots_only_tombstones_occupied():
    jc, tc = _cfg(jcfg), _cfg(tcfg)
    jst, tst = _run(jc, tc, _steps(10, 2, 300, 0.0))
    r = np.random.default_rng(11)
    mask = r.random(jc.capacity) < 0.5
    jt = jht.remove_slots(jst.table, jnp.asarray(mask))
    tt = tht.remove_slots(tst.table, _t(mask))
    assert tt is tst.table
    _eq(tt.key_rows, jt.key_rows, "key rows")
    # A second pass over the same mask changes nothing (no slot is
    # occupied there any more) and EMPTY slots never become tombstones.
    before = tt.key_rows.clone()
    tht.remove_slots(tt, _t(mask))
    assert torch.equal(before, tt.key_rows)
    empty = (tt.key_hi == tkeys.EMPTY_HI) & (tt.key_lo == tkeys.EMPTY_LO)
    _eq(empty, (np.asarray(jt.key_hi) == tkeys.EMPTY_HI)
        & (np.asarray(jt.key_lo) == tkeys.EMPTY_LO), "empty slots")
    assert int(tht.num_live(tt)) == int(jht.num_live(jt))


def test_delete_keys_bit_exact():
    jc, tc = _cfg(jcfg, "counter", "step", cap=1024), _cfg(
        tcfg, "counter", "step", cap=1024)
    jst, tst = _run(jc, tc, _steps(12, 4, 700, 0.0))
    r = np.random.default_rng(13)
    live = tev.export_arrays(tc, tst)["keys"]
    # Live keys, absent keys, duplicates and the sentinels, over two
    # 8,192-id chunks.
    ids = np.concatenate([r.choice(live, live.size // 2, replace=False),
                          r.integers(10**6, 10**7, 9000),
                          live[:5], [EMPTY, EMPTY + 1]])
    jst = jev.delete_keys(jc, jst, ids)
    tst = tev.delete_keys(tc, tst, ids)
    _assert_state(tc, tst, jst, "after delete")
    assert int(tev.num_live(tst)) == int(jev.num_live(jst)) < live.size
    assert tev.delete_keys(tc, tst, np.zeros(0, np.int64)) is tst


def test_bag_lookup_train_cbf_branch():
    jc, tc = _cfg(jcfg, "cbf"), _cfg(tcfg, "cbf")
    r = np.random.default_rng(14)
    jst, tst = jev.create(jc, salt=2), tev.create(tc, "cpu", salt=2)
    for s in range(3):
        ids = r.integers(0, 30, (8, 3)).astype(np.int64)
        ids[r.random((8, 3)) < 0.2] = EMPTY
        hi, lo = _split(ids.ravel())
        hi, lo = hi.reshape(8, 3), lo.reshape(8, 3)
        jst, jb = _jbag_lookup_train(jc, jst, jnp.asarray(hi),
                                     jnp.asarray(lo), s, salt=2)
        tst, tb = tlookup.bag_lookup_train(tc, tst, _t(hi), _t(lo), s, salt=2)
        _eq(tb.inverse, jb.inverse, "inverse")
        _eq(tb.mask, jb.mask, "mask")
        _assert_lookup(tc, tb.lk, jb.lk, f"step {s}")
        assert tb.n_overflow.dim() == 0 and int(tb.n_overflow) == 0
        assert tb.n_overflow.device == tst.values.device
        _assert_state(tc, tst, jst, f"step {s}")


def test_export_import_carries_bloom():
    jc, tc = _cfg(jcfg, "cbf"), _cfg(tcfg, "cbf")
    _, tst = _run(jc, tc, _steps(15, 3, 40))
    snap = tev.export_arrays(tc, tst)
    assert snap["bloom"].shape == (512,)
    back = tev.import_arrays(tc, tev.create(tc, "cpu", salt=3), snap)
    assert torch.equal(back.bloom, tst.bloom)
    jback = jev.import_arrays(jc, jev.create(jc, salt=3), snap)
    _eq(back.bloom, jback.bloom, "bloom")
    _eq(back.values, jback.values, "values")


def test_convert_crosses_cbf_evict_tables_both_ways():
    """A CBF table with eviction (full-size counters, tombstones) crosses
    through ``convert.py`` in both directions and keeps training the same
    way on the other side."""
    from deeprec_tpu_torch import convert

    jc, tc = _cfg(jcfg, "cbf", "step"), _cfg(tcfg, "cbf", "step")
    jst, tst = _run(jc, tc, _steps(16, 4, 60, 0.0))
    jst, tst = jev.shrink(jc, jst, 5), tev.shrink(tc, tst, 5)
    as_np = {k: np.asarray(v) for k, v in (
        ("key_rows", jst.table.key_rows), ("values", jst.values),
        ("freqs", jst.freqs), ("versions", jst.versions),
        ("default_bank", jst.default_bank), ("bloom", jst.bloom))}
    from_jax = convert.ev_state_from_numpy(as_np, "cpu")
    back = convert.ev_state_to_numpy(tst)
    to_jax = jev.EVState(
        table=jht.HashTable(key_rows=jnp.asarray(back["key_rows"])),
        **{k: jnp.asarray(back[k]) for k in ("values", "freqs", "versions",
                                             "default_bank", "bloom")})
    assert from_jax.bloom.shape == (512,)
    for s, (hi, lo, counts) in enumerate(_steps(17, 2, 120, 0.0), 6):
        jst, jlk = _jlookup_train(jc, to_jax, jnp.asarray(hi), jnp.asarray(lo),
                                  jnp.asarray(counts), s, salt=3)
        to_jax = jst
        from_jax, tlk = tev.lookup_train(tc, from_jax, _t(hi), _t(lo),
                                         _t(counts), s, salt=3)
        _assert_lookup(tc, tlk, jlk, f"step {s}")
        _assert_state(tc, from_jax, jst, f"step {s}")
