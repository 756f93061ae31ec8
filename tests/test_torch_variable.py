"""Port parity: EV table create / lookup / import / export and
combine_bags against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprec_tpu import config as jcfg
from deeprec_tpu.embedding import lookup as jlookup
from deeprec_tpu.embedding import variable as jev
from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import convert
from deeprec_tpu_torch.embedding import lookup as tlookup
from deeprec_tpu_torch.embedding import variable as tev
from deeprec_tpu_torch.utils import keys as tkeys

torch.set_num_threads(1)

CAP = 1024

# (initializer, scale, dim, default_value_dim, counter filter freq,
#  record_version, block_num, thresholds)
CASES = {
    "constant_bank3_versions": ("constant", 0.5, 17, 3, 0, True, 1, ()),
    "tnormal_counter_filter": ("truncated_normal", 0.1, 17, 1, 2, False,
                               1, ()),
    "dyn_dim": ("uniform", 0.2, 16, 1, 0, False, 4, (1, 3, 5)),
}


def _configs(case):
    init, scale, dim, dvd, ff, rv, bn, thr = CASES[case]
    jopt = jcfg.EmbeddingVariableOption(
        filter_option=jcfg.CounterFilter(ff) if ff else None,
        default_value_dim=dvd, record_freq=True, record_version=rv)
    topt = tcfg.EmbeddingVariableOption(
        filter_option=tcfg.CounterFilter(ff) if ff else None,
        default_value_dim=dvd, record_freq=True, record_version=rv)
    common = dict(name="t", dim=dim, capacity=CAP, initializer=init,
                  init_scale=scale, block_num=bn, dyn_dim_thresholds=thr)
    return (jcfg.TableConfig(ev_option=jopt, **common),
            tcfg.TableConfig(ev_option=topt, **common))


def _arrays(dim, n=600, seed=0):
    r = np.random.default_rng(seed)
    keys = np.unique(r.integers(-(2**45), 2**45, size=n + 50))[:n]
    return {"keys": keys,
            "values": r.normal(size=(n, dim)).astype(np.float32),
            "freqs": r.integers(0, 7, size=n).astype(np.int32),
            "versions": r.integers(-1, 3, size=n).astype(np.int32)}


def _jax_state(jc, arrays, salt=3):
    st = jev.create(jc, salt=salt)
    dvd = st.default_bank.shape[0]
    if dvd > 1:  # distinct bank rows, so a wrong default row shows
        bank = np.arange(dvd * jc.dim, dtype=np.float32).reshape(dvd, -1)
        st = st.replace(default_bank=jnp.asarray(bank))
    return jev.import_arrays(jc, st, arrays)


def _jax_numpy(st):
    return {"key_rows": np.asarray(st.table.key_rows),
            "values": np.asarray(st.values), "freqs": np.asarray(st.freqs),
            "versions": np.asarray(st.versions),
            "default_bank": np.asarray(st.default_bank),
            "bloom": np.asarray(st.bloom)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_create_matches(case):
    jc, tc = _configs(case)
    want = _jax_numpy(jev.create(jc, salt=3))
    got = convert.ev_state_to_numpy(tev.create(tc, "cpu", salt=3))
    for k in convert.EV_FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lookup_on_converted_jax_state(case):
    jc, tc = _configs(case)
    arrays = _arrays(jc.dim)
    jst = _jax_state(jc, arrays)
    tst = convert.ev_state_from_numpy(_jax_numpy(jst), "cpu")
    r = np.random.default_rng(9)
    absent = r.integers(2**46, 2**47, size=90)
    q = np.concatenate([arrays["keys"][::2], absent,
                        np.full(30, tkeys.EMPTY_ID, np.int64)])
    hi, lo = tkeys.split_ids(q)
    want = np.asarray(jev.lookup(jc, jst, jnp.asarray(hi), jnp.asarray(lo)))
    got = tev.lookup(tc, tst, torch.from_numpy(hi), torch.from_numpy(lo))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_import_export_match_jax(case):
    jc, tc = _configs(case)
    arrays = _arrays(jc.dim, seed=5)
    jst = _jax_state(jc, arrays)
    tst = tev.create(tc, "cpu", salt=3)
    tev.import_arrays(tc, tst, arrays, chunk=256)
    np.testing.assert_array_equal(tst.table.key_rows.numpy(),
                                  np.asarray(jst.table.key_rows))
    np.testing.assert_array_equal(tst.values.numpy(), np.asarray(jst.values))
    want = jev.export_arrays(jc, jst)
    got = tev.export_arrays(tc, tst)
    for k in ("keys", "values", "freqs", "versions"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # round trip: export order differs from input order, content does not
    order = np.argsort(got["keys"])
    src = np.argsort(arrays["keys"])
    for k in ("keys", "values", "freqs", "versions"):
        np.testing.assert_array_equal(got[k][order], arrays[k][src])
    assert tev.num_live(tst) == arrays["keys"].size


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_combine_bags(combiner):
    r = np.random.default_rng(11)
    rows = r.normal(size=(40, 6)).astype(np.float32)
    inverse = r.integers(0, 40, size=(8, 5)).astype(np.int32)
    mask = r.random((8, 5)) < 0.7
    mask[3] = False                      # an empty bag
    want = np.asarray(jlookup.combine_bags(
        jnp.asarray(rows), jnp.asarray(inverse), jnp.asarray(mask), combiner))
    got = tlookup.combine_bags(torch.from_numpy(rows),
                               torch.from_numpy(inverse).long(),
                               torch.from_numpy(mask), combiner)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_unported_table_options_raise():
    # CBF admission is ported: the table gets its full counter array.
    st = tev.create(tcfg.TableConfig(
        "t", 4, 64, ev_option=tcfg.EmbeddingVariableOption(
            filter_option=tcfg.CBFFilter(2, num_counters=256))), "cpu")
    assert st.bloom.shape == (256,) and st.bloom.dtype == torch.int32
    # Multi-tier storage is ported: a tiered table is an ordinary device
    # table whose freq and version tracking is forced on (LFU ranks by
    # freq, LRU by version), as in the JAX package.
    for kind in ("HBM_HOST", "HBM_HOST_DISK"):
        opts = [pkg.EmbeddingVariableOption(
            record_freq=False, record_version=False,
            storage_option=pkg.StorageOption(
                storage_type=getattr(pkg.StorageType, kind)))
            for pkg in (tcfg, jcfg)]
        tc, jc = (pkg.TableConfig("t", 4, 64, ev_option=o)
                  for pkg, o in zip((tcfg, jcfg), opts))
        st = tev.create(tc, "cpu")
        assert st.values.shape == (65, 4) and st.freqs.shape == (65,)
        assert tev._tracking(tc) == jev._tracking(jc) == (True, True)
