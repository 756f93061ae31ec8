"""Port parity: ``variable.lookup_train_occ`` against the JAX package.

The cases of ``tests/test_occ_lookup.py`` (freq/version tracked and
LightHeader mode, the exact ``U = n`` branch and the unique budget with
ids beyond it, the counter filter with a multi-row default bank), run
through both packages step by step from empty tables. Integer outputs
and state are bit-exact: slots, ``admitted``, ``is_new``,
``prev_versions``, the unique ids, ``inverse``, ``n_overflow``, the hash
key rows, freqs and versions. Rows and table values: rtol 1e-5, atol
1e-6 (row inits whose log/cos come from another math library). The JAX
side runs jitted, as its training step runs it: eagerly, each step's
probe loops compile anew.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprec_tpu import config as jcfg
from deeprec_tpu.embedding import variable as jev
from deeprec_tpu.utils import keys as jkeys
from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch.embedding import variable as tev

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
N = 64          # ids per step; one shape for every case
EMPTY = np.iinfo(np.int64).min


def _cfg(mod, initializer="truncated_normal", init_scale=0.1,
         filter_freq=None, dvd=1, **ev_kw):
    if filter_freq is not None:
        ev_kw["filter_option"] = mod.CounterFilter(filter_freq=filter_freq)
    return mod.TableConfig(
        name="t", dim=4, capacity=256, initializer=initializer,
        init_scale=init_scale, ev_option=mod.EmbeddingVariableOption(
            default_value_dim=dvd, **ev_kw))


def _ids(seed, steps, vocab, pad_frac=0.2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        ids = rng.integers(0, vocab, size=N).astype(np.int64)
        ids[rng.random(N) < pad_frac] = EMPTY
        out.append(ids)
    return out


LIGHT = dict(record_freq=False, record_version=False)
# case: (config, ids per step, unique budget per step or None)
CASES = {
    "tracked": (dict(), _ids(0, 4, 40), None),
    "counter_filter_bank": (dict(filter_freq=3, dvd=3, initializer="constant",
                                 init_scale=0.25), _ids(1, 5, 16, 0.1), None),
    # 64 distinct ids under a budget of 40, then all of them in budget:
    # the 24 dropped at step 0 initialize at their first trained touch.
    "budget": (dict(), [np.random.default_rng(2).permutation(200)[:N]
                        .astype(np.int64)] * 2, [40, 64]),
    "lightheader": (LIGHT, _ids(3, 4, 40), None),
    "lightheader_budget": (LIGHT, _ids(4, 3, 200, 0.1), [32, 32, 48]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_lookup_train_occ_matches(case):
    kw, ids_list, budgets = CASES[case]
    jc, tc = _cfg(jcfg, **kw), _cfg(tcfg, **kw)
    jst, tst = jev.create(jc, salt=3), tev.create(tc, "cpu", salt=3)
    jlookup = jax.jit(jev.lookup_train_occ, static_argnums=(0,),
                      static_argnames=("salt", "budget"))
    overflows = []
    for gs, ids in enumerate(ids_list):
        budget = None if budgets is None else budgets[gs]
        hi, lo = jkeys.split_ids(ids)
        jst, jocc = jlookup(jc, jst, jnp.asarray(hi), jnp.asarray(lo), gs,
                            salt=3, budget=budget)
        tst, tocc = tev.lookup_train_occ(tc, tst, torch.from_numpy(hi),
                                         torch.from_numpy(lo), gs, salt=3,
                                         budget=budget)
        for f in ("slots", "admitted", "is_new", "prev_versions", "qhi",
                  "qlo"):
            np.testing.assert_array_equal(
                getattr(tocc.lk, f).numpy(), np.asarray(getattr(jocc.lk, f)),
                err_msg=f"{case} step {gs}: {f}")
        np.testing.assert_array_equal(tocc.inverse.numpy(),
                                      np.asarray(jocc.inverse))
        overflows.append(int(jocc.n_overflow))
        assert int(tocc.n_overflow) == overflows[-1]
        np.testing.assert_allclose(tocc.lk.rows.numpy(),
                                   np.asarray(jocc.lk.rows), **TOL)
        np.testing.assert_array_equal(tst.table.key_rows.numpy(),
                                      np.asarray(jst.table.key_rows))
        np.testing.assert_array_equal(tst.freqs.numpy(), np.asarray(jst.freqs))
        np.testing.assert_array_equal(tst.versions.numpy(),
                                      np.asarray(jst.versions))
        np.testing.assert_allclose(tst.values.numpy(), np.asarray(jst.values),
                                   **TOL)
    # The budget cases really drop ids; the exact ones never do.
    assert (max(overflows) > 0) == (budgets is not None)
