"""Sparse optimizer applies (K2 Adagrad, K3 lazy Adam): the port's plain
versions against the JAX package's Pallas kernels (interpret mode, as
the JAX tests run them on the CPU) and their ``*_reference`` functions,
the port's ``SparseAdagrad``/``SparseAdam.apply`` against the JAX
classes on the same ``LookupResult``, and the CUDA kernels against the
plain versions on the card.

Tolerances: against JAX, rtol 1e-5, atol 1e-6 (rsqrt and sqrt from
another math library). The Pallas kernels write their tile padding onto
row C, so only rows below C are compared with them; the port never
writes row C. On the card, the kernels are built with ``--fmad=false``
and repeat the plain version's operations in its order, so the slot
arrays (accumulator, moments) must be equal; the table rows may differ
by the last bits where the kernel's ``rsqrtf`` and PyTorch's ``rsqrt``
differ: rtol 1e-6, atol 1e-7.

JAX is imported inside the parity tests so the ``cuda`` tests run where
JAX is not installed:
``python -m pytest --noconftest tests/test_torch_sparse_apply.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from deeprec_tpu_torch.ops.kernels import sparse_apply as sa

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
ADAM = (0.9, 0.999, 1e-8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(C, D, n, seed, drops=True, share=0.8, new_share=0.3):
    """Tables [C+1, D], n unique slots in [0, C) with (when ``drops``)
    the sentinel C and two slots above it, grads, and masks; a share of
    rows to update, or "one" for one row in each group of 32, and a
    share of fresh rows."""
    r = np.random.default_rng(seed)
    values = r.normal(size=(C + 1, D)).astype(np.float32)
    acc = r.uniform(0.1, 1.0, size=(C + 1, D)).astype(np.float32)
    m = r.normal(0, 0.1, size=(C + 1, D)).astype(np.float32)
    v = r.uniform(0, 0.1, size=(C + 1, D)).astype(np.float32)
    slots = r.permutation(C)[:n].astype(np.int32)
    if drops and n >= 3:
        slots[:3] = [C, C + 1, C + 17]
    grads = r.normal(size=(n, D)).astype(np.float32)
    if share == "one":
        update = np.arange(n) % 32 == 7
    else:
        update = r.random(n) < share
    is_new = r.random(n) < new_share
    return dict(values=values, acc=acc, m=m, v=v, slots=slots, grads=grads,
                update=update, is_new=is_new)


def _t(c, device="cpu"):
    return {k: torch.from_numpy(np.array(x)).to(device) for k, x in c.items()}


@pytest.mark.parametrize("D", [8, 65])
def test_adagrad_plain_matches_pallas_and_reference(D):
    import jax.numpy as jnp
    from deeprec_tpu.ops.pallas import sparse_apply as jsa

    C, n = 400, 333                     # ragged n: not a tile multiple
    c = _case(C, D, n, D)
    args = [jnp.asarray(c[k]) for k in ("values", "acc", "slots", "grads")]
    pv, pa = jsa.adagrad_apply_rows(*args, 0.05, interpret=True)
    rv, ra = jsa.adagrad_apply_rows_reference(*args, 0.05)
    t = _t(c)
    tv, ta = sa.adagrad_apply_rows(t["values"], t["acc"], t["slots"],
                                   t["grads"], 0.05)
    for got, pal, ref in ((tv, pv, rv), (ta, pa, ra)):
        np.testing.assert_allclose(got.numpy()[:C], np.asarray(pal)[:C], **TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # Row C and every row no slot names are untouched.
    touched = np.zeros(C + 1, bool)
    touched[c["slots"][c["slots"] < C]] = True
    np.testing.assert_array_equal(tv.numpy()[~touched], c["values"][~touched])


@pytest.mark.parametrize("D", [8, 65])
def test_adam_plain_matches_pallas_and_reference(D):
    import jax.numpy as jnp
    from deeprec_tpu.ops.pallas import sparse_apply as jsa

    C, n = 400, 333
    c = _case(C, D, n, 10 + D)
    args = [jnp.asarray(c[k]) for k in ("values", "m", "v", "slots", "grads")]
    pal = jsa.adam_apply_rows(*args, 0.01, *ADAM, interpret=True)
    ref = jsa.adam_apply_rows_reference(*args, 0.01, *ADAM)
    t = _t(c)
    got = sa.adam_apply_rows(t["values"], t["m"], t["v"], t["slots"],
                             t["grads"], 0.01, *ADAM)
    for g, p, r in zip(got, pal, ref):
        np.testing.assert_allclose(g.numpy()[:C], np.asarray(p)[:C], **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    assert np.array_equal(got[0].numpy()[C], c["values"][C])


def _lookups(c, C):
    """The same LookupResult for both packages: rows are the table rows
    of admitted slots (as ``lookup_train_occ`` fetches them) and noise
    elsewhere."""
    import jax.numpy as jnp
    from deeprec_tpu.embedding.variable import LookupResult as JLk
    from deeprec_tpu_torch.embedding.variable import LookupResult as TLk

    n, D = c["grads"].shape
    rows = np.where(c["update"][:, None],
                    c["values"][np.minimum(c["slots"], C)],
                    np.float32(7.0)).astype(np.float32)
    f = dict(slots=c["slots"], rows=rows, admitted=c["update"],
             is_new=c["is_new"], prev_versions=np.zeros(n, np.int32),
             qhi=np.zeros(n, np.int32), qlo=np.arange(n, dtype=np.int32))
    return (JLk(**{k: jnp.asarray(v) for k, v in f.items()}),
            TLk(**{k: torch.from_numpy(np.array(v)) for k, v in f.items()}))


@pytest.mark.parametrize("opt", ["adagrad", "adam"])
@pytest.mark.parametrize("D", [8, 65])
def test_optimizer_apply_matches_jax(opt, D):
    import jax
    import jax.numpy as jnp
    from deeprec_tpu import config as jcfg
    from deeprec_tpu.optimizers import sparse as jsopt
    from deeprec_tpu_torch import config as tcfg
    from deeprec_tpu_torch import convert
    from deeprec_tpu_torch.optimizers import sparse as tsopt

    C, n = 256, 200
    c = _case(C, D, n, 20 + D)
    jc = jcfg.TableConfig(name="t", dim=D, capacity=C)
    tc = tcfg.TableConfig(name="t", dim=D, capacity=C)
    jlk, tlk = _lookups(c, C)
    jo, to = ((jsopt.SparseAdagrad(0.05), tsopt.SparseAdagrad(0.05))
              if opt == "adagrad" else (jsopt.SparseAdam(0.01),
                                        tsopt.SparseAdam(0.01)))
    jsl = jo.init(jc)
    if opt == "adagrad":
        jsl = {"accum": jnp.asarray(c["acc"])}
    else:
        jsl = {**jsl, "m": jnp.asarray(c["m"]), "v": jnp.asarray(c["v"])}
    tsl = convert.slots_from_numpy(
        {"t": jax.tree.map(np.asarray, jsl)}, "cpu")["t"]
    values = jnp.asarray(c["values"])
    tvalues = torch.from_numpy(c["values"].copy())
    for gs in range(2):          # twice: Adam's beta powers advance
        jsl, values = jo.apply(jc, jsl, values, jlk,
                               jnp.asarray(c["grads"]), gs)
        tsl, tvalues = to.apply(tc, tsl, tvalues, tlk,
                                torch.from_numpy(c["grads"]), gs)
        jlk = jlk._replace(rows=jnp.where(
            jlk.admitted[:, None], values[jnp.minimum(jlk.slots, C)],
            jlk.rows))
    np.testing.assert_allclose(tvalues.numpy(), np.asarray(values), **TOL)
    for k, v in jsl.items():
        np.testing.assert_allclose(tsl[k].numpy(), np.asarray(v), **TOL)


# -- on the card ---------------------------------------------------------------

def _base_rows(c, base, seed):
    """Rows a dyn-dim or adaptive apply updates from, in place of
    ``values[slot]``: "masked", the locked three quarters of each row
    zeroed (and their gradients, which the masked forward gives none);
    "seeded", a migrated seed in every fresh row."""
    C = c["values"].shape[0] - 1
    rows = c["values"][np.clip(c["slots"], 0, C)].copy()
    if base == "masked":
        rows[:, rows.shape[1] // 4:] = 0.0
        c["grads"][:, rows.shape[1] // 4:] = 0.0
    else:
        seeds = np.random.default_rng(seed).normal(size=rows.shape)
        rows = np.where(c["is_new"][:, None], seeds, rows)
    return rows.astype(np.float32)


def _kernel_vs_plain(device, opt, C, D, n, seed, share=0.8, new_share=0.3,
                     base=None):
    c = _case(C, D, n, seed, share=share, new_share=new_share)
    if n > 3:
        if C - 1 not in c["slots"]:
            c["slots"][3] = C - 1      # the last row the kernel may write
        c["update"][c["slots"] == C - 1] = share != 0.0
    if base is not None:
        c["base"] = _base_rows(c, base, seed)
    kt, pt = _t(c, device), _t(c, device)
    if opt == "adagrad":
        sa.adagrad_apply_rows(kt["values"], kt["acc"], kt["slots"],
                              kt["grads"], 0.05, update=kt["update"],
                              is_new=kt["is_new"], init_acc=0.1,
                              base_rows=kt.get("base"))
        sa.adagrad_apply_rows_reference(
            pt["values"], pt["acc"], pt["slots"], pt["grads"], 0.05,
            update=pt["update"], is_new=pt["is_new"], init_acc=0.1,
            base_rows=pt.get("base"))
        slot_keys = ("acc",)
    else:
        alpha = torch.tensor([0.01], device=device)
        sa.adam_apply_rows(kt["values"], kt["m"], kt["v"], kt["slots"],
                           kt["grads"], alpha, *ADAM, update=kt["update"],
                           is_new=kt["is_new"], base_rows=kt.get("base"))
        sa.adam_apply_rows_reference(
            pt["values"], pt["m"], pt["v"], pt["slots"], pt["grads"], alpha,
            *ADAM, update=pt["update"], is_new=pt["is_new"],
            base_rows=pt.get("base"))
        slot_keys = ("m", "v")
    torch.cuda.synchronize()
    for k in slot_keys:
        assert torch.equal(kt[k], pt[k]), k
    torch.testing.assert_close(kt["values"], pt["values"], rtol=1e-6,
                               atol=1e-7)
    assert torch.equal(kt["values"][C], pt["values"][C])


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["adagrad", "adam"])
@pytest.mark.parametrize("D", [1, 4, 8, 17, 64, 65, 128, 129, 256, 257])
@pytest.mark.parametrize("n", [0, 5, 31, 33, 4099])
@pytest.mark.parametrize("share", [0.0, "one", 0.26, 0.8, 1.0])
def test_kernel_matches_plain_on_card(cuda_device, opt, D, n, share):
    # Update shares: none, one row in 32 (most of K2's 4- or 8-row
    # groups apply nothing), the training path's ~26 %, most and all.
    name = f"{opt}_apply_rows"
    before = sa.launches[name]
    _kernel_vs_plain(cuda_device, opt, 5000, D, n, D, share)
    assert sa.launches[name] == before + (1 if n else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["adagrad", "adam"])
@pytest.mark.parametrize("D", [1, 4, 8, 17, 64, 65, 128, 129, 256, 257])
@pytest.mark.parametrize("new_share", [0.0, 1.0])
def test_kernel_fresh_share_on_card(cuda_device, opt, D, new_share):
    # No row fresh (every slot stream read) and every row fresh (none
    # read), at 26 % and 100 % updated.
    for share in (0.26, 1.0):
        _kernel_vs_plain(cuda_device, opt, 5000, D, 4099, 7 * D, share,
                         new_share)


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["adagrad", "adam"])
@pytest.mark.parametrize("D", [4, 17, 64, 65, 128, 129])
@pytest.mark.parametrize("base", ["masked", "seeded"])
def test_kernel_base_rows_on_card(cuda_device, opt, D, base):
    # A dyn-dim table's masked rows and an adaptive table's seeds (in
    # fresh rows) as base_rows, at 26 % and 100 % updated.
    for share in (0.26, 1.0):
        _kernel_vs_plain(cuda_device, opt, 5000, D, 4099, 3 * D, share, 0.5,
                         base)


@pytest.mark.parametrize("opt", ["adagrad", "adam"])
def test_plain_base_rows(opt):
    """``base_rows`` equal to the table's rows leaves the apply as it
    was, bit for bit; other base rows change the updated rows only."""
    c = _case(300, 12, 97, 5)
    C = 300
    own = c["values"][np.clip(c["slots"], 0, C)]
    masked = dict(c, base=_base_rows(dict(c), "masked", 5))
    outs = []
    for base in (None, own, masked["base"]):
        t = _t(c)
        kw = dict(update=t["update"], is_new=t["is_new"],
                  base_rows=None if base is None else torch.from_numpy(base))
        if opt == "adagrad":
            sa.adagrad_apply_rows(t["values"], t["acc"], t["slots"],
                                  t["grads"], 0.05, init_acc=0.1, **kw)
        else:
            sa.adam_apply_rows(t["values"], t["m"], t["v"], t["slots"],
                               t["grads"], 0.01, *ADAM, **kw)
        outs.append(t["values"])
    assert torch.equal(outs[0], outs[1])
    ok = ((c["slots"] >= 0) & (c["slots"] < C) & c["update"])
    changed = (outs[2] != outs[0]).any(dim=1).numpy()
    assert changed[c["slots"][ok]].all()
    untouched = np.ones(C + 1, bool)
    untouched[c["slots"][ok]] = False
    assert not changed[untouched].any()


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["adagrad", "adam"])
@pytest.mark.parametrize("D", [257, 300, 513, 1000])
@pytest.mark.parametrize("n", [3, 9, 13, 37, 1001])
def test_kernel_ragged_and_wide_on_card(cuda_device, opt, D, n):
    # n ragged against groups of 4 and 8 u-rows and against batches of
    # units; rows of several 256-column units.
    for share in (0.5, 1.0):
        _kernel_vs_plain(cuda_device, opt, 3000, D, n, D + n, share, 0.3)


@pytest.mark.cuda
def test_kernel_rejects_bad_operands(cuda_device):
    c = _t(_case(100, 8, 50, 0), cuda_device)
    with pytest.raises(TypeError):
        sa.adagrad_apply_rows(c["values"], c["acc"], c["slots"].long(),
                              c["grads"], 0.1)
    with pytest.raises(ValueError):
        sa.adagrad_apply_rows(c["values"], c["acc"][:-1], c["slots"],
                              c["grads"], 0.1)
    with pytest.raises(TypeError):
        sa.adam_apply_rows(c["values"], c["m"], c["v"], c["slots"],
                           c["grads"], 0.01, *ADAM)
    empty = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    sa.adagrad_apply_rows(c["values"], c["acc"], empty,
                          c["grads"][:0], 0.1)


def test_chip_smoke_apply_bytes():
    """The apply's bound counts 20/28 bytes per element of an applied
    row, 16/20 for a fresh one (its slot rows are not read), nothing for
    a dropped or filtered row, and 4 bytes of slot plus 1 per flag given
    per u-row."""
    import chip_smoke

    C, D = 10, 3
    slots = torch.tensor([0, 1, 2, 3, C, C + 5, -1, 4, 5], dtype=torch.int32)
    upd = torch.tensor([1, 1, 1, 0, 1, 1, 1, 1, 0], dtype=torch.bool)
    is_new = torch.tensor([1, 0, 1, 1, 1, 0, 1, 0, 0], dtype=torch.bool)
    # Applied: u-rows 0, 1, 2, 7 (3 and 8 filtered, 4-6 dropped); fresh:
    # 0 and 2 (3, 4 and 6 are fresh but not applied).
    applied, fresh = chip_smoke._applied(C, slots, upd, is_new)
    assert applied.tolist() == [1, 1, 1, 0, 0, 0, 0, 1, 0]
    assert fresh.tolist() == [1, 0, 1, 0, 0, 0, 0, 0, 0]
    n = slots.numel()
    assert chip_smoke._apply_bytes("adagrad", C, D, slots, upd, is_new) == (
        D * (20 * 2 + 16 * 2) + 6 * n)
    assert chip_smoke._apply_bytes("adam", C, D, slots, upd, is_new) == (
        D * (28 * 2 + 20 * 2) + 6 * n)
    # update None: every in-range slot applied (0-3, 7, 8); fresh 0, 2, 3.
    assert chip_smoke._apply_bytes("adam", C, D, slots, None, is_new) == (
        D * (28 * 3 + 20 * 3) + 5 * n)
    # no is_new: nothing fresh.
    assert chip_smoke._apply_bytes("adagrad", C, D, slots, None, None) == (
        D * 20 * 6 + 4 * n)
