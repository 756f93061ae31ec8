"""The embedding combine of a physical table and its gradient
(``ops/kernels/occ_combine.py``, ``csrc/occ_combine.cu``).

On the CPU the wrapper runs its plain version, which must be the
expressions the group's combine ran before it, bit for bit: the
forward outputs and the gradients of the rows, over sum, mean and
sqrtn, weighted columns, bags of width 1 and 3, a sequence column,
padding and occurrences of the overflow row U (``test_plain_*``); and
through ``make_train_step`` with ``micro_batch_num=2`` and with
``combine_tables``, every state tensor after three steps
(``test_group_*``). The counter ``<table>/grad_split_rows`` equals a
count made here from the inverse and the chunk size: the rows with more
than a chunk of real occurrences, which the backward sums apart.

On a card (``cuda``) the kernels against the plain version: at both
benchmark cells' shapes (B = 6,912 x 26 columns at dim 128; B = 16,384
over a 129- and a 65-wide table) on Zipf(1.2) ids, one row of 20,000
occurrences, the column kinds above, two launches and a CUDA graph's
replay against the eager call, bit for bit; and where every scale is
1, the rows' gradient bit for bit as well, since the kernels sum each
row's occurrences in the plain scatter-add's order. It imports no JAX:
``python -m pytest --noconftest tests/test_torch_occ_combine.py -m cuda``.
"""

import collections

import numpy as np
import pytest
import torch

from deeprec_tpu_torch.embedding import lookup as lkup
from deeprec_tpu_torch.feature_column import feature_column as tfc
from deeprec_tpu_torch.ops.kernels import occ_combine as occ
from deeprec_tpu_torch.optimizers import dense as tdense
from deeprec_tpu_torch.optimizers import sparse as tsopt
from deeprec_tpu_torch.train import loop as tloop
from deeprec_tpu_torch.train import losses as tlosses
from deeprec_tpu_torch.utils import keys as keylib
from deeprec_tpu_torch.utils import trace

torch.set_num_threads(1)

Column = occ.Column


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# -- the expressions the group's combine ran before ---------------------------

def _before(rows, inverse, mask, columns, weights):
    occ_rows = rows[inverse] * mask[..., None].to(rows.dtype)
    out, off = [], 0
    for col, w in zip(columns, weights):
        seg = occ_rows[:, off:off + col.width]
        if col.sequence:
            out.append(seg)
        else:
            out.append(lkup.combine_from_occ(
                seg, mask[:, off:off + col.width], col.combiner, weights=w))
        off += col.width
    return out


def _occurrences_before(self, gl, rows, params=None):
    by_tbl = {}
    for cname, cl in gl.columns.items():
        by_tbl.setdefault(cl.table_name, []).append((cname, cl))
    rows = self._local_rows(gl, rows, params)
    for tname, items in by_tbl.items():
        r = rows[tname]
        inv = torch.cat([cl.inverse for _, cl in items], dim=1)
        msk = torch.cat([cl.mask for _, cl in items], dim=1)
        yield tname, items, r[inv] * msk[..., None].to(r.dtype), msk


def _combine_before(self, gl, rows, params=None):
    out = {}
    for _, items, occ_rows, msk in _occurrences_before(self, gl, rows,
                                                       params):
        off = 0
        for cname, cl in items:
            w = cl.inverse.shape[1]
            seg = occ_rows[:, off:off + w]
            if isinstance(cl.column, tfc.SequenceEmbeddingColumn):
                out[cname] = (seg, cl.mask)
            else:
                out[cname] = lkup.combine_from_occ(
                    seg, msk[:, off:off + w], cl.column.combiner,
                    weights=cl.weights)
            off += w
    return self._merge_dyn_hot(out)


def _combine_tables_before(self, gl, rows, params=None):
    return {tname: (occ_rows, [cname for cname, _ in items])
            for tname, items, occ_rows, _ in _occurrences_before(
                self, gl, rows, params)}


# -- cases ------------------------------------------------------------------

def _case(rng, B, columns, dim, n_rows, weighted, pad=0.2, overflow=0.05,
          low=-0.5):
    """Rows ``[n_rows + 1, dim]``, an inverse with padding (``pad``) and
    real occurrences of the overflow row ``U = n_rows`` (``overflow``),
    its mask, and each bag's weights in ``[low, low + 2)`` (None
    unweighted)."""
    L = sum(c.width for c in columns)
    rows = torch.from_numpy(rng.normal(size=(n_rows + 1, dim))
                            .astype(np.float32))
    inv = rng.integers(0, n_rows, (B, L))
    inv[rng.random((B, L)) < overflow] = n_rows
    mask = rng.random((B, L)) >= pad
    mask[rng.random((B, L)) < 0.5 * pad] = False
    weights = [torch.from_numpy((rng.random((B, c.width)) * 2 + low)
                                .astype(np.float32))
               if weighted and not c.sequence else None for c in columns]
    return rows, torch.from_numpy(inv), torch.from_numpy(mask), weights


def _outputs_and_grad(fn, rows, inverse, mask, columns, weights, gouts,
                      stack=False):
    """Outputs and the rows' gradient of ``sum(out * gout)``; with
    ``stack`` the bags' outputs are stacked first, as DLRM stacks them,
    so each bag's gradient comes as a strided view."""
    r = rows.detach().clone().requires_grad_()
    outs = fn(r, inverse, mask, columns, weights)
    pairs = [(o, g) for o, g, c in zip(outs, gouts, columns)
             if g is not None and not (stack and not c.sequence)]
    loss = sum((o * g).sum() for o, g in pairs)
    bags = [(o, g) for o, g, c in zip(outs, gouts, columns)
            if stack and g is not None and not c.sequence]
    if bags:
        loss = loss + (torch.stack([o for o, _ in bags], 1)
                       * torch.stack([g for _, g in bags], 1)).sum()
    (grad,) = torch.autograd.grad(loss, [r])
    return [o.detach() for o in outs], grad


MIXED = (Column(1, False, "sum"), Column(3, False, "sum"),
         Column(4, True, "sum"), Column(2, False, "sum"))


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_plain_matches_the_expressions_before(combiner, weighted):
    rng = np.random.default_rng(len(combiner) + 10 * weighted)
    columns = [c._replace(combiner=combiner) for c in MIXED]
    rows, inv, mask, weights = _case(rng, 24, columns, 5, 17, weighted)
    mask[0] = False          # an empty bag: the denominators' floors
    gouts = [torch.from_numpy(rng.normal(
        size=(24, c.width, 5) if c.sequence else (24, 5)).astype(np.float32))
        for c in columns]
    gouts[3] = None          # a column the loss does not read
    want = _outputs_and_grad(_before, rows, inv, mask, columns, weights,
                             gouts)
    got = _outputs_and_grad(occ.occ_combine, rows, inv, mask, columns,
                            weights, gouts)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    assert torch.equal(got[1], want[1])
    assert got[1][17].abs().sum() > 0   # the overflow row U took gradient


def _group_batch(rng, B, vocab=30):
    """Ids with EMPTY padding (never a whole bag): bag ``a`` of width 3,
    sequence ``s`` of width 4, single-valued ``c`` and ``d``."""
    b = {}
    for name, L in (("a", 3), ("s", 4), ("c", 1), ("d", 1)):
        ids = (rng.zipf(1.2, (B, L)) % vocab).astype(np.int64)
        empty = rng.random((B, L)) < 0.25
        empty[:, 0] = False
        b[name] = tfc.SparseIds.from_numpy(
            np.where(empty, keylib.EMPTY_ID, ids), "cpu")
    b["label"] = torch.from_numpy((rng.random(B) < 0.5).astype(np.float32))
    return b


def _group(fused=False):
    if fused:
        cols = [tfc.EmbeddingColumn(name=n, dim=4, capacity=1 << 8,
                                    combiner="sum") for n in ("c", "d")]
    else:
        cols = [tfc.EmbeddingColumn(name="a", dim=4, capacity=1 << 8,
                                    combiner="sqrtn"),
                tfc.SequenceEmbeddingColumn(name="s", dim=4,
                                            capacity=1 << 8),
                tfc.EmbeddingColumn(name="c", dim=4, capacity=1 << 8,
                                    combiner="mean"),
                tfc.EmbeddingColumn(name="d", dim=4, capacity=1 << 8,
                                    combiner="sum")]
    return tfc.EmbeddingGroup(cols, coalesce=True)


def _apply(p, embs, batch):
    if isinstance(embs, dict) and all(
            isinstance(v, tuple) and isinstance(v[1], list)
            for v in embs.values()):                  # combine_tables
        x = torch.cat([m.reshape(m.shape[0], -1)
                       for _, (m, _) in sorted(embs.items())], dim=1)
    else:
        x = torch.cat([(e[0].sum(dim=1) if isinstance(e, tuple) else e)
                       for _, e in sorted(embs.items())], dim=1)
    return x @ p["w"][:x.shape[1]] + p["b"]


def _loss(out, batch):
    return tlosses.bce_with_logits(out, batch["label"])


@pytest.mark.parametrize("mode", ["micro_batch_2", "combine_tables"])
def test_group_steps_match_the_expressions_before(mode, monkeypatch):
    fused = mode == "combine_tables"
    group = _group(fused)
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(16, generator=gen) * 0.3,
              "b": torch.zeros(())}
    sopt, dopt = tsopt.SparseAdagrad(0.1), tdense.Adagrad(0.1)
    runs = []
    for before in (False, True):
        if before:
            monkeypatch.setattr(tfc.EmbeddingGroup, "combine",
                                _combine_before)
            monkeypatch.setattr(tfc.EmbeddingGroup, "combine_tables",
                                _combine_tables_before)
        ts = tloop.create_train_state(
            group, {k: v.clone() for k, v in params.items()}, dopt, sopt,
            device="cpu")
        step = tloop.make_train_step(
            group, _apply, _loss, sopt, dopt,
            micro_batch_num=1 if fused else 2,
            combine_fn=group.combine_tables if fused else None)
        rng = np.random.default_rng(3)
        losses = []
        for _ in range(3):
            ts, m = step(ts, _group_batch(rng, 32))
            losses.append(m["loss"])
        runs.append((ts, losses))
    (a, la), (b, lb) = runs
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    for t in group.tables:
        assert torch.equal(a.ev[t].values, b.ev[t].values), t
        for k, v in a.slots[t].items():
            assert torch.equal(v, b.slots[t][k]), (t, k)
    for k, v in a.params.items():
        assert torch.equal(v, b.params[k]), k


def _split_rows_by_hand(inverse, mask, n_rows, chunk):
    """Rows with more than ``chunk`` real occurrences."""
    counts = collections.Counter(
        min(max(int(u), 0), n_rows - 1)
        for u, m in zip(inverse.reshape(-1).tolist(),
                        mask.reshape(-1).tolist()) if m)
    return sum(c > chunk for c in counts.values())


def test_grad_split_rows_counts_the_rows_split_off():
    group = _group()
    rng = np.random.default_rng(5)
    batch = _group_batch(rng, 96, vocab=12)
    states = group.create_state("cpu")
    states, gl = group.lookup_train(states, batch, 0)
    rows = {t: lk.rows.detach().requires_grad_()
            for t, lk in gl.lks.items()}
    _, counters = trace.counted(lambda: group.combine(gl, rows))
    total = 0
    for tname in group.tables:
        items = [cl for cl in gl.columns.values() if cl.table_name == tname]
        inv = torch.cat([cl.inverse for cl in items], dim=1)
        msk = torch.cat([cl.mask for cl in items], dim=1)
        n_rows = rows[tname].shape[0]
        want = _split_rows_by_hand(inv, msk, n_rows, occ.CHUNK)
        assert int(counters[f"{tname}/grad_split_rows"]) == want, tname
        assert int(occ.split_rows_reference(inv, msk, n_rows, chunk=7)) \
            == _split_rows_by_hand(inv, msk, n_rows, 7)
        total += want
    assert total > 0


# -- the kernels on a card ----------------------------------------------------

def _zipf_table(rng, B, n_cols, vocab, a=1.2):
    """A table's inverse over Zipf(a) ids folded by ``vocab``, each
    column its own id space: ``[B, n_cols]`` int64 into the distinct ids
    (U = B * n_cols rows, the last the padding row)."""
    ids = (rng.zipf(a, (B, n_cols)) % vocab).astype(np.int64)
    ids += np.arange(n_cols, dtype=np.int64) << 40
    _, inv = np.unique(ids.reshape(-1), return_inverse=True)
    return torch.from_numpy(inv.reshape(B, n_cols).astype(np.int64))


def _within(got, want, bound):
    """|got - want| <= 1e-5 * the same sum over absolute terms: float32
    sums taken in another order (and with fused multiply-adds)."""
    err = (got - want).abs()
    assert bool((err <= 1e-5 * bound + 1e-30).all()), float(err.max())


def _compare(dev, rows, inv, mask, columns, weights, gouts, stack=True,
             exact_grad=False):
    """Kernel against plain version on ``dev`` (non-negative weights):
    the outputs of width-1 bags and of sequence columns bit for bit,
    wider bags within a float32 summation bound; the rows' gradient bit
    for bit where ``exact_grad`` (every scale 1 or 0: the same sums in
    the same order), else within that bound."""
    to = lambda t: None if t is None else t.to(dev)  # noqa: E731
    args = (rows.to(dev), inv.to(dev), mask.to(dev), columns,
            [to(w) for w in weights])
    gd = [to(g) for g in gouts]
    got = _outputs_and_grad(occ.occ_combine, *args, gd, stack=stack)
    want = _outputs_and_grad(occ.occ_combine_reference, *args, gd,
                             stack=stack)
    bound_out, bound = _outputs_and_grad(
        occ.occ_combine_reference, args[0].abs(), args[1], args[2], columns,
        args[4], [None if g is None else g.abs() for g in gd])
    for a, b, c, lim in zip(got[0], want[0], columns, bound_out):
        if c.sequence or c.width == 1:
            assert torch.equal(a, b)
        else:
            _within(a, b, lim)
    if exact_grad:
        assert torch.equal(got[1], want[1])
    else:
        _within(got[1], want[1], bound)
    return got


def _gouts(rng, B, columns, dim):
    return [torch.from_numpy(rng.normal(
        size=(B, c.width, dim) if c.sequence else (B, dim))
        .astype(np.float32)) for c in columns]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["dlrm", "wdl129", "wdl65"])
def test_kernels_at_the_cells_shapes(cuda_device, cell):
    rng = np.random.default_rng(7)
    B, n_cols, dim, comb = {"dlrm": (6912, 26, 128, "sum"),
                            "wdl129": (16384, 8, 129, "mean"),
                            "wdl65": (16384, 18, 65, "mean")}[cell]
    vocab = 10**6 if cell == "dlrm" else 2500
    inv = _zipf_table(rng, B, n_cols, vocab)
    U = B * n_cols
    rows = torch.from_numpy(rng.normal(size=(U + 1, dim)).astype(np.float32))
    mask = torch.ones(B, n_cols, dtype=torch.bool)
    columns = [Column(1, False, comb)] * n_cols
    before = occ.launches
    _compare(cuda_device, rows, inv, mask, columns, [None] * n_cols,
             _gouts(rng, B, columns, dim), exact_grad=True)
    assert occ.launches > before


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [4, 65, 128, 129])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_kernels_on_every_column_kind(cuda_device, combiner, weighted, dim):
    rng = np.random.default_rng(dim)
    columns = [c._replace(combiner=combiner) for c in MIXED] + [
        Column(40, False, combiner), Column(33, True)]
    rows, inv, mask, weights = _case(rng, 300, columns, dim, 997, weighted,
                                     low=0.1)
    mask[0] = False
    gouts = _gouts(rng, 300, columns, dim)
    gouts[3] = None
    for stack in (True, False):
        _compare(cuda_device, rows, inv, mask, columns, weights, gouts,
                 stack=stack, exact_grad=combiner == "sum" and not weighted)


@pytest.mark.cuda
def test_kernels_on_one_hot_row_and_many_columns(cuda_device):
    rng = np.random.default_rng(11)
    # 20,000 occurrences of row 5 among uniform others, bit for bit.
    B, n_cols, dim = 1000, 64, 128
    inv = torch.from_numpy(rng.integers(0, 5000, (B, n_cols)))
    inv.view(-1)[torch.from_numpy(rng.permutation(B * n_cols)[:20000])] = 5
    rows = torch.from_numpy(rng.normal(size=(5001, dim)).astype(np.float32))
    mask = torch.ones(B, n_cols, dtype=torch.bool)
    columns = [Column(1, False, "sum")] * n_cols
    _compare(cuda_device, rows, inv, mask, columns, [None] * n_cols,
             _gouts(rng, B, columns, dim), exact_grad=True)
    # The rows split off, counted by the kernels while tracing.
    r = rows.to(cuda_device).requires_grad_()
    args = (inv.to(cuda_device), mask.to(cuda_device))

    def step():
        out = occ.occ_combine(r, *args, columns, [None] * n_cols, table="t")
        torch.autograd.grad(sum(o.sum() for o in out), [r])

    _, counters = trace.counted(step)
    want = occ.split_rows_reference(inv, mask, 5001)
    assert int(counters["t/grad_split_rows"]) == int(want) > 0
    # More columns than one launch takes: refused, not split.
    inv = torch.from_numpy(rng.integers(0, 700, (300, 65))).to(cuda_device)
    with pytest.raises(ValueError, match="at most 64"):
        occ.occ_combine(r[:701], inv, torch.ones_like(inv, dtype=torch.bool),
                        [Column(1, False, "sum")] * 65, [None] * 65)


@pytest.mark.cuda
def test_kernels_repeat_and_replay_bit_for_bit(cuda_device):
    rng = np.random.default_rng(13)
    B, n_cols, dim = 4096, 26, 129
    inv = _zipf_table(rng, B, n_cols, 2000).to(cuda_device)
    rows = torch.from_numpy(rng.normal(size=(B * n_cols + 1, dim))
                            .astype(np.float32)).to(cuda_device)
    mask = torch.ones(B, n_cols, dtype=torch.bool, device=cuda_device)
    columns = [Column(1, False, "mean")] * n_cols
    gouts = [g.to(cuda_device) for g in _gouts(rng, B, columns, dim)]

    def run():
        # A fresh leaf and detached results, as the train step makes
        # them: no autograd graph outlives a call.
        r = rows.detach().requires_grad_()
        outs = occ.occ_combine(r, inv, mask, columns, [None] * n_cols)
        loss = sum((o * g).sum() for o, g in zip(outs, gouts))
        (g,) = torch.autograd.grad(loss, [r])
        return torch.stack(outs).detach(), g

    a, b = run(), run()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured[0], a[0]) and torch.equal(captured[1], a[1])
