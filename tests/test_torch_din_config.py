"""The benchmark's DIN configuration on the port against its plain
reference, on the CPU.

The port's path (``benchmark/configs/din_amazon_books.py``'s columns and
towers): ``models.din.behavior_columns`` coalesced into one physical
table (``item``/``seq_items`` sharing ``item_emb``, ``cat``/``seq_cats``
sharing ``cat_emb``), the group's training lookup and combine, then
``models.din.DIN``. The reference: ``benchmark/reference/din_amazon_books.py``
over ``benchmark/reference/train.py``'s id -> row tables, which derive
keys and first rows for themselves. Both run at dim 18 with the
published attention and top MLPs, B = 16, histories of 1..6 items, on
seeded weights, in float32; the loss, every tower weight's gradient and
each table row's gradient (by key) must agree. Under a profiler the
attention's counters read B x T and the mask's sum.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from benchmark.manifest import load_module
from benchmark.reference import din_amazon_books as ref
from benchmark.reference import keys as bkeys
from benchmark.reference import train as reflib
from deeprec_tpu_torch.feature_column.feature_column import EmbeddingGroup
from deeprec_tpu_torch.layers.core import DINAttention, init_dense
from deeprec_tpu_torch.train import losses
from deeprec_tpu_torch.utils import keys as keylib
from deeprec_tpu_torch.utils import trace

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T = 16, 6
# float32 throughout, the same tower operations in the same order on
# both sides; only the embedding gather and the summation of each row's
# occurrence gradients are written differently, so the gaps are float32
# rounding of sums over at most B * (2 + T) occurrences a row.
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5


def _cfg():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "din_amazon_books.json")) as f:
        cfg = json.load(f)
    cfg.update(max_seq_len=T, num_users=40, num_items=60, num_cats=7,
               batch_size=B, compute_dtype="float32")
    return cfg


def _builder():
    return load_module(os.path.join(ROOT, "benchmark", "configs",
                                    "din_amazon_books.py"),
                       "benchmark_config_din_amazon_books")


def _raw(cfg, seed):
    r = np.random.default_rng(seed)
    lens = r.integers(1, T + 1, size=B)
    pad = np.arange(T)[None, :] >= lens[:, None]
    items = r.integers(0, cfg["num_items"], size=(B, T))
    cats = items % cfg["num_cats"] + (1 << 41)
    item = r.integers(0, cfg["num_items"], size=(B, 1))
    return {"user": r.integers(0, cfg["num_users"], size=(B, 1)) + (1 << 42),
            "item": item, "cat": item % cfg["num_cats"] + (1 << 41),
            "seq_items": np.where(pad, keylib.EMPTY_ID, items),
            "seq_cats": np.where(pad, keylib.EMPTY_ID, cats),
            "label": (r.random(B) < 0.5).astype(np.float32)}


def _port(cfg, raw):
    """Loss, weight gradients and rows' gradients by key, and the
    attention's mask, through the port."""
    mod = _builder()
    group = EmbeddingGroup(mod.columns(cfg), coalesce=True)
    module, apply_fn = mod.towers(cfg, group, "cpu")
    init_dense(module, torch.Generator().manual_seed(3))
    params = {k: v.detach().clone().requires_grad_()
              for k, v in module.state_dict().items()}
    batch = group.pack_batch_np(raw, "cpu")
    _, gl = group.lookup_train(group.create_state("cpu"), batch,
                               torch.zeros((), dtype=torch.int32))
    rows = {t: lk.rows.detach().requires_grad_() for t, lk in gl.lks.items()}
    embs = group.combine(gl, rows)
    out = apply_fn(params, embs, batch)
    loss = losses.bce_with_logits(out, batch["label"]).mean()
    names = list(params)
    grads = torch.autograd.grad(loss, [params[n] for n in names]
                                + list(rows.values()))
    (t, lk), = gl.lks.items()
    keys = bkeys.join(lk.qhi, lk.qlo)
    by_key = dict(zip(keys.tolist(), grads[len(names)]))
    return (float(loss.detach()), dict(zip(names, grads[:len(names)])),
            by_key, {k: v.detach() for k, v in module.state_dict().items()},
            embs["seq_items"][1])


def _reference(cfg, raw, dense0):
    r = reflib.Reference(cfg, ref.columns(cfg), ref.forward, dense0, "cpu")
    ids = {c["name"]: torch.from_numpy(np.asarray(raw[c["name"]]))
           for c in r.columns}
    embs, uniq = r._embed(ids)
    params = {k: v.clone().requires_grad_() for k, v in r.params.items()}
    labels = torch.from_numpy(raw["label"])
    with reflib.exact_float32():
        logits = ref.forward(params, embs, torch.zeros(B, 0), cfg)
        loss = reflib.bce(logits, labels).sum() / B
    names = list(params)
    (u, _, rows), = uniq.values()
    grads = torch.autograd.grad(loss, [params[n] for n in names] + [rows])
    return (float(loss.detach()), dict(zip(names, grads[:len(names)])),
            dict(zip(u.tolist(), grads[-1])))


@pytest.mark.parametrize("seed", [0, 1])
def test_port_agrees_with_the_reference(seed):
    cfg = _cfg()
    raw = _raw(cfg, seed)
    loss, wgrads, rgrads, dense0, _ = _port(cfg, raw)
    rloss, rwgrads, rrgrads = _reference(cfg, raw, dense0)
    assert loss == pytest.approx(rloss, rel=LOSS_RTOL)
    assert set(wgrads) == set(rwgrads) == set(dense0)
    for n, g in rwgrads.items():
        scale = float(g.abs().max())
        assert scale > 0, n
        torch.testing.assert_close(wgrads[n], g, rtol=0,
                                   atol=GRAD_RTOL * scale, msg=n)
    # Every key the batch touched, read alike by both sides; the port's
    # other unique slots (its budget's filler and the padding row) take
    # no gradient.
    assert set(rrgrads) <= set(rgrads)
    scale = max(float(g.abs().max()) for g in rrgrads.values())
    for k, g in rrgrads.items():
        torch.testing.assert_close(rgrads[k], g, rtol=0,
                                   atol=GRAD_RTOL * scale, msg=str(k))
    for k in set(rgrads) - set(rrgrads):
        assert not rgrads[k].any()


def test_attention_counts_positions():
    cfg = _cfg()
    raw = _raw(cfg, 2)
    (_, _, _, _, mask), counters = trace.counted(lambda: _port(cfg, raw))
    assert int(counters["din.attention/positions"]) == B * T
    assert int(counters["din.attention/real_positions"]) == int(mask.sum())
    assert 0 < int(mask.sum()) < B * T


class _Calls(TorchFunctionMode):
    """The names of the torch functions and tensor methods called."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.names.append(getattr(func, "__name__", repr(func)))
        return func(*args, **(kwargs or {}))


def _attention_calls(traced: bool):
    g = torch.Generator().manual_seed(0)
    att = DINAttention(4, (8, 4), device="cpu")
    init_dense(att, g)
    q, k = torch.randn(3, 4, generator=g), torch.randn(3, 5, 4, generator=g)
    mask = torch.arange(5) < torch.tensor([[1], [3], [5]])
    with _Calls() as calls:
        if traced:
            trace.counted(lambda: att(q, k, mask))
        else:
            att(q, k, mask)
    return calls.names


def test_no_counter_without_a_profiler(monkeypatch):
    monkeypatch.setattr(trace, "recorder", trace.Recorder())
    with trace.recorder.call_counters() as counters:
        _port(_cfg(), _raw(_cfg(), 3))
    assert counters is None
    assert trace.recorder.counters == {} and not trace.recorder.spans
    # Untraced, the attention makes no reduction for its counters, so a
    # captured step holds none; traced, the mask's sum is one.
    assert "sum" not in _attention_calls(False)
    assert "sum" in _attention_calls(True)


def test_macs_per_sample_at_the_published_widths():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "din_amazon_books.json")) as f:
        cfg = json.load(f)
    # attention 50 x (144*80 + 80*40 + 40*1), weighted sum 50 x 36, top
    # MLP 162*200 + 200*80 + 80*1.
    assert _builder().macs_per_sample(cfg) == 738_000 + 1_800 + 48_480
