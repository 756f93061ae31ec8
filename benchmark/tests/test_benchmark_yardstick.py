"""The frozen yardstick: the device generator against numpy's
``SyntheticCriteo``, the FLOP and byte functions against hand counts,
the trace arithmetic, and the reference's key arithmetic against the
port's at the time it was frozen."""

import json
import os

import numpy as np
import torch

from benchmark import devtrace, generator, roofline
from benchmark.manifest import load_module
from benchmark.reference import keys as keylib
from benchmark.tests.conftest import REPO
from deeprec_tpu_torch.data.criteo import SyntheticCriteo

TRAFFIC = {"zipf_a": 1.2, "label_model": {
    "w_linear": 0.8, "w_fm": 1.5, "w_cross": 0.8, "w_quad": 0.5,
    "fm_dim": 4, "n_buckets": 2048}}


def test_generator_matches_numpy_histogram():
    vocab = [50, 1000, 100000] * 8 + [7, 300]
    n = 20000
    dev = generator.ClickStream(vocab, TRAFFIC, seed=3, device="cpu").draw(n)
    ids = (dev["ids"] - (torch.arange(26) << 40)).numpy()
    ref = SyntheticCriteo(n, vocab=vocab, seed=3)
    ints, cats = ref._draw(n)
    def close(a, b):
        # five standard errors of the difference of two shares
        p = (a + b) / 2
        return abs(a - b) <= 5 * np.sqrt(2 * p * (1 - p) / n) + 1e-4

    for j in (0, 1, 2, 25):
        for v in (0, 1, 2, 10, 49):
            a, b = (ids[:, j] == v).mean(), (cats[:, j] == v).mean()
            assert close(a, b), (j, v, a, b)
        # the folded tail: the share of ids past 100
        a, b = (ids[:, j] >= 100).mean(), (cats[:, j] >= 100).mean()
        assert close(a, b), (j, a, b)
    assert (ids >= 0).all() and (ids < np.array(vocab)).all()
    assert abs(dev["ints"].std().item() - 1.0) < 0.02


def test_labels_follow_the_logit_model():
    """Clicks are Bernoulli draws of the sigmoid of the hidden logit,
    whose four parts are normalized to unit spread."""
    vocab = [50, 1000, 100000] * 8 + [7, 300]
    st = generator.ClickStream(vocab, TRAFFIC, seed=4, device="cpu")
    d = st.draw(40000)
    cats = d["ids"] - (torch.arange(26) << 40)
    p = torch.sigmoid(st.model.logits(d["ints"], cats))
    se = (p * (1 - p)).mean().sqrt().item() / 200
    assert abs(d["labels"].mean().item() - p.mean().item()) < 5 * se
    parts = st.model.parts(d["ints"], cats) / st.model.norm[:, None]
    assert torch.allclose(parts.std(dim=1), torch.ones(4), atol=0.1)


def test_generator_is_seeded():
    a = generator.ClickStream([100] * 26, TRAFFIC, 5, "cpu").draw(128)
    b = generator.ClickStream([100] * 26, TRAFFIC, 5, "cpu").draw(128)
    c = generator.ClickStream([100] * 26, TRAFFIC, 6, "cpu").draw(128)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["ids"], c["ids"])


def _cfg(name):
    with open(os.path.join(REPO, "benchmark", "configs", name + ".json")) as f:
        cfg = json.load(f)
    mod = load_module(os.path.join(REPO, "benchmark", "configs",
                                   name + ".py"), "cfg_" + name)
    return cfg, mod


def test_macs_by_hand():
    cfg, mod = _cfg("wdl_criteo")
    small = dict(cfg, embedding_dims=[2] * 26, num_int_features=13,
                 dnn_hidden_units=[4, 3])
    # deep input 26 * 2 + 13 = 65: 65*4 + 4*3 + 3*1
    assert mod.macs_per_sample(small) == 65 * 4 + 12 + 3
    assert mod.macs_per_sample(cfg) == 2_897_152
    cfg, mod = _cfg("dlrm_mlperf")
    small = dict(cfg, arch_mlp_bot=[13, 8, 4], arch_mlp_top=[6, 1],
                 arch_sparse_feature_size=4,
                 num_embeddings_per_feature=[10] * 3)
    # bottom 13*8 + 8*4; 4 vectors: 16 * 4 MACs of their products; top
    # input 4 + 6 pairs = 10: 10*6 + 6*1
    assert mod.macs_per_sample(small) == 104 + 32 + 64 + 60 + 6
    assert mod.macs_per_sample(cfg) == 2_458_496


def test_bytes_by_hand():
    assert roofline.probe_bytes(key_rows=3, ids=10) == 3 * 512 + 140
    # 2 old rows and 1 new of dim 4: 2*4*20 + 1*4*16 + 3*6
    assert roofline.apply_bytes(4, applied=3, fresh=1) == 160 + 64 + 18
    keys = torch.tensor([[5, 5, 7, 9], [1, 2, 3, 4]], dtype=torch.int64)
    c = roofline.step_counts(keys, capacity=1 << 20)
    assert c["ids"] == 8 and c["applied"] == 3 + 4
    rows = keylib.home_row(keys.reshape(-1), 1 << 20).view(2, 4)
    assert c["key_rows"] == sum(len(set(r.tolist())) for r in rows)


def test_trace_union_and_gaps():
    ev = [{"cat": "user_annotation", "name": "traced_window", "ph": "X",
           "ts": 0.0, "dur": 50.0},
          {"cat": "user_annotation", "name": "pool_call", "ph": "X",
           "ts": 0.0, "dur": 10.0},
          {"cat": "user_annotation", "name": "release", "ph": "X",
           "ts": 60.0, "dur": 20.0},
          {"cat": "kernel", "name": "a", "ph": "X", "ts": 10.0, "dur": 30.0},
          {"cat": "kernel", "name": "b", "ph": "X", "ts": 20.0, "dur": 40.0},
          {"cat": "kernel", "name": "a", "ph": "X", "ts": 70.0, "dur": 30.0}]
    t = devtrace.Trace(ev, ("pool_call", "release"))
    assert t.window_us == 100.0 and t.busy_us == 80.0
    assert sorted(t.gaps) == [("pool_call", 10.0), ("release", 10.0)]
    assert t.by_name() == {"a": 60.0, "b": 40.0}
    assert t.device_us([r"^a$"]) == 60.0


def test_keys_match_the_port():
    """The frozen key arithmetic equals the port's at the time of
    writing (salts, coalescing, the first rows, the probe's start)."""
    from deeprec_tpu_torch.embedding import hash_table as ht
    from deeprec_tpu_torch.feature_column.feature_column import (
        EmbeddingGroup, _member_salt)
    from deeprec_tpu_torch.utils import keys as pkeys
    from deeprec_tpu_torch.utils import stateless_random as srand
    cfg, mod = _cfg("wdl_criteo")
    group = EmbeddingGroup(mod.columns(cfg), coalesce=True)
    ref_mod = load_module(os.path.join(REPO, "benchmark", "reference",
                                       "wdl_criteo.py"), "ref_wdl")
    specs = keylib.tables_of(ref_mod.columns(cfg))
    assert [keylib.member_salt(i) for i in range(30)] == [
        _member_salt(i) for i in range(30)]
    ids = torch.tensor([3, 99, (5 << 40) + 17, -7], dtype=torch.int64)
    for c in group.embedding:
        spec = next(s for s in specs if c.name in s["members"])
        t = group.physical_table_of(c)
        assert group.salts[t] == spec["salt"] and group.tables[t].dim == \
            spec["dim"]
        hi, lo = group.transform_ids(c, *keylib.split(ids))
        assert torch.equal(keylib.join(hi, lo),
                           keylib.salted(ids, spec["members"][c.name]))
        want = srand.truncated_normal_rows(hi, lo, spec["dim"],
                                           stddev=spec["dim"] ** -0.5,
                                           salt=spec["salt"])
        got = keylib.init_rows(keylib.join(hi, lo), spec["dim"],
                               spec["salt"])
        assert torch.allclose(got, want, rtol=0, atol=1e-6)
        cap = group.tables[t].capacity
        assert torch.equal(keylib.home_row(keylib.join(hi, lo), cap),
                           (ht._start_slots(hi, lo, cap) // 64).long())
    assert pkeys.EMPTY_HI == keylib.EMPTY_HI
