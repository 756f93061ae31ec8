"""The behavior stream (``benchmark/behavior.py``): seeded, cut into
chunks without changing a draw, padded exactly past each history's
length, categories that follow their items, and the statistics of the
port's numpy ``SyntheticBehavior`` at DIN's sizes."""

import numpy as np
import pytest
import torch

from benchmark import behavior
from deeprec_tpu_torch.data.behavior import SyntheticBehavior

SMALL = {"seq_len": 7, "num_items": 900, "num_cats": 30, "num_users": 500,
         "n_clusters": 8, "zipf_a": 1.3, "w_aff": 1.0, "w_rec": 1.0,
         "w_cat": 0.8, "w_user": 0.4, "recency_decay": 0.8}
# Amazon Books' counts (users, items, categories), histories of 50.
BOOKS = dict(SMALL, seq_len=50, num_items=367983, num_cats=1601,
             num_users=543060, n_clusters=32)
SEED = 2 ** 31 + 12345


def _equal(a, b):
    return (all(torch.equal(a["ids"][k], b["ids"][k]) for k in a["ids"])
            and torch.equal(a["labels"], b["labels"])
            and a["ints"].shape == b["ints"].shape)


def test_seeded_and_chunking_changes_nothing(monkeypatch):
    n = 3 * behavior.BLOCK + 77
    whole = behavior.BehaviorStream(SMALL, SEED, "cpu").draw(n)
    assert _equal(whole, behavior.BehaviorStream(SMALL, SEED, "cpu").draw(n))
    other = behavior.BehaviorStream(SMALL, SEED + 1, "cpu").draw(n)
    assert not torch.equal(whole["ids"]["seq_items"],
                           other["ids"]["seq_items"])
    # Smaller chunks, and the samples asked for in three calls.
    monkeypatch.setattr(behavior, "CHUNK_SAMPLES", 1000)
    st = behavior.BehaviorStream(SMALL, SEED, "cpu")
    parts = [st.draw(k) for k in (5, behavior.BLOCK, n - 5 - behavior.BLOCK)]
    cut = {"ids": {k: torch.cat([p["ids"][k] for p in parts])
                   for k in whole["ids"]},
           "ints": torch.cat([p["ints"] for p in parts]),
           "labels": torch.cat([p["labels"] for p in parts])}
    assert _equal(whole, cut)
    spans = [(s, e) for s, e, _ in behavior.BehaviorStream(
        SMALL, SEED, "cpu").chunks(2500)]
    assert spans == [(0, 1000), (1000, 2000), (2000, 2500)]


def test_padding_categories_and_offsets():
    st = behavior.BehaviorStream(SMALL, SEED, "cpu")
    d = st.draw(5000)
    ids, T = d["ids"], SMALL["seq_len"]
    assert st.widths == {k: v.shape[1] for k, v in ids.items()}
    real = ids["seq_items"] != behavior.EMPTY_ID
    lens = real.sum(1)
    assert lens.min() == 1 and lens.max() == T
    # Padding exactly at the positions past the history's length.
    assert torch.equal(real, torch.arange(T)[None, :] < lens[:, None])
    assert torch.equal(ids["seq_cats"] != behavior.EMPTY_ID, real)
    assert torch.equal(ids["seq_cats"][real],
                       st.cat_of[ids["seq_items"][real]] + (1 << 41))
    assert torch.equal(ids["cat"], st.cat_of[ids["item"]] + (1 << 41))
    user = ids["user"] - (1 << 42)
    assert user.min() >= 0 and user.max() < SMALL["num_users"]
    assert ids["item"].min() >= 0 and ids["item"].max() < SMALL["num_items"]
    assert d["ints"].shape == (5000, 0)
    assert set(d["labels"].unique().tolist()) == {0.0, 1.0}


def _stats(user, seq, labels, user_cluster, nc):
    real = seq != behavior.EMPTY_ID
    items = seq[real]
    uc = np.broadcast_to(user_cluster[user][:, None], seq.shape)[real]
    _, cnt = np.unique(items, return_counts=True)
    return np.array([labels.mean(), real.sum(1).mean(),
                     ((items % nc) == uc).mean(),
                     np.sort(cnt)[::-1][:100].sum() / items.size])


def test_agrees_with_the_numpy_original():
    """On 3 seeds a side at B = 4,096 and T = 50, the mean of each
    statistic. Each tolerance is five standard errors of the gap between
    two 3-seed means, from the larger seed-to-seed spread of the two
    sides over 12 seeds of each: click rate 0.012 (mostly the world's
    draw: item vectors and clusters), mean history length 0.21, share of
    history items in the user's cluster 0.0015, the top-100 items' share
    of history items 0.0012."""
    B, off = 4096, 1 << 42
    ours, theirs = [], []
    for k in range(3):
        st = behavior.BehaviorStream(BOOKS, SEED + 7919 * k, "cpu")
        d = st.draw(B)
        ours.append(_stats(d["ids"]["user"][:, 0].numpy() - off,
                           d["ids"]["seq_items"].numpy(),
                           d["labels"].numpy(), st.user_cluster.numpy(),
                           st.nc))
        ref = SyntheticBehavior(B, seed=k, **BOOKS)
        b = ref.next_batch_np()
        theirs.append(_stats(b["user"][:, 0] - off, b["seq_items"],
                             b["label"], ref._user_cluster, ref.nc))
    gap = np.abs(np.mean(ours, 0) - np.mean(theirs, 0))
    tol = 5 * np.sqrt(2 / 3) * np.array([0.012, 0.21, 0.0015, 0.0012])
    assert (gap <= tol).all(), (gap, tol)
    # Each side reads what the model implies: lengths uniform on 1..50,
    # 0.8 + 0.2 / 32 of history items in the user's cluster.
    assert np.mean(ours, 0)[1] == pytest.approx(25.5, abs=1.0)
    assert np.mean(ours, 0)[2] == pytest.approx(0.8 + 0.2 / 32, abs=0.006)
