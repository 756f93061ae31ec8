"""Synthetic user-behavior-sequence stream (Amazon-Books / Taobao
shape), the port's own copy of ``deeprec_tpu/data/behavior.py`` (which
imports the JAX package's feature columns): the same seed draws the
same ids and labels.

It feeds DIN, DIEN, BST and DSSM: a candidate item and category, the
user's recent item and category sequence (padded with the EMPTY id),
and a click label whose logit mixes the mean-history affinity, a
recency-weighted affinity (order matters), a category match and a
per-user bias. Items are drawn Zipf within cluster-coherent histories.
Per-field key offsets (``1 << 41`` for categories, ``1 << 42`` for
users) keep the id spaces apart in shared tables.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from deeprec_tpu_torch.feature_column.feature_column import SparseIds
from deeprec_tpu_torch.utils import keys as keylib

SPARSE = ("user", "item", "cat", "seq_items", "seq_cats")


class SyntheticBehavior:
    def __init__(self, batch_size: int, num_items: int = 2000,
                 num_cats: int = 100, num_users: int = 1000,
                 seq_len: int = 20, seed: int = 0,
                 n_clusters: int = 32, zipf_a: float = 1.3,
                 w_aff: float = 1.0, w_rec: float = 1.0,
                 w_cat: float = 0.8, w_user: float = 0.4,
                 recency_decay: float = 0.8):
        self.batch_size = batch_size
        self.num_items = num_items
        self.num_cats = num_cats
        self.num_users = num_users
        self.seq_len = seq_len
        self.nc = min(n_clusters, num_items)
        self.zipf_a = zipf_a
        self.w = np.array([w_aff, w_rec, w_cat, w_user])
        self.decay = recency_decay
        self.rng = np.random.default_rng(seed)
        r = np.random.default_rng(seed + 1)
        # Latent item vectors: cluster center + item noise.
        centers = r.normal(0, 1, size=(self.nc, 8))
        self._item_vec = (centers[np.arange(num_items) % self.nc]
                          + 0.5 * r.normal(0, 1, size=(num_items, 8)))
        # Several categories per cluster.
        self._cat_of = ((np.arange(num_items) % self.nc)
                        * max(1, num_cats // self.nc)
                        + r.integers(0, max(1, num_cats // self.nc),
                                     size=num_items)) % num_cats
        self._user_bias = r.normal(0, 1, size=num_users)
        self._user_cluster = r.integers(0, self.nc, size=num_users)
        self._norm = None

    def _zipf_item_in_cluster(self, cluster, size):
        """Zipf-ranked item of a cluster: rank r -> the r-th item with
        item % nc == cluster."""
        per = max(1, self.num_items // self.nc)
        r = self.rng.zipf(self.zipf_a, size=size) % per
        return (cluster + self.nc * r) % self.num_items

    def _logit_parts(self, item, seq, seq_lens, user):
        T = seq.shape[1]
        mask = np.arange(T)[None, :] < seq_lens[:, None]
        iv = self._item_vec
        cand = iv[item]                                        # [B, 8]
        hist = (iv[seq] * mask[:, :, None]).sum(1) / np.maximum(
            seq_lens[:, None], 1)
        aff = (hist * cand).sum(1)
        # Recency: weight decay^(len-1-t) for t < len (latest = 1).
        age = (seq_lens[:, None] - 1 - np.arange(T)[None, :])
        w_t = np.where(mask, self.decay ** np.maximum(age, 0), 0.0)
        rec_hist = (iv[seq] * w_t[:, :, None]).sum(1) / np.maximum(
            w_t.sum(1, keepdims=True), 1e-6)
        rec = (rec_hist * cand).sum(1)
        cat_match = (np.where(mask, self._cat_of[seq], -1)
                     == self._cat_of[item][:, None]).any(1).astype(float)
        bias = self._user_bias[user]
        return np.stack([aff, rec, cat_match - cat_match.mean(), bias], 0)

    def logits(self, item, seq, seq_lens, user) -> np.ndarray:
        parts = self._logit_parts(item, seq, seq_lens, user)
        if self._norm is None:
            self._norm = parts.std(1) + 1e-6
        return (self.w[:, None] * parts / self._norm[:, None]).sum(0)

    def next_batch_np(self) -> Dict[str, np.ndarray]:
        """The next batch as raw numpy: ``label`` float32 [B] and int64
        id matrices ``user``, ``item``, ``cat`` [B, 1] and ``seq_items``,
        ``seq_cats`` [B, T] (EMPTY-padded), for
        ``EmbeddingGroup.pack_batch_np``."""
        B, T = self.batch_size, self.seq_len
        rng = self.rng
        user = rng.integers(0, self.num_users, size=B)
        cu = self._user_cluster[user]
        # Cluster-coherent history with 20 % random exploration.
        seq = self._zipf_item_in_cluster(cu[:, None], (B, T)).astype(np.int64)
        explore = rng.random((B, T)) < 0.2
        seq = np.where(explore,
                       rng.integers(0, self.num_items, size=(B, T)), seq)
        seq_lens = rng.integers(1, T + 1, size=B)
        # Candidate: half in-cluster, half random.
        in_c = rng.random(B) < 0.5
        item = np.where(
            in_c, self._zipf_item_in_cluster(cu, B),
            rng.integers(0, self.num_items, size=B)).astype(np.int64)

        logit = self.logits(item, seq, seq_lens, user)
        p = 1.0 / (1.0 + np.exp(-logit))
        label = (rng.random(B) < p).astype(np.float32)

        mask = np.arange(T)[None, :] < seq_lens[:, None]
        item = item[:, None]
        seq_pad = np.where(mask, seq, keylib.EMPTY_ID)
        cats = self._cat_of[item[:, 0]][:, None].astype(np.int64) + (1 << 41)
        seq_cats = np.where(
            mask, self._cat_of[seq].astype(np.int64) + (1 << 41),
            keylib.EMPTY_ID)
        return {
            "label": label,
            "user": user[:, None].astype(np.int64) + (1 << 42),
            "item": item,
            "cat": cats,
            "seq_items": seq_pad,
            "seq_cats": seq_cats,
        }

    def next_batch(self, device="cuda") -> Dict:
        """The next batch with each sparse field as ``SparseIds`` on
        ``device``, the JAX package's ``next_batch`` layout."""
        b = self.next_batch_np()
        return {k: (SparseIds.from_numpy(v, device) if k in SPARSE else v)
                for k, v in b.items()}

    def __iter__(self):
        while True:
            yield self.next_batch()
