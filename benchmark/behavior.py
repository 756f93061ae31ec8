"""Synthetic user-behavior traffic drawn on the device from a seed.

A frozen copy of the port's ``SyntheticBehavior`` draw and click model
(``deeprec_tpu_torch/data/behavior.py``; the Amazon-Books / Taobao shape
DIN, DIEN and BST train on), rewritten with torch so that a pool is made
on the card in a few large calls a block instead of on the host. A
sample is a user, a candidate item and its category, the user's recent
items and their categories, and a click:

* each item belongs to cluster ``item % n_clusters``, has a latent
  vector (its cluster's centre plus noise of half its spread) and a
  category among its cluster's ``num_cats // n_clusters``; each user
  has a cluster and a bias;
* a history has a length uniform on ``1..seq_len``; each of its items
  is, with probability 0.8, the Zipf(``zipf_a``)-ranked item of the
  user's cluster (rank ``z % (num_items // n_clusters)``; this
  benchmark's ``generator.Zipf``) and otherwise uniform over the items;
* the candidate is such a Zipf-ranked item of the user's cluster or,
  with probability one half, uniform;
* the click is drawn from the sigmoid of four parts, each divided by
  its spread: the affinity of the candidate to the history's mean
  vector, its affinity to the recency-weighted mean (``recency_decay``
  to the power of a position's age), whether the history holds the
  candidate's category, and the user's bias, weighted by ``w_aff``,
  ``w_rec``, ``w_cat`` and ``w_user``.

Ids as the port's columns take them: ``user`` (plus ``1 << 42``),
``item``, ``cat`` (plus ``1 << 41``) one a sample, ``seq_items`` and
``seq_cats`` ``seq_len`` a sample, the EMPTY id (the int64 minimum) past
the history's length.

Where the copy departs from the original, it is so that a sample's draw
depends on the seed and its position alone, not on how the stream is
cut into chunks: the spreads that normalise the four parts, and the
mean that centres the category part, come from a probe draw of
``PROBE_SAMPLES`` samples (the original takes both from its first
batch); and samples are drawn in blocks of ``BLOCK``, block ``b`` from
a generator of its own, seeded from ``sub_seed(seed, 2)`` and ``b``.
The world (vectors, categories, users) comes from ``sub_seed(seed, 1)``
and the probe from ``sub_seed(seed, 3)``. The same seed gives the same
draws on one device.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch

from benchmark.generator import CHUNK_SAMPLES, PROBE_SAMPLES, Zipf, sub_seed

BLOCK = 1 << 14
CAT_OFFSET = 1 << 41
USER_OFFSET = 1 << 42
EMPTY_ID = -(1 << 63)
EXPLORE = 0.2
VEC_DIM = 8
PHI64 = 0x9E3779B97F4A7C15


class BehaviorStream:
    """Behavior samples of the traffic file's ``seq_len``, ``num_items``,
    ``num_cats``, ``num_users``, ``n_clusters``, ``zipf_a``, ``w_aff``,
    ``w_rec``, ``w_cat``, ``w_user`` and ``recency_decay``, drawn on
    ``device`` from ``seed``."""

    def __init__(self, traffic: Dict, seed: int, device):
        self.device = torch.device(device)
        self.T = int(traffic["seq_len"])
        self.n_items = int(traffic["num_items"])
        self.n_cats = int(traffic["num_cats"])
        self.n_users = int(traffic["num_users"])
        self.nc = min(int(traffic["n_clusters"]), self.n_items)
        self.per = max(1, self.n_items // self.nc)
        self.decay = float(traffic["recency_decay"])
        self.w = torch.tensor([traffic["w_aff"], traffic["w_rec"],
                               traffic["w_cat"], traffic["w_user"]],
                              dtype=torch.float32, device=self.device)
        self.zipf = Zipf(traffic["zipf_a"], self.device)
        self.block_seed = sub_seed(seed, 2) * PHI64
        self.widths = {"user": 1, "item": 1, "cat": 1,
                       "seq_items": self.T, "seq_cats": self.T}
        self.pos = 0
        g = self._gen(sub_seed(seed, 1))
        dev, n_i = self.device, self.n_items
        cluster = torch.arange(n_i, device=dev) % self.nc
        centers = torch.randn(self.nc, VEC_DIM, generator=g, device=dev)
        self.item_vec = centers[cluster] + 0.5 * torch.randn(
            n_i, VEC_DIM, generator=g, device=dev)
        per_c = max(1, self.n_cats // self.nc)
        self.cat_of = (cluster * per_c + torch.randint(
            0, per_c, (n_i,), generator=g, device=dev)) % self.n_cats
        self.user_bias = torch.randn(self.n_users, generator=g, device=dev)
        self.user_cluster = torch.randint(0, self.nc, (self.n_users,),
                                          generator=g, device=dev)
        user, item, seq, lens = self._behavior(
            PROBE_SAMPLES, self._gen(sub_seed(seed, 3)))
        parts = self.parts(item, seq, lens, user)
        self.cat_mean = parts[2].mean()
        parts[2] -= self.cat_mean
        self.norm = parts.std(dim=1, unbiased=False) + 1e-6

    def _gen(self, seed: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(seed % (1 << 62))
        return g

    def _in_cluster(self, cluster: torch.Tensor, g) -> torch.Tensor:
        """A Zipf-ranked item of each ``cluster``."""
        r = self.zipf.sample(cluster.numel(), g).view(cluster.shape) \
            % self.per
        return (cluster + self.nc * r) % self.n_items

    def _behavior(self, m: int, g):
        """``m`` users, candidates, histories [m, T] and lengths."""
        dev, T = self.device, self.T
        user = torch.randint(0, self.n_users, (m,), generator=g, device=dev)
        cu = self.user_cluster[user]
        seq = self._in_cluster(cu[:, None].expand(m, T), g)
        explore = torch.rand(m, T, generator=g, device=dev) < EXPLORE
        seq = torch.where(explore, torch.randint(
            0, self.n_items, (m, T), generator=g, device=dev), seq)
        lens = torch.randint(1, T + 1, (m,), generator=g, device=dev)
        in_c = torch.rand(m, generator=g, device=dev) < 0.5
        item = torch.where(in_c, self._in_cluster(cu, g), torch.randint(
            0, self.n_items, (m,), generator=g, device=dev))
        return user, item, seq, lens

    def parts(self, item, seq, lens, user) -> torch.Tensor:
        """[4, m]: the mean-history affinity, the recency-weighted
        affinity, the category match (not centred) and the user bias."""
        T = seq.shape[1]
        pos = torch.arange(T, device=self.device)
        mask = pos[None, :] < lens[:, None]
        cand = self.item_vec[item]
        hist_v = self.item_vec[seq] * mask[..., None]
        hist = hist_v.sum(1) / lens.clamp(min=1)[:, None]
        age = (lens[:, None] - 1 - pos[None, :]).clamp(min=0)
        w_t = torch.where(mask, torch.pow(self.decay, age.float()), 0.0)
        rec_hist = (hist_v * w_t[..., None]).sum(1) / w_t.sum(
            1, keepdim=True).clamp(min=1e-6)
        cat_match = (torch.where(mask, self.cat_of[seq], -1)
                     == self.cat_of[item][:, None]).any(1).float()
        return torch.stack([(hist * cand).sum(1), (rec_hist * cand).sum(1),
                            cat_match, self.user_bias[user]])

    def logits(self, item, seq, lens, user) -> torch.Tensor:
        p = self.parts(item, seq, lens, user)
        p[2] -= self.cat_mean
        return (self.w[:, None] * p / self.norm[:, None]).sum(0)

    def _block(self, b: int) -> Dict:
        """The samples of block ``b``."""
        g = self._gen(self.block_seed + b)
        user, item, seq, lens = self._behavior(BLOCK, g)
        p = torch.sigmoid(self.logits(item, seq, lens, user))
        labels = (torch.rand(BLOCK, generator=g, device=self.device)
                  < p).float()
        mask = (torch.arange(self.T, device=self.device)[None, :]
                < lens[:, None])
        ids = {"user": (user + USER_OFFSET)[:, None],
               "item": item[:, None],
               "cat": (self.cat_of[item] + CAT_OFFSET)[:, None],
               "seq_items": torch.where(mask, seq, EMPTY_ID),
               "seq_cats": torch.where(mask, self.cat_of[seq] + CAT_OFFSET,
                                       EMPTY_ID)}
        return {"ids": ids, "labels": labels}

    def chunks(self, n: int) -> Iterator[Tuple[int, int, Dict]]:
        """The stream's next ``n`` samples in chunks of at most
        ``CHUNK_SAMPLES``: ``(start, end, {"ids": {column: [m, L] int64},
        "ints": [m, 0], "labels": [m] float32})``."""
        first = self.pos
        self.pos += n
        for s in range(0, n, CHUNK_SAMPLES):
            a, e = first + s, first + min(s + CHUNK_SAMPLES, n)
            blocks = [self._block(b)
                      for b in range(a // BLOCK, (e - 1) // BLOCK + 1)]
            lo, hi = a - a // BLOCK * BLOCK, e - a // BLOCK * BLOCK
            ids = {k: torch.cat([bl["ids"][k] for bl in blocks])[lo:hi]
                   for k in self.widths}
            labels = torch.cat([bl["labels"] for bl in blocks])[lo:hi]
            yield s, s + e - a, {
                "ids": ids, "labels": labels,
                "ints": torch.empty(e - a, 0, device=self.device)}

    def draw(self, n: int) -> Dict:
        """The stream's next ``n`` samples, concatenated."""
        parts = [c for _, _, c in self.chunks(n)]
        return {"ids": {k: torch.cat([c["ids"][k] for c in parts])
                        for k in self.widths},
                "ints": torch.cat([c["ints"] for c in parts]),
                "labels": torch.cat([c["labels"] for c in parts])}
