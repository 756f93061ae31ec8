"""Synthetic Criteo click traffic drawn on the device from a seed.

A frozen copy of the port's ``SyntheticCriteo`` draw and logit model
(``deeprec_tpu_torch/data/criteo.py``), rewritten with torch so that a
pool of millions of samples is made on the card in chunks of a few
large calls instead of on the host: per sample 13 standard-normal
numeric features, 26 categorical ids drawn Zipf(a) and folded by each
column's vocabulary (``z % vocab``, then the column's offset ``i << 40``
so the id spaces are disjoint), and a click drawn from the sigmoid of
the hidden logit (linear, FM, dense-cross and quadratic parts, each
normalized by its spread on a probe draw of 8,192 samples).

Zipf(a) is drawn by inverting its distribution: the values up to
``HEAD`` from a table of the exact cumulative distribution, the tail
past it from its continuous (Pareto) approximation, whose error there is
far below a sample's share (under 1e-8 of a value's probability past
``HEAD``); a value past 2**62 wraps modulo 2**62, and
folding by a vocabulary spreads it alike. The same seed gives the same
draws on one device.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Sequence, Tuple

import torch

NUM_INT = 13
NUM_CAT = 26
PROBE_SAMPLES = 8192
HEAD = 1 << 12
# Samples drawn at once: bounds every temporary of a draw to tens of MB.
CHUNK_SAMPLES = 1 << 18


def sub_seed(seed: int, stream: int) -> int:
    """An independent generator seed for ``stream`` of a run's ``seed``."""
    return (int(seed) * 16 + stream) % (1 << 62)


class Zipf:
    """Zipf(``a``) draws on ``device`` by inversion."""

    def __init__(self, a: float, device):
        self.a = float(a)
        z = torch.arange(1, HEAD + 1, dtype=torch.float64, device=device)
        pmf = z.pow(-self.a)
        tail = (HEAD + 0.5) ** (1.0 - self.a) / (self.a - 1.0)
        self.cdf = torch.cumsum(pmf, 0) / (pmf.sum() + tail)
        self.head_mass = float(self.cdf[-1])

    def sample(self, n: int, gen: torch.Generator) -> torch.Tensor:
        u = torch.rand(n, dtype=torch.float64, generator=gen,
                       device=self.cdf.device)
        head = torch.searchsorted(self.cdf, u, right=True) + 1
        s = (1.0 - u) / (1.0 - self.head_mass)
        tail = torch.floor((HEAD + 0.5) * s.clamp(min=1e-300).pow(
            -1.0 / (self.a - 1.0)) + 0.5)
        tail = torch.fmod(tail, float(1 << 62)).to(torch.int64)
        return torch.where(u < self.head_mass, head, tail)


class ClickModel:
    """The hidden logit of ``SyntheticCriteo``: weights drawn from the
    seed on the device, normalization fixed on a probe draw."""

    def __init__(self, params: Dict, seed: int, device, vocab: torch.Tensor,
                 zipf: Zipf):
        self.nb = int(params["n_buckets"])
        fm = int(params["fm_dim"])
        self.w = torch.tensor([params["w_linear"], params["w_fm"],
                               params["w_cross"], params["w_quad"]],
                              dtype=torch.float32, device=device)
        g = torch.Generator(device=device)
        g.manual_seed(sub_seed(seed, 1))
        sizes = [NUM_CAT * self.nb, NUM_INT, NUM_CAT * self.nb * fm,
                 4 * NUM_INT, 4 * self.nb]
        flat = torch.randn(sum(sizes), generator=g, device=device)
        w_cat, w_int, V, u, s = flat.split(sizes)
        self.w_cat = w_cat.view(NUM_CAT, self.nb)
        self.w_int = w_int
        self.V = V.view(NUM_CAT, self.nb, fm)
        self.u = u.view(4, NUM_INT)
        self.s = s.view(4, self.nb)
        pairs = [(f, (f * 7 + 3) % NUM_CAT) for f in range(NUM_CAT)]
        self.pairs = [(p, q) for p, q in pairs if p != q][:16]
        self.cross_fields = [1, 5, 9, 16]
        self.fields = torch.arange(NUM_CAT, device=device)
        pg = torch.Generator(device=device)
        pg.manual_seed(sub_seed(seed, 3))
        ints = torch.randn(PROBE_SAMPLES, NUM_INT, generator=pg,
                           device=device)
        cats = (zipf.sample(PROBE_SAMPLES * NUM_CAT, pg)
                .view(PROBE_SAMPLES, NUM_CAT) % vocab)
        self.norm = self.parts(ints, cats).std(dim=1, unbiased=False) + 1e-6

    def parts(self, ints, cats):
        b = cats % self.nb
        lin = (ints @ self.w_int / math.sqrt(NUM_INT)
               + self.w_cat[self.fields[None, :], b].sum(1)
               / math.sqrt(NUM_CAT))
        fm = torch.zeros_like(lin)
        for f, g in self.pairs:
            fm += (self.V[f, b[:, f]] * self.V[g, b[:, g]]).sum(1)
        cross = torch.zeros_like(lin)
        for k, f in enumerate(self.cross_fields):
            cross += (ints @ self.u[k]) * self.s[k, b[:, f]]
        quad = (ints[:, :6] * ints[:, 6:12]).sum(1)
        return torch.stack([lin, fm, cross, quad])

    def logits(self, ints, cats):
        return (self.w[:, None] * self.parts(ints, cats)
                / self.norm[:, None]).sum(0)


class ClickStream:
    """Samples over the columns' vocabularies ``vocab`` (26 row counts),
    drawn on ``device`` from ``seed`` with the traffic file's ``zipf_a``
    and ``label_model``."""

    def __init__(self, vocab: Sequence[int], traffic: Dict, seed: int,
                 device):
        if len(vocab) != NUM_CAT:
            raise ValueError(f"vocab needs {NUM_CAT} entries")
        self.device = torch.device(device)
        self.zipf = Zipf(traffic["zipf_a"], self.device)
        self.vocab = torch.tensor(list(vocab), dtype=torch.int64,
                                  device=self.device)
        self.model = ClickModel(traffic["label_model"], seed, self.device,
                                self.vocab, self.zipf)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(sub_seed(seed, 2))

    def chunks(self, n: int) -> Iterator[Tuple[int, int, Dict]]:
        """The stream's next ``n`` samples, in chunks: ``(start, end,
        {"ids": [m, 26] int64 (with the column offsets), "ints": [m, 13]
        float32, "labels": [m] float32})``."""
        for s in range(0, n, CHUNK_SAMPLES):
            m = min(s + CHUNK_SAMPLES, n) - s
            x = torch.randn(m, NUM_INT, generator=self.gen,
                            device=self.device)
            cats = self.zipf.sample(m * NUM_CAT, self.gen).view(
                m, NUM_CAT) % self.vocab
            p = torch.sigmoid(self.model.logits(x, cats))
            labels = (torch.rand(m, generator=self.gen, device=self.device)
                      < p).float()
            ids = cats + (torch.arange(NUM_CAT, dtype=torch.int64,
                                       device=self.device) << 40)
            yield s, s + m, {"ids": ids, "ints": x, "labels": labels}

    def draw(self, n: int) -> Dict[str, torch.Tensor]:
        """The stream's next ``n`` samples, concatenated."""
        parts = [c for _, _, c in self.chunks(n)]
        return {k: torch.cat([c[k] for c in parts]) for k in parts[0]}


class ByColumn:
    """A :class:`ClickStream` in the harness's per-column form: column
    ``names[j]`` takes ``ids[:, j:j + 1]``, one id a sample."""

    def __init__(self, stream: ClickStream, names: Sequence[str]):
        if len(names) != NUM_CAT:
            raise ValueError(f"ClickStream feeds {NUM_CAT} columns, "
                             f"not {len(names)}")
        self.stream = stream
        self.widths = {n: 1 for n in names}

    def chunks(self, n: int) -> Iterator[Tuple[int, int, Dict]]:
        for s, e, c in self.stream.chunks(n):
            ids = {name: c["ids"][:, j:j + 1]
                   for j, name in enumerate(self.widths)}
            yield s, e, dict(c, ids=ids)
