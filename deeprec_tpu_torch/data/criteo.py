"""Synthetic Criteo stream, Kaggle TSV parsing and batch helpers.

Port of ``deeprec_tpu/data/criteo.py`` for the generator
(``SyntheticCriteo``: the same seed draws the same ids, numerics and
labels as the JAX package) and the file reader (``parse_criteo_lines``,
``criteo_file_batches``: the same file gives the same batches).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from deeprec_tpu_torch.feature_column.feature_column import SparseIds

_MASK64 = (1 << 64) - 1
_MASK40 = (1 << 40) - 1
_HEX = frozenset("0123456789abcdefABCDEF")

NUM_INT = 13
NUM_CAT = 26

# Reference per-column Criteo cardinalities and WDL embedding dims
# (``modelzoo/WDL/train.py:40-96``).
CRITEO_HASH_BUCKETS = [
    2500, 2000, 300000, 250000, 1000, 100, 20000, 4000, 20, 100000,
    10000, 250000, 40000, 100, 100, 200000, 50, 10000, 4000, 20,
    250000, 100, 100, 250000, 400, 100000]
WDL_EMBEDDING_DIMS = [
    64, 64, 128, 128, 64, 64, 64, 64, 64, 128, 64, 128, 64, 64, 64,
    128, 64, 64, 64, 64, 128, 64, 64, 128, 64, 128]


def capacity_for(bucket: int, ceiling: Optional[int] = None,
                 headroom: float = 1.3) -> int:
    """Power-of-two EV capacity covering a reference hash-bucket count
    with probe headroom, optionally clipped."""
    cap = 1 << max(8, int(np.ceil(np.log2(bucket * headroom))))
    return min(cap, ceiling) if ceiling else cap


def batch_np_dict(labels, ints, cats, wide: bool = True) -> Dict:
    """Raw numpy batch for ``EmbeddingGroup.pack_batch_np``.
    ``wide=False`` skips the ``C*_wide`` duplicate id columns."""
    batch = {"label": labels.astype(np.float32)}
    for i in range(NUM_INT):
        batch[f"I{i+1}"] = ints[:, i].astype(np.float32)
    for i in range(NUM_CAT):
        ids = cats[:, i:i + 1]
        batch[f"C{i+1}"] = ids
        if wide:
            batch[f"C{i+1}_wide"] = ids
    return batch


def _with_sparse_ids(batch: Dict, device) -> Dict:
    """A ``batch_np_dict`` batch with each sparse column as ``SparseIds``
    on ``device``."""
    return {k: (SparseIds.from_numpy(v, device) if k.startswith("C") else v)
            for k, v in batch.items()}


def _hash_token(token: str) -> int:
    """FNV-1a + splitmix64 of a token's UTF-8 bytes, as uint64: the
    host parser's hash of a non-hex token (``parse_cat_token`` in
    ``native/host_ops.cc``)."""
    h = 0xCBF29CE484222325
    for c in token.encode():
        h = ((h ^ c) * 0x100000001B3) & _MASK64
    h = (h + 0x9E3779B97F4A7C15) & _MASK64
    h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
    return h ^ (h >> 31)


def parse_criteo_lines(lines, hash_mod: Optional[int] = None):
    """Parse raw Kaggle TSV lines -> (labels, ints, cats int64), in
    Python.

    Missing ints read 0; a categorical hex token is its value masked to
    40 bits (any other token is hashed), plus a per-field offset
    ``i << 40``; ints are log-normalized as the modelzoo does.
    """
    B = len(lines)
    labels = np.zeros((B,), np.float32)
    ints = np.zeros((B, NUM_INT), np.float32)
    cats = np.zeros((B, NUM_CAT), np.int64)
    for r, line in enumerate(lines):
        parts = line.rstrip("\n").split("\t")
        labels[r] = float(parts[0] or 0)
        for i in range(NUM_INT):
            v = parts[1 + i] if 1 + i < len(parts) else ""
            ints[r, i] = float(v) if v else 0.0
        for i in range(NUM_CAT):
            v = parts[1 + NUM_INT + i] if 1 + NUM_INT + i < len(parts) else ""
            if not v:
                h = 0
            elif all(c in _HEX for c in v):
                h = int(v, 16) & _MASK40
            else:
                h = _hash_token(v) & _MASK40
            if hash_mod:
                h %= hash_mod
            cats[r, i] = h + (i << 40)
    ints = np.sign(ints) * np.log1p(np.abs(ints))
    return labels, ints, cats


def criteo_file_batches(path: str, batch_size: int,
                        hash_mod: Optional[int] = None,
                        use_native: bool = True,
                        as_numpy: bool = False,
                        wide: bool = True,
                        id_bits: Optional[int] = None,
                        device="cuda") -> Iterator[Dict]:
    """Stream batches from a Kaggle-format TSV file; the last batch may
    be short.

    ``use_native`` (which ``hash_mod`` must leave unset) parses with the
    port's C++ parser (``native.parse_criteo``); a failed build raises.
    ``use_native=False`` runs :func:`parse_criteo_lines`. ``as_numpy``
    keeps batches as raw numpy (``batch_np_dict``) for
    ``EmbeddingGroup.pack_batch_np``; otherwise sparse columns become
    ``SparseIds`` on ``device``. ``id_bits`` keeps the low ``id_bits``
    bits of each id, which also drops the per-field offsets: with 31,
    every id fits in int32 and ``pack_batch_np(compact=True)`` ships
    half-width id planes.
    """
    def mk(labels, dense, cats):
        if id_bits is not None:
            cats = np.asarray(cats) & np.int64((1 << id_bits) - 1)
        batch = batch_np_dict(labels, dense, cats, wide=wide)
        return batch if as_numpy else _with_sparse_ids(batch, device)

    if use_native:
        if hash_mod is not None:
            raise ValueError("the native parser takes no hash_mod; pass "
                             "use_native=False")
        from deeprec_tpu_torch import native
        tail = b""
        with open(path, "rb") as f:
            while True:
                chunk = f.read(1 << 22)
                if not chunk:
                    break
                data = tail + chunk
                off = 0
                while True:
                    rows, labels, dense, cats, consumed = \
                        native.parse_criteo(data[off:], batch_size)
                    if rows < batch_size:
                        break
                    yield mk(labels, dense, cats)
                    off += consumed
                tail = data[off:]
        if tail:
            rows, labels, dense, cats, _ = native.parse_criteo(
                tail if tail.endswith(b"\n") else tail + b"\n", batch_size)
            if rows:
                yield mk(labels[:rows], dense[:rows], cats[:rows])
        return
    buf = []
    with open(path) as f:
        for line in f:
            buf.append(line)
            if len(buf) == batch_size:
                yield mk(*parse_criteo_lines(buf, hash_mod))
                buf = []
    if buf:
        yield mk(*parse_criteo_lines(buf, hash_mod))


class SyntheticCriteo:
    """Deterministic synthetic stream with interaction-structured
    labels: Zipf ids per field, labels from a hidden logit with linear,
    FM, dense-cross and quadratic parts (see the JAX module)."""

    def __init__(self, batch_size: int, vocab=10000,
                 seed: int = 0, zipf_a: float = 1.2,
                 w_linear: float = 0.8, w_fm: float = 1.5,
                 w_cross: float = 0.8, w_quad: float = 0.5,
                 fm_dim: int = 4, n_buckets: int = 2048):
        self.batch_size = batch_size
        if np.isscalar(vocab):
            self.vocab = np.full(NUM_CAT, int(vocab), np.int64)
        else:
            self.vocab = np.asarray(list(vocab), np.int64)
            if self.vocab.shape != (NUM_CAT,):
                raise ValueError(f"vocab needs {NUM_CAT} entries")
        self.rng = np.random.default_rng(seed)
        self.zipf_a = zipf_a
        w_rng = np.random.default_rng(seed + 1)
        nb = n_buckets
        self._nb = nb
        self._w_cat = w_rng.normal(0, 1.0, size=(NUM_CAT, nb))
        self._w_int = w_rng.normal(0, 1.0, size=(NUM_INT,))
        self._V = w_rng.normal(0, 1.0, size=(NUM_CAT, nb, fm_dim))
        pairs = [(f, (f * 7 + 3) % NUM_CAT) for f in range(NUM_CAT)]
        self._pairs = [(a, b) for a, b in pairs if a != b][:16]
        self._u = w_rng.normal(0, 1.0, size=(4, NUM_INT))
        self._s = w_rng.normal(0, 1.0, size=(4, nb))
        self._cross_fields = [1, 5, 9, 16]
        self.w_linear, self.w_fm = w_linear, w_fm
        self.w_cross, self.w_quad = w_cross, w_quad
        self._norm = None

    def _draw(self, B):
        ints = self.rng.normal(0, 1, size=(B, NUM_INT)).astype(np.float32)
        z = self.rng.zipf(self.zipf_a, size=(B, NUM_CAT))
        cats = (z % self.vocab[None, :]).astype(np.int64)
        return ints, cats

    def _logit_parts(self, ints, cats):
        b = (cats % self._nb)
        lin = ints @ self._w_int / np.sqrt(NUM_INT)
        lin = lin + np.take_along_axis(
            self._w_cat.T, b, axis=0).sum(1) / np.sqrt(NUM_CAT)
        fm = np.zeros(ints.shape[0])
        for f, g in self._pairs:
            fm += (self._V[f, b[:, f]] * self._V[g, b[:, g]]).sum(1)
        cross = np.zeros(ints.shape[0])
        for k, f in enumerate(self._cross_fields):
            cross += (ints @ self._u[k]) * self._s[k, b[:, f]]
        quad = (ints[:, :6] * ints[:, 6:12]).sum(1)
        return np.stack([lin, fm, cross, quad], 0)

    def logits(self, ints, cats) -> np.ndarray:
        """Ground-truth logit (Bayes-optimal score) for given features."""
        parts = self._logit_parts(ints, cats)
        if self._norm is None:
            # Normalization fixed at first use, from a probe draw.
            probe = self._logit_parts(*SyntheticCriteo._draw(self, 8192)) \
                if ints.shape[0] < 8192 else parts
            self._norm = probe.std(1) + 1e-6
        w = np.array([self.w_linear, self.w_fm, self.w_cross, self.w_quad])
        return (w[:, None] * parts / self._norm[:, None]).sum(0)

    def next_batch_np(self, wide: bool = True) -> Dict:
        """The next batch as raw numpy (``batch_np_dict`` layout)."""
        B = self.batch_size
        ints, cats = self._draw(B)
        logit = self.logits(ints, cats)
        p = 1.0 / (1.0 + np.exp(-logit))
        labels = (self.rng.random(B) < p).astype(np.float32)
        # Distinct per-field offsets keep id spaces disjoint.
        cats = cats + np.arange(NUM_CAT, dtype=np.int64)[None, :] * (1 << 40)
        return batch_np_dict(labels, ints, cats, wide=wide)

    def next_batch(self, device="cuda") -> Dict:
        """The next batch with ``SparseIds`` on ``device`` per sparse
        column, the JAX package's ``next_batch`` layout."""
        return _with_sparse_ids(self.next_batch_np(), device)

    def __iter__(self) -> Iterator[Dict]:
        while True:
            yield self.next_batch()
