"""Port parity: ``ParquetDataset`` (``deeprec_tpu_torch/data/parquet.py``).

Batches equal to the JAX package's ``ParquetDataset``'s, leaf by leaf
(float32 arrays equal; ``SparseIds`` hi and lo planes equal), for every
``Field`` kind (``label``, ``numeric``, ``id`` with a key offset,
``id_str`` with nulls through the port's ``native.hash_bytes``,
``id_list`` padded and clipped at ``max_len``), for batches carried
across files and row groups, and with and without ``drop_remainder``.
The pyarrow gate: with pyarrow hidden the module loads and the
constructor raises ``ImportError``, as the reference's does.
"""

import importlib.util
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from deeprec_tpu.data import parquet as jparquet
from deeprec_tpu_torch.data import parquet as tparquet
from deeprec_tpu_torch.feature_column.feature_column import SparseIds
from deeprec_tpu_torch.utils import keys as keylib

torch.set_num_threads(1)

FIELDS = [("label", "label", {}), ("price", "numeric", {}),
          ("item", "id", {"key_offset": 100}),
          ("user", "id_str", {"key_offset": 7}),
          ("hist", "id_list", {"max_len": 3, "key_offset": 1 << 40})]


def _fields(mod, kinds=None):
    return [mod.Field(n, k, **kw) for n, k, kw in FIELDS
            if kinds is None or k in kinds]


def _table(rng, n: int, start: int = 0):
    return pa.table({
        "label": rng.integers(0, 2, n).astype(np.float64),
        "price": rng.normal(size=n),
        "item": rng.integers(-2**40, 2**40, n),
        "user": [None if i % 7 == 3 else f"user-{start + i}-é"
                 for i in range(n)],
        "hist": [rng.integers(0, 1000, int(k)).tolist() or None
                 for k in rng.integers(0, 6, n)],
    })


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, wv in w.items():
            gv = g[k]
            if isinstance(gv, SparseIds):
                np.testing.assert_array_equal(gv.hi.numpy(),
                                              np.asarray(wv.hi), err_msg=k)
                np.testing.assert_array_equal(gv.lo.numpy(),
                                              np.asarray(wv.lo), err_msg=k)
                assert gv.hi.dtype == torch.int32
            else:
                assert gv.dtype == np.float32 == wv.dtype
                np.testing.assert_array_equal(gv, wv, err_msg=k)


def _both(paths, kinds=None, **kw):
    got = list(tparquet.ParquetDataset(paths, _fields(tparquet, kinds),
                                       device="cpu", **kw))
    want = list(jparquet.ParquetDataset(paths, _fields(jparquet, kinds),
                                        **kw))
    _same_batches(got, want)
    return got


@pytest.mark.parametrize("kind", [k for _, k, _ in FIELDS])
def test_each_field_kind_equals_jax(tmp_path, kind):
    p = str(tmp_path / "d.parquet")
    pq.write_table(_table(np.random.default_rng(0), 40), p)
    got = _both(p, kinds={kind}, batch_size=16)
    assert len(got) == 2


def test_field_values(tmp_path):
    p = str(tmp_path / "d.parquet")
    pq.write_table(pa.table({"item": [10, 20], "user": ["a", None],
                             "hist": [[1, 2, 3, 4], []]}), p)
    (b,) = tparquet.ParquetDataset(p, [
        tparquet.Field("item", "id", key_offset=100),
        tparquet.Field("user", "id_str"),
        tparquet.Field("hist", "id_list", max_len=3)], 2, device="cpu")

    def ids(s):
        return keylib.join_ids(s.hi.numpy(), s.lo.numpy())

    np.testing.assert_array_equal(ids(b["item"]), [[110], [120]])
    from deeprec_tpu_torch import native
    np.testing.assert_array_equal(ids(b["user"])[:, 0],
                                  native.hash_bytes(["a", ""]))
    np.testing.assert_array_equal(ids(b["hist"]),
                                  [[1, 2, 3], [keylib.EMPTY_ID] * 3])


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_carry_across_files_and_row_groups(tmp_path, drop_remainder):
    rng = np.random.default_rng(1)
    paths = []
    for i, (n, rg) in enumerate(((7, 3), (4, 2), (13, 5))):
        paths.append(str(tmp_path / f"{i}.parquet"))
        pq.write_table(_table(rng, n, start=100 * i), paths[-1],
                       row_group_size=rg)
    got = _both(paths, batch_size=5, drop_remainder=drop_remainder)
    sizes = [len(b["label"]) for b in got]
    assert sizes == ([5] * 4 if drop_remainder else [5] * 4 + [4])


def test_pyarrow_gate(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    spec = importlib.util.spec_from_file_location("_parquet_gated",
                                                  tparquet.__file__)
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "_parquet_gated", mod)
    spec.loader.exec_module(mod)
    assert not mod.HAVE_PYARROW and tparquet.HAVE_PYARROW
    with pytest.raises(ImportError, match="pyarrow"):
        mod.ParquetDataset("d.parquet", [mod.Field("x")], 4, device="cpu")
