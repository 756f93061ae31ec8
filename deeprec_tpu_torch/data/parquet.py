"""ParquetDataset: columnar streaming batch reader.

Port of ``deeprec_tpu/data/parquet.py`` (the reference's arrow-based
ParquetDataset, ``core/kernels/data/parquet_dataset_ops.cc``,
``docs/ParquetDataset.md``): selected-column reads (IO proportional to
the fields used), row-group streaming (memory bounded by one row group,
not the file), batches carried across file boundaries, and a field spec
mapping columns to the batch dict (float32 arrays and ``SparseIds`` on
``device``).

Needs pyarrow, gated as the reference gates it: without it the
constructor raises ``ImportError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Sequence

import numpy as np

from deeprec_tpu_torch import native
from deeprec_tpu_torch.feature_column.feature_column import SparseIds
from deeprec_tpu_torch.utils import keys as keylib

try:  # environment probe
    import pyarrow as pa
    import pyarrow.parquet as pq

    HAVE_PYARROW = True
except ImportError:
    pa = pq = None
    HAVE_PYARROW = False


@dataclasses.dataclass(frozen=True)
class Field:
    """How one parquet column lands in the batch dict.

    kind: 'numeric' (float32), 'id' (int64 -> SparseIds [B, 1]),
    'id_str' (string -> ``native.hash_bytes`` -> SparseIds [B, 1]; a
    null hashes as ""), 'id_list' (list<int64> -> SparseIds [B, max_len]
    padded with the empty id), 'label' (float32).
    """

    name: str
    kind: str = "numeric"
    max_len: int = 1
    key_offset: int = 0  # added to ids (per-field key-space separation)


class ParquetDataset:
    """Iterate parquet file(s) as batches of ``batch_size`` rows.

    Streaming: one row group at a time (``ParquetFile.iter_batches``),
    partial batches carried across files, so memory is bounded by
    ``max(row_group_size, batch_size)`` whatever the dataset's size (the
    reference's ``parquet_batch_reader.cc``). With ``drop_remainder``
    False the short last batch is yielded too. ``SparseIds`` leaves go
    to ``device``.
    """

    def __init__(self, paths, fields: Sequence[Field], batch_size: int,
                 drop_remainder: bool = True, device="cuda"):
        if not HAVE_PYARROW:
            raise ImportError(
                "ParquetDataset requires pyarrow, which is not available "
                "in this environment")
        self.paths = [paths] if isinstance(paths, str) else list(paths)
        self.fields = list(fields)
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder
        self.device = device

    def _one_batch(self, table) -> Dict:
        """Convert exactly one batch's rows."""
        batch: Dict = {}
        n = table.num_rows
        for f in self.fields:
            arr = table.column(f.name)
            if f.kind in ("numeric", "label"):
                batch[f.name] = np.asarray(
                    arr.to_numpy(zero_copy_only=False), np.float32)
                continue
            if f.kind == "id":
                ids = np.asarray(arr.to_numpy(zero_copy_only=False),
                                 np.int64)[:, None] + f.key_offset
            elif f.kind == "id_str":
                toks = ["" if v is None else str(v) for v in arr.to_pylist()]
                ids = native.hash_bytes(toks)[:, None] + f.key_offset
            elif f.kind == "id_list":
                ids = np.full((n, f.max_len), keylib.EMPTY_ID, np.int64)
                for r, row in enumerate(arr.to_pylist()):
                    row = (row or [])[:f.max_len]
                    if row:
                        ids[r, :len(row)] = np.asarray(
                            row, np.int64) + f.key_offset
            else:
                raise ValueError(f"unknown field kind {f.kind!r}")
            batch[f.name] = SparseIds.from_numpy(ids, self.device)
        return batch

    def __iter__(self) -> Iterator[Dict]:
        columns = [f.name for f in self.fields]
        B = self.batch_size
        bufs, buffered = [], 0
        for path in self.paths:
            pf = pq.ParquetFile(path)
            for rb in pf.iter_batches(batch_size=B, columns=columns):
                bufs.append(pa.Table.from_batches([rb]))
                buffered += rb.num_rows
                while buffered >= B:
                    table = pa.concat_tables(bufs)
                    yield self._one_batch(table.slice(0, B))
                    tail = table.slice(B)
                    bufs, buffered = [tail], tail.num_rows
        if buffered and not self.drop_remainder:
            table = pa.concat_tables(bufs)
            for start in range(0, buffered, B):
                yield self._one_batch(
                    table.slice(start, min(B, buffered - start)))
