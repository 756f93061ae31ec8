"""Model entry for the serving worker: the headline WDL model.

``build(config)`` follows ``serving/worker.py``'s contract. It builds
the configuration ``bench.py`` times as its headline row, served rather
than trained: reference-shape Criteo columns with the wide weight in
channel 0 of each deep table, EV tables that record no freq or version,
coalesced into two physical tables, and 1024/512/256 towers in bfloat16
over float32 params. Config keys (defaults in parentheses):
``reference_shapes`` (False), ``dim`` (16; per-column dim when not
reference-shaped), ``capacity`` (``1 << 20``; per-column ceiling),
``hidden`` ([1024, 512, 256]), ``dtype`` ("bfloat16" or "float32"),
``device`` ("cuda"), ``num_shards`` (None; a number: the group of a
mesh of that many ranks, every table row-sharded, for
``ServingModel(mesh=)``), ``report_launches`` (False; True adds the
process's K1 and P1 ``find`` launch counts to every response, as
``"launches"``). The template's towers are seeded with 0 and replaced
by the checkpoint's on restore.

Requests: ``{"instances": [{"I1": x, ..., "I13": x, "C1": id, ...,
"C26": id}, ...]}`` with float numerics and int64 ids.
"""

from __future__ import annotations

import numpy as np
import torch

from deeprec_tpu_torch import config as cfglib
from deeprec_tpu_torch.feature_column.feature_column import EmbeddingGroup
from deeprec_tpu_torch.layers.core import init_dense
from deeprec_tpu_torch.models import wdl
from deeprec_tpu_torch.train import loop as trainlib

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build(config: dict) -> dict:
    device = torch.device(config.get("device", "cuda"))
    evo = cfglib.EmbeddingVariableOption(record_freq=False,
                                         record_version=False)
    cols = wdl.criteo_columns(
        embedding_dim=int(config.get("dim", 16)),
        capacity=int(config.get("capacity", 1 << 20)),
        reference_shapes=bool(config.get("reference_shapes", False)),
        wide_in_deep=True, ev_option=evo)
    shards = config.get("num_shards")
    group = EmbeddingGroup(cols, coalesce=True, **(
        {} if shards is None else dict(axis_name="data",
                                       num_shards=int(shards))))
    model = wdl.WDL(wdl.input_width(group),
                    hidden=tuple(config.get("hidden", (1024, 512, 256))),
                    dtype=_DTYPES[config.get("dtype", "bfloat16")],
                    device=device)
    init_dense(model, torch.Generator().manual_seed(0))
    ts = trainlib.create_train_state(group, model.state_dict(),
                                       device=device)

    def parse_request(req: dict) -> dict:
        inst = req["instances"]
        if not inst:
            raise ValueError("no instances")
        batch = {f"I{i}": np.asarray([float(r[f"I{i}"]) for r in inst],
                                     np.float32)
                 for i in range(1, wdl.NUM_INT + 1)}
        for i in range(1, wdl.NUM_CAT + 1):
            batch[f"C{i}"] = np.asarray([[int(r[f"C{i}"])] for r in inst],
                                        np.int64)
        return group.pack_batch_np(batch, device)

    parts = {"group": group, "apply_fn": wdl.apply_fn(model, group),
             "ts_template": ts, "parse_request": parse_request}
    if config.get("report_launches"):
        parts["format_response"] = _with_launches
    return parts


def _with_launches(out: torch.Tensor) -> dict:
    from deeprec_tpu_torch.ops.kernels import gather, hash_probe
    from deeprec_tpu_torch.serving.processor import sigmoid_scores
    return {"predictions": sigmoid_scores(out).tolist(),
            "launches": {"gather_rows": gather.launches,
                         "hash_probe_find": hash_probe.launches["find"]}}
