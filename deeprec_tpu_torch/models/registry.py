"""Model zoo registry, port of ``deeprec_tpu/models/registry.py``:
name -> (columns, module, apply, loss, data).

A torch module needs its input widths when it is built, so
``make_module`` takes the model's ``EmbeddingGroup``:
``make_module(group, **kw)``. ``make_data(seed=, batch_size=, ..)`` is
the model's synthetic stream; its ``next_batch_np()`` feeds
``EmbeddingGroup.pack_batch_np``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

from deeprec_tpu_torch.data.behavior import SyntheticBehavior
from deeprec_tpu_torch.data.criteo import SyntheticCriteo, SyntheticMultiTask
from deeprec_tpu_torch.models import (bst, deepfm, dien, din, dlrm, dssm,
                                      multitask, wdl)
from deeprec_tpu_torch.train.losses import bce_with_logits


class ZooEntry(NamedTuple):
    columns: Callable[..., list]
    make_module: Callable[..., Any]
    make_apply: Callable[[Any, Any], Callable]
    loss: Callable
    make_data: Callable[..., Any]


def _bce(out, batch):
    return bce_with_logits(out, batch["label"])


def _wdl(group, **kw):
    return wdl.WDL(wdl.input_width(group), **kw)


ZOO: Dict[str, ZooEntry] = {
    "wdl": ZooEntry(wdl.criteo_columns, _wdl, wdl.apply_fn, _bce,
                    SyntheticCriteo),
    "deepfm": ZooEntry(deepfm.criteo_columns, deepfm.make, deepfm.apply_fn,
                       _bce, SyntheticCriteo),
    "dlrm": ZooEntry(dlrm.criteo_columns, dlrm.make, dlrm.apply_fn, _bce,
                     SyntheticCriteo),
    "din": ZooEntry(din.behavior_columns, din.make, din.apply_fn, _bce,
                    SyntheticBehavior),
    "dien": ZooEntry(dien.behavior_columns, dien.make, dien.apply_fn,
                     dien.dien_loss, SyntheticBehavior),
    "bst": ZooEntry(bst.behavior_columns, bst.make, bst.apply_fn, _bce,
                    SyntheticBehavior),
    "dssm": ZooEntry(dssm.behavior_columns, dssm.make, dssm.apply_fn,
                     dssm.dssm_loss, SyntheticBehavior),
    "esmm": ZooEntry(multitask.criteo_columns, multitask.make_esmm,
                     multitask.apply_fn, multitask.esmm_loss,
                     SyntheticMultiTask),
    "mmoe": ZooEntry(multitask.criteo_columns, multitask.make_mmoe,
                     multitask.apply_fn, multitask.multitask_loss,
                     SyntheticMultiTask),
    "dbmtl": ZooEntry(multitask.criteo_columns, multitask.make_dbmtl,
                      multitask.apply_fn, multitask.multitask_loss,
                      SyntheticMultiTask),
    "simple_multitask": ZooEntry(
        multitask.criteo_columns, multitask.make_simple,
        multitask.apply_fn, multitask.multitask_loss, SyntheticMultiTask),
}

SEQUENCE_MODELS = ("din", "dien", "bst", "dssm")
