"""Carry weights and table state across from the JAX package.

Dense params of any zoo model: a flax params tree (nested dicts of
numpy arrays) maps to the port's state dict; a ``Dense`` kernel (2-D,
``[in, out]``) becomes ``weight [out, in]``, and every other leaf keeps
its name and layout: a ``DenseGeneral`` kernel (3-D: attention's
``query``/``key``/``value`` ``[D, H, Dh]``, ``out`` ``[H, Dh, D]``),
biases, LayerNorm's ``scale``, the GRUs' bare matrices (used as
``x @ w`` on both sides) and ``pos_emb``. Table state: every ``EVState``
field is copied as it is, so the port probes the same slots and reads
the same rows.
Optimizer state: the sparse optimizers' slot trees are the same dicts
of arrays on both sides, optax's Adagrad state
``(ScaleByRssState(sum_of_squares=tree), EmptyState())`` maps to the
port's ``{"sum_of_squares": state dict}`` and its Adam state
``(ScaleByAdamState(count, mu, nu), EmptyState())`` to ``{"count",
"mu", "nu"}``. A table's ``bloom`` (a CBF table's full counter array)
crosses as it is, like every other field. Everything crosses as
numpy.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from deeprec_tpu_torch.embedding import hash_table as ht
from deeprec_tpu_torch.embedding.variable import EVState

EV_FIELDS = ("key_rows", "values", "freqs", "versions", "default_bank",
             "bloom")


def params_from_numpy(tree) -> Dict[str, torch.Tensor]:
    """Flax params tree of any zoo model -> state dict
    (``deep/dense_0/kernel`` -> ``deep.dense_0.weight``, transposed; a
    3-D ``kernel`` and every other leaf as they are)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix, node):
        for k, v in node.items():
            if hasattr(v, "items"):
                walk(prefix + [k], v)
            elif k == "kernel" and np.ndim(v) == 2:
                out[".".join(prefix + ["weight"])] = torch.from_numpy(
                    np.array(np.asarray(v).T, order="C"))
            else:
                out[".".join(prefix + [k])] = torch.from_numpy(np.array(v))

    walk([], tree)
    return out


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`params_from_numpy`."""
    tree: Dict[str, Any] = {}
    for name, t in params.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        arr = t.detach().cpu().numpy()
        if leaf == "weight":
            node["kernel"] = np.ascontiguousarray(arr.T)
        else:
            node[leaf] = arr
    return tree


# The names of the WDL-only port, kept for their callers.
wdl_params_from_numpy = params_from_numpy
wdl_params_to_numpy = params_to_numpy


def ev_state_from_numpy(d: Dict[str, np.ndarray], device) -> EVState:
    """EVState from numpy arrays named as :data:`EV_FIELDS` (``key_rows``
    is the hash table's ``[C/64, 128]`` int32 array)."""
    t = {k: torch.from_numpy(np.array(d[k])).to(device) for k in EV_FIELDS}
    return EVState(table=ht.HashTable(key_rows=t["key_rows"]),
                   values=t["values"], freqs=t["freqs"],
                   versions=t["versions"], default_bank=t["default_bank"],
                   bloom=t["bloom"])


def ev_state_to_numpy(state: EVState) -> Dict[str, np.ndarray]:
    return {
        "key_rows": state.table.key_rows.cpu().numpy(),
        "values": state.values.cpu().numpy(),
        "freqs": state.freqs.cpu().numpy(),
        "versions": state.versions.cpu().numpy(),
        "default_bank": state.default_bank.cpu().numpy(),
        "bloom": state.bloom.cpu().numpy(),
    }


def slots_from_numpy(slots: Dict[str, Dict[str, Any]],
                     device) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{table: {name: array}}`` (``TrainState.slots`` of the JAX
    package, as numpy) -> the port's, on ``device``."""
    return {t: {k: torch.from_numpy(np.array(v)).to(device)
                for k, v in sl.items()} for t, sl in slots.items()}


def slots_to_numpy(slots) -> Dict[str, Dict[str, np.ndarray]]:
    """Inverse of :func:`slots_from_numpy`."""
    return {t: {k: v.cpu().numpy() for k, v in sl.items()}
            for t, sl in slots.items()}


def dense_opt_from_numpy(opt_state) -> Dict[str, Any]:
    """optax Adagrad or Adam state with numpy leaves
    (``jax.tree.map(np.asarray, ts.dense_opt)``) -> the port's
    ``Adagrad`` or ``Adam`` state."""
    st = opt_state[0]
    if hasattr(st, "sum_of_squares"):
        return {"sum_of_squares": params_from_numpy(st.sum_of_squares)}
    return {"count": torch.from_numpy(np.array(st.count, np.int32)),
            "mu": params_from_numpy(st.mu),
            "nu": params_from_numpy(st.nu)}


def dense_opt_to_numpy(dense_opt) -> Dict[str, Any]:
    """The port's ``Adagrad`` state -> the flax-layout tree of optax's
    ``sum_of_squares``, which the JAX side wraps as
    ``(optax.ScaleByRssState(sum_of_squares=tree), optax.EmptyState())``;
    its ``Adam`` state -> ``{"count", "mu", "nu"}`` (trees for the
    moments), for ``(optax.ScaleByAdamState(**d), optax.EmptyState())``."""
    if "sum_of_squares" in dense_opt:
        return params_to_numpy(dense_opt["sum_of_squares"])
    return {"count": dense_opt["count"].cpu().numpy(),
            "mu": params_to_numpy(dense_opt["mu"]),
            "nu": params_to_numpy(dense_opt["nu"])}
