"""Dynamic-dimension EmbeddingVariable that stores fewer floats.

Port of ``deeprec_tpu/embedding/dyn_dim.py``
(``get_dynamic_dimension_embedding_variable``,
``docs/Dynamic-dimension-Embedding-Variable.md``). A key reads ``1 +
#(thresholds <= freq)`` of the table's ``block_num`` blocks; the masked
variant (``variable._dyn_dim_mask``) stores the full ``[C, dim]``
matrix, this one stores two tables:

  * ``base``: an EV of ``dim / block_num`` columns (block 0) at full
    capacity, one block for every admitted key;
  * ``hot``: an EV of the other ``dim - dim / block_num`` columns at a
    small capacity, whose rows a key gets only once its frequency
    crosses the first threshold (counting-Bloom admission, so cold keys
    never take a hot row).

Parameter floats: ``C * d0 + C_hot * (dim - d0)`` instead of ``C * dim``;
block_num 4 with ``C_hot = C / 16`` stores 0.30 of them. The hot
table's frequency starts when its row is allocated, so its own
thresholds are shifted by ``thresholds[0]``; with ``block_num > 2`` it is
itself a masked dynamic-dimension table. Locked blocks read zeros.

Gradients: :meth:`DynDimEV.lookup_train` returns both lookups;
:meth:`DynDimEV.apply_gradients` splits the row gradient by columns and
applies each table's part (K2 or K3 from the lookup's masked rows).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from deeprec_tpu_torch import config as cfglib
from deeprec_tpu_torch.embedding import variable as ev


@dataclasses.dataclass
class DynDimState:
    base: ev.EVState
    hot: ev.EVState


class DynDimLookup(NamedTuple):
    base: ev.LookupResult
    hot: ev.LookupResult
    rows: torch.Tensor  # [n, dim], block-masked


# The hot sibling's salt offset from the base's, as in the JAX package.
HOT_SALT = 101


def split_configs(cfg: cfglib.TableConfig, hot_capacity: int,
                  cbf_counters: int = 1 << 18, cbf_hash_funcs: int = 3
                  ) -> Tuple[cfglib.TableConfig, cfglib.TableConfig]:
    """(base_cfg, hot_cfg) of a ``block_num > 1`` table: the hot table
    is named ``<name>#hot`` and admits a key at ``thresholds[0]``."""
    if cfg.block_num <= 1:
        raise ValueError(f"table {cfg.name}: dyn_dim needs block_num>1")
    d0 = cfg.dim // cfg.block_num
    thr = cfg.dyn_dim_thresholds
    base = dataclasses.replace(cfg, dim=d0, block_num=1,
                               dyn_dim_thresholds=())
    hot_opt = dataclasses.replace(
        cfg.ev_option,
        filter_option=cfglib.CBFFilter(
            filter_freq=int(thr[0]), num_counters=cbf_counters,
            num_hash_func=cbf_hash_funcs))
    hot_blocks = cfg.block_num - 1
    hot = dataclasses.replace(
        cfg, name=cfg.name + "#hot", dim=cfg.dim - d0,
        capacity=hot_capacity, ev_option=hot_opt,
        block_num=hot_blocks if hot_blocks > 1 else 1,
        dyn_dim_thresholds=tuple(
            max(1, int(t) - int(thr[0])) for t in thr[1:]))
    return base, hot


class DynDimEV:
    """The two tables of one dynamic-dimension table, on ``device``."""

    def __init__(self, cfg: cfglib.TableConfig, hot_capacity: int,
                 cbf_counters: int = 1 << 18, cbf_hash_funcs: int = 3):
        self.cfg = cfg
        self.base_cfg, self.hot_cfg = split_configs(
            cfg, hot_capacity, cbf_counters, cbf_hash_funcs)

    def create(self, device, salt: int = 0) -> DynDimState:
        return DynDimState(
            base=ev.create(self.base_cfg, device, salt=salt),
            hot=ev.create(self.hot_cfg, device, salt=salt + HOT_SALT))

    def memory_rows(self) -> int:
        """Parameter floats stored (``capacity * dim`` for the masked
        variant)."""
        return (self.base_cfg.capacity * self.base_cfg.dim
                + self.hot_cfg.capacity * self.hot_cfg.dim)

    def lookup_train(self, state: DynDimState, qhi, qlo, counts,
                     global_step: ev.Step, salt: int = 0
                     ) -> Tuple[DynDimState, DynDimLookup]:
        """Both tables' training lookups of deduplicated ids (in place)."""
        base, blk = ev.lookup_train(self.base_cfg, state.base, qhi, qlo,
                                    counts, global_step, salt=salt)
        hot, hlk = ev.lookup_train(self.hot_cfg, state.hot, qhi, qlo, counts,
                                   global_step, salt=salt + HOT_SALT)
        return (DynDimState(base=base, hot=hot),
                DynDimLookup(base=blk, hot=hlk,
                             rows=torch.cat([blk.rows, hlk.rows], dim=1)))

    def lookup(self, state: DynDimState, qhi, qlo) -> torch.Tensor:
        return torch.cat([ev.lookup(self.base_cfg, state.base, qhi, qlo),
                          ev.lookup(self.hot_cfg, state.hot, qhi, qlo)],
                         dim=1)

    def init_optimizer(self, opt, device) -> Tuple[Any, Any]:
        return opt.init(self.base_cfg, device), opt.init(self.hot_cfg, device)

    def apply_gradients(self, opt, slots: Tuple[Any, Any], state: DynDimState,
                        lk: DynDimLookup, grad_rows, global_step: ev.Step,
                        lr=None) -> Tuple[Tuple[Any, Any], DynDimState]:
        """Each table's column part of ``grad_rows``, applied in place."""
        d0 = self.base_cfg.dim
        bslots, _ = opt.apply(self.base_cfg, slots[0], state.base.values,
                              lk.base, grad_rows[:, :d0].contiguous(),
                              global_step, lr=lr)
        hslots, _ = opt.apply(self.hot_cfg, slots[1], state.hot.values,
                              lk.hot, grad_rows[:, d0:].contiguous(),
                              global_step, lr=lr)
        return (bslots, hslots), state

    def shrink(self, state: DynDimState, global_step: int) -> DynDimState:
        return DynDimState(
            base=ev.shrink(self.base_cfg, state.base, global_step),
            hot=ev.shrink(self.hot_cfg, state.hot, global_step))

    def export_arrays(self, state: DynDimState):
        """The 4-tensor checkpoint of each table."""
        return {"base": ev.export_arrays(self.base_cfg, state.base),
                "hot": ev.export_arrays(self.hot_cfg, state.hot)}

    def import_arrays(self, state: DynDimState, arrays,
                      partition_id: int = 0, partition_num: int = 1
                      ) -> DynDimState:
        return DynDimState(
            base=ev.import_arrays(self.base_cfg, state.base, arrays["base"],
                                  partition_id, partition_num),
            hot=ev.import_arrays(self.hot_cfg, state.hot, arrays["hot"],
                                 partition_id, partition_num))
