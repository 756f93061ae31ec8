"""Configuration objects for embedding variables.

Port of ``deeprec_tpu/config.py``: the same frozen dataclasses, with
``TableConfig.dtype`` a ``torch.dtype``. Only the options the ported
serving and training paths honour are carried. CBF counters are int32
(the JAX package's ``counter_dtype`` default).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch


class StorageType(enum.Enum):
    """Where a table's rows live: device memory only (``HBM``), or a
    device hot tier with a host-RAM spill tier (``HBM_HOST``) and a disk
    tier below it (``HBM_HOST_DISK``), which
    ``embedding.multi_tier.TieredGroup`` runs."""

    HBM = "hbm"
    HBM_HOST = "hbm_host"
    HBM_HOST_DISK = "hbm_host_disk"


@dataclasses.dataclass(frozen=True)
class CounterFilter:
    """Exact-count admission: a key reads the default value until it
    has been seen ``filter_freq`` times (the per-row ``freqs`` array is
    the counter)."""

    filter_freq: int = 0


@dataclasses.dataclass(frozen=True)
class CBFFilter:
    """Counting-Bloom-filter admission: ids are counted in a side table
    of ``num_counters`` int32 counters (``num_hash_func`` positions an
    id) and inserted into the main table only once their approximate
    count reaches ``filter_freq`` (``embedding.variable.lookup_train``)."""

    filter_freq: int = 0
    num_hash_func: int = 3
    num_counters: int = 1 << 20


@dataclasses.dataclass(frozen=True)
class GlobalStepEvict:
    """Evict keys untouched for more than ``steps_to_live`` global
    steps; applied by ``variable.shrink``, typically at checkpoint
    time."""

    steps_to_live: int = 0


@dataclasses.dataclass(frozen=True)
class L2WeightEvict:
    """Evict keys whose row's L2 norm is below ``l2_weight_threshold``;
    applied by ``variable.shrink``."""

    l2_weight_threshold: float = -1.0


@dataclasses.dataclass(frozen=True)
class StorageOption:
    """Storage tiers of one table."""

    storage_type: StorageType = StorageType.HBM
    # Max rows kept in HBM when a host spill tier is configured.
    hbm_capacity: Optional[int] = None
    # HBM_HOST_DISK: directory for the cold-tier value logs and max
    # rows kept in host RAM before paging down.
    storage_path: Optional[str] = None
    host_capacity: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class EmbeddingVariableOption:
    """Option bundle of one table (``tf.EmbeddingVariableOption``).

    ``default_value_dim``: number of default rows; an unseen key reads
    row ``key % default_value_dim``. ``record_freq`` /
    ``record_version``: whether per-step metadata is tracked (see
    ``embedding.variable._tracking``; an ``evict_option`` forces
    version tracking; a tiered ``storage_option`` forces both).
    """

    filter_option: Optional[CounterFilter | CBFFilter] = None
    evict_option: Optional[GlobalStepEvict | L2WeightEvict] = None
    storage_option: StorageOption = dataclasses.field(
        default_factory=StorageOption)
    default_value_dim: int = 1
    record_freq: bool = True
    record_version: bool = True


@dataclasses.dataclass(frozen=True)
class TableConfig:
    """Static configuration of one embedding table. ``capacity`` must
    be a power of two (the hash table masks rather than mods), except
    for a static hash-bucket table, where it is the bucket count."""

    name: str
    dim: int
    capacity: int
    initializer: str = "truncated_normal"
    init_scale: float = 1.0
    dtype: torch.dtype = torch.float32
    ev_option: EmbeddingVariableOption = dataclasses.field(
        default_factory=EmbeddingVariableOption)
    combiner: str = "mean"
    max_probes: int = 64
    # Dynamic-dimension EV: dim splits into ``block_num`` blocks; a key
    # reads ``1 + #(thresholds <= freq)`` of them, the rest are zero.
    block_num: int = 1
    dyn_dim_thresholds: tuple = ()
    # Adaptive embedding (``embedding/adaptive.py``): ids whose frequency
    # is below ``adaptive_hot_threshold`` read and train a shared static
    # hash-bucket table of ``adaptive_buckets`` rows (a dense param);
    # hot ids get their own EV rows, seeded from the static row they
    # trained in. None disables.
    adaptive_hot_threshold: Optional[int] = None
    adaptive_buckets: int = 0
    # Static hash-bucket table (``categorical_column_with_hash_bucket``
    # + ``embedding_column``, the reference's default column type): a
    # full [capacity, dim] matrix initialized at creation, addressed by
    # ``offset + id mod buckets`` from the group transform; no hash
    # table, admission, eviction or metadata.
    static_buckets: bool = False

    def __post_init__(self):
        if self.dim <= 0:
            raise ValueError(f"table {self.name}: dim must be positive")
        if self.static_buckets:
            if self.capacity < 1:
                raise ValueError(
                    f"table {self.name}: static bucket count must be "
                    "positive")
            if self.block_num > 1 or self.adaptive_hot_threshold:
                raise ValueError(
                    f"table {self.name}: static buckets cannot combine "
                    "with dynamic-dim or adaptive embedding")
            return
        if self.capacity < 1 or self.capacity & (self.capacity - 1):
            raise ValueError(
                f"table {self.name}: capacity {self.capacity} must be a "
                "power of two")
        if self.block_num > 1:
            if self.dim % self.block_num:
                raise ValueError(
                    f"table {self.name}: dim {self.dim} not divisible by "
                    f"block_num {self.block_num}")
            if len(self.dyn_dim_thresholds) != self.block_num - 1:
                raise ValueError(
                    f"table {self.name}: need {self.block_num - 1} "
                    "dyn_dim_thresholds")
        if self.adaptive_hot_threshold is not None:
            if self.adaptive_hot_threshold < 1:
                raise ValueError(
                    f"table {self.name}: adaptive_hot_threshold must "
                    "be >= 1")
            if self.adaptive_buckets < 2:
                raise ValueError(
                    f"table {self.name}: adaptive_buckets must be >= 2 "
                    "when adaptive_hot_threshold is set")


def steps_to_live_of(cfg: TableConfig) -> int:
    ev = cfg.ev_option.evict_option
    return ev.steps_to_live if isinstance(ev, GlobalStepEvict) else 0


def filter_freq_of(cfg: TableConfig) -> int:
    f = cfg.ev_option.filter_option
    return f.filter_freq if f is not None else 0
