"""Tensible (growable) embedding tables and admission strategies.

Port of ``deeprec_tpu/embedding/tensible.py`` (the reference's
``core/framework/hash_table/`` ``TensibleVariable`` with its admit
strategies and black list): an EV table whose capacity doubles on the
host when its live keys cross ``growth_threshold`` of it. Growth builds
a table of twice the capacity and re-scatters the rows and the
optimizer's row-aligned slots into it through the checkpoint's
export/import path, which re-inserts every key with P1; between
growths the table is an ordinary EV table, with no indirection.

Admission strategies:
  * ``AdmitEverything``: every real id is inserted;
  * ``BloomAdmit``: an id is inserted once its counting-Bloom count
    reaches ``filter_freq`` (the EV's CBF filter);
  * ``ReadOnlyAdmit``: nothing is inserted, nothing is updated.

``BlackList``: ids on the list are never inserted and read the default
row; the list is a hash table of its own, probed with P1's find.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from deeprec_tpu_torch import config as cfglib
from deeprec_tpu_torch.embedding import hash_table as ht
from deeprec_tpu_torch.embedding import variable as ev
from deeprec_tpu_torch.utils import keys as keylib


@dataclasses.dataclass(frozen=True)
class AdmitEverything:
    pass


@dataclasses.dataclass(frozen=True)
class ReadOnlyAdmit:
    """No id is ever inserted (a frozen or serving table)."""


@dataclasses.dataclass(frozen=True)
class BloomAdmit:
    """Admit an id once its counting-Bloom count reaches
    ``filter_freq``."""

    filter_freq: int = 1
    num_hash_func: int = 3
    num_counters: int = 1 << 16

    def to_filter(self) -> cfglib.CBFFilter:
        return cfglib.CBFFilter(filter_freq=self.filter_freq,
                                num_hash_func=self.num_hash_func,
                                num_counters=self.num_counters)


class BlackList:
    """A set of banned int64 ids on ``device``, held in a hash table of
    the smallest power-of-two capacity of at least twice their count
    (8 at least)."""

    def __init__(self, ids: np.ndarray, device="cuda"):
        ids = np.unique(np.asarray(ids, np.int64))
        ids = ids[~np.isin(ids, (keylib.EMPTY_ID, keylib.TOMB_ID))]
        self.size = int(ids.shape[0])
        cap = 8
        while cap < 2 * max(self.size, 1):
            cap <<= 1
        self._capacity = cap
        self._table = ht.create(cap, device)
        if self.size:
            hi, lo = keylib.split_ids(ids)
            _, slots, _ = ht.find_or_insert(
                self._table, torch.from_numpy(hi).to(device),
                torch.from_numpy(lo).to(device),
                torch.ones(self.size, dtype=torch.bool, device=device),
                max_probes=cap)
            if int(slots.max()) >= cap:
                raise RuntimeError("blacklist build overflow")

    def contains(self, qhi, qlo):
        if self.size == 0:
            return torch.zeros(qhi.shape, dtype=torch.bool, device=qhi.device)
        return ht.find(self._table, qhi, qlo,
                       max_probes=self._capacity) < self._capacity


class TensibleEV:
    """An EV table and its optimizer slots, with capacity doubling on
    the host (:meth:`maybe_grow`, between steps), on ``device``:

        t = TensibleEV(cfg, opt, admit=BloomAdmit(2), device="cuda")
        lk = t.lookup_train(ids_hi, ids_lo, counts, step)
        ... gradients of lk.rows ...
        t.apply_gradients(lk, grad_rows, step)
        t.maybe_grow()
    """

    def __init__(self, cfg: cfglib.TableConfig, opt,
                 admit: Any = AdmitEverything(),
                 blacklist: Optional[BlackList] = None,
                 growth_threshold: float = 0.85,
                 max_capacity: int = 1 << 26, salt: int = 0,
                 device="cuda"):
        if isinstance(admit, BloomAdmit):
            cfg = dataclasses.replace(cfg, ev_option=dataclasses.replace(
                cfg.ev_option, filter_option=admit.to_filter()))
        self.cfg = cfg
        self.opt = opt
        self.admit = admit
        self.blacklist = blacklist
        self.growth_threshold = growth_threshold
        self.max_capacity = max_capacity
        self.salt = salt
        self.device = torch.device(device)
        self.state = ev.create(cfg, self.device, salt=salt)
        self.slots = opt.init(cfg, self.device)
        self.generation = 0  # bumps on every growth

    # -- step side ---------------------------------------------------------
    def lookup_train(self, qhi, qlo, counts, global_step: ev.Step):
        """Training lookup of deduplicated ids (``lookup.dedup``); a
        read-only table reads and changes nothing."""
        qhi, qlo = self._mask_blacklist(qhi, qlo)
        if isinstance(self.admit, ReadOnlyAdmit):
            none = torch.zeros(qhi.shape, dtype=torch.bool,
                               device=qhi.device)
            return ev.LookupResult(
                slots=ht.find(self.state.table, qhi, qlo,
                              max_probes=self.cfg.max_probes),
                rows=ev.lookup(self.cfg, self.state, qhi, qlo),
                admitted=none, is_new=none,
                prev_versions=torch.full(qhi.shape, -1, dtype=torch.int32,
                                         device=qhi.device),
                qhi=qhi, qlo=qlo)
        self.state, lk = ev.lookup_train(self.cfg, self.state, qhi, qlo,
                                         counts, global_step, salt=self.salt)
        return lk

    def lookup(self, qhi, qlo):
        qhi, qlo = self._mask_blacklist(qhi, qlo)
        return ev.lookup(self.cfg, self.state, qhi, qlo)

    def apply_gradients(self, lk, grad_rows, global_step: ev.Step, lr=None):
        if isinstance(self.admit, ReadOnlyAdmit):
            return
        self.slots, _ = self.opt.apply(self.cfg, self.slots,
                                       self.state.values, lk, grad_rows,
                                       global_step, lr=lr)

    def _mask_blacklist(self, qhi, qlo):
        """Banned ids become the EMPTY id: they read defaults and are
        never inserted or updated."""
        if self.blacklist is None or self.blacklist.size == 0:
            return qhi, qlo
        banned = self.blacklist.contains(qhi, qlo)
        return (torch.where(banned, keylib.EMPTY_HI, qhi),
                torch.where(banned, keylib.EMPTY_LO, qlo))

    # -- host side ---------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.cfg.capacity

    def live(self) -> int:
        return int(ht.num_live(self.state.table))

    def maybe_grow(self) -> bool:
        """Double the capacity when the live keys reach
        ``growth_threshold`` of it (and the double fits
        ``max_capacity``); returns whether the table grew. Reads the
        card."""
        if self.live() < self.growth_threshold * self.capacity:
            return False
        if self.capacity * 2 > self.max_capacity:
            return False
        new_cfg = dataclasses.replace(self.cfg, capacity=self.capacity * 2)
        new_state = ev.create(new_cfg, self.device, salt=self.salt)
        new_slots = self.opt.init(new_cfg, self.device)
        arrays = ev.export_arrays(self.cfg, self.state)
        live = ht.live_mask(self.state.table)
        rows = {name: arr for name, arr in self.slots.items()
                if arr.dim() >= 1 and arr.shape[0] == self.capacity + 1}
        for name, arr in rows.items():
            arrays[f"slot/{name}"] = arr[:-1][live].cpu().numpy()
        new_state, restored = ev.import_arrays(
            new_cfg, new_state, arrays,
            extra_targets={name: new_slots[name] for name in rows})
        new_slots.update(restored)
        # Slots that are not row-aligned (Adam's beta powers) carry over.
        for name, arr in self.slots.items():
            if name not in rows:
                new_slots[name] = arr
        self.cfg, self.state, self.slots = new_cfg, new_state, new_slots
        self.generation += 1
        return True
