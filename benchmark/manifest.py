"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The harness finds:

* the configuration's sizes in its ``file`` (``configs/<config>.json``),
  its builder on the port beside it (``configs/<config>.py``) and its
  plain reference (``reference/<config>.py``);
* the mix's parameters in ``traffic/<traffic>.json``;
* each metric's reader in ``metrics/<metric>.py`` (a ``read(ctx)`` that
  returns the number, or None where the run holds nothing to read);
* the limits of the cell's correctness check in ``limits/<workload>.json``.

So a configuration, a mix, a metric or a cell is added with new files
and a new entry, and no file that exists changes.

A configuration's module ``configs/<config>.py`` defines
``columns(cfg)`` (the port's columns, numeric and embedding),
``towers(cfg, group, device)`` (the port's tower module and its
``apply_fn``) and ``macs_per_sample(cfg)``, and its traffic in one of
two ways:

* ``stream(cfg, traffic, seed, device)``: an object with ``widths``
  (``{column: L_c}``, the ids a sample of each embedding column) and
  ``chunks(n)``, which yields the stream's next ``n`` samples drawn on
  ``device`` from ``seed`` (the same seed gives the same samples) in
  chunks ``(start, end, {"ids": {column: [m, L_c] int64 raw ids},
  "ints": [m, n_int] float32, "labels": [m] float32})``, ``start`` and
  ``end`` counted from the call's first sample. A bag or sequence with
  fewer than ``L_c`` ids is padded with the EMPTY id (the int64
  minimum), which is never a key;
* or, without ``stream``, ``vocab(cfg)``: the 26 columns' id-space
  sizes of the Criteo draw (``generator.ClickStream``), embedding column
  ``j`` taking one id a sample.

Its plain reference ``reference/<config>.py`` defines
``forward(params, embs, numeric, cfg)`` and ``columns(cfg)``: each
embedding column as ``(name, dim)`` (a bag of one id, its own table) or
as a dict with ``name``, ``dim`` and optionally ``table`` (the shared
table's name; the column's own by default), ``kind`` (``"bag"`` or
``"sequence"``) and a bag's ``combiner`` (``"sum"``, the default, or
``"mean"`` over its real ids). ``forward`` takes a bag as ``[B, dim]``
and a sequence as ``(rows [B, L, dim], zero at padding; mask [B, L])``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))


def load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    cfg: Dict
    cfg_mod: ModuleType
    ref_mod: ModuleType
    traffic: Dict
    metrics_e2e: List[Tuple[Dict, ModuleType]]
    metrics_layer: List[Tuple[Dict, ModuleType]]
    limits: Dict[str, float]


def manifest(root: str) -> Dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _applies(entry: Dict, cell: str, reported: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") is None or entry["moves"] in reported


def cell(root: str, name: str, bench_dir: str = HERE) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` with every file
    it names loaded from ``bench_dir``."""
    m = manifest(root)
    by_name = {w["name"]: w for w in m["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in m["configs"]}[w["config"]]
    cfg = _json(os.path.join(root, conf["file"]))

    def reader(entry):
        return entry, load_module(
            os.path.join(bench_dir, "metrics", entry["name"] + ".py"),
            "benchmark_metric_" + entry["name"].replace(".", "_"))

    e2e = [reader(e) for e in m["end_to_end"] if _applies(e, name, set())]
    reported = {e["name"] for e, _ in e2e}
    layer = [reader(e) for e in m["per_layer"] if _applies(e, name, reported)]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        traffic_name=w["traffic"], cfg=cfg,
        cfg_mod=load_module(os.path.join(bench_dir, "configs",
                                         w["config"] + ".py"),
                            "benchmark_config_" + w["config"]),
        ref_mod=load_module(os.path.join(bench_dir, "reference",
                                         w["config"] + ".py"),
                            "benchmark_reference_" + w["config"]),
        traffic=_json(os.path.join(bench_dir, "traffic",
                                   w["traffic"] + ".json")),
        metrics_e2e=e2e, metrics_layer=layer,
        limits=_json(os.path.join(bench_dir, "limits", name + ".json")))
