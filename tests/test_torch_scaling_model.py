"""Port: ``tools/scaling_model_torch.py``'s exchange byte model.

* At S = 2, on the graft WDL of ``tests/torch_mesh_cases.py`` (its deep
  table row-sharded, its wide table replicated; 32 rows a rank), the
  model's bytes a rank and step equal what the gloo ranks'
  ``Mesh.trace`` records for one training step, kind by kind: the
  all-to-alls (the deep table's ids once, its rows and their gradient),
  the all-gather (the wide table's ids) and the all-reduces (the dense
  gradients with the wide table's union-row gradients, then the loss and
  ``n_overflow``).
* At S = 1 on the ``bench.py`` headline's shapes the model gives
  587,464,704 bytes of all-to-all, the bytes the card's trace recorded
  (arithmetic only: no table is built). The port sends each id once
  (``[S*K, 3]`` int32); ``tools/scaling_model.py`` counts the JAX
  package's ids both ways, so the two tools differ by that plane.
* The modelled fields (link time, efficiency, samples/s) carry
  ``modelled_`` in their names, and the row states the assumed link.
"""

import os
import sys

import numpy as np
import pytest
import torch

import torch_mesh_cases as mc

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import scaling_model_torch as sm  # noqa: E402

torch.set_num_threads(1)

WORLD = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scaling")
    mc.launch("step_trace", WORLD, tmp, warm=1)
    return [mc.result("step_trace", tmp, r) for r in range(WORLD)]


def test_model_equals_gloo_trace_at_s2(ranks):
    group, model, *_ = mc.wdl_parts(WORLD)
    tables = sm.tables_of(group, mc.B_GLOBAL // WORLD)
    assert sorted(t["placement"] for t in tables) == ["replicated",
                                                      "sharded"]
    want = sm.step_bytes(tables, WORLD, sm.dense_bytes(model.state_dict()))
    for res in ranks:
        assert dict(res["placement"].tolist()) == {
            t["name"]: t["placement"] for t in tables}
        for kind in ("all_to_all", "all_gather", "all_reduce"):
            assert int(res[f"bytes/{kind}"]) == want[kind], kind
        # ids, rows forward and their gradient back; one gather; the
        # dense (with the replicated rows) and the loss all-reduces.
        assert int(res["calls/all_to_all"]) == 3
        assert int(res["calls/all_gather"]) == 1
        assert int(res["calls/all_reduce"]) == 2


def test_headline_bytes_at_s1():
    b = sm.model(1)["bytes_per_rank_step"]
    ids = 262_144 * 12 + 589_824 * 12
    rows = 2 * (262_144 * 129 + 589_824 * 65) * 4
    assert (b["ids"], b["rows"]) == (ids, rows)
    assert b["all_to_all"] == 587_464_704 == ids + rows
    assert b["all_gather"] == 0
    # Every table sharded at S = 1: the all-reduces carry the towers'
    # float32 gradients (input 2,189 -> 1024 -> 512 -> 256 -> 1) and 16
    # bytes of loss and n_overflow.
    dims = [2189, 1024, 512, 256, 1]
    dense = sum(a * b + b for a, b in zip(dims, dims[1:])) * 4
    assert b["all_reduce"] == dense + 16
    tables = sm.wdl_tables(1)
    assert sorted((t["dim"], t["n"]) for t in tables) == [
        (65, 18 * 16384), (129, 8 * 16384)]
    # Weak scaling: K = ceil(2n/S) rounded to 8, so S*K stays ~2n and
    # the bytes a rank sends hardly move with S.
    for S in (2, 4, 8):
        assert sm.model(S)["bytes_per_rank_step"]["all_to_all"] == \
            b["all_to_all"]


def test_static_row_bytes():
    # The static row sends one int32 slot plane of K = per_peer(U + 1)
    # a peer: the 65-wide table's unique budget is U = 67,264 (its
    # columns' buckets, aligned to 64), the 129-wide table has none (U =
    # n = 131,072); K = 2(U + 1) rounded up to 8.
    tables = {t["dim"]: t for t in sm.wdl_tables(1, static=True)}
    assert (tables[65]["budget"], tables[129]["budget"]) == (67_264, None)
    b = sm.model(1, static=True)["bytes_per_rank_step"]
    k65, k129 = 134_536, 262_152
    assert b["ids"] == (k65 + k129) * 4
    assert b["rows"] == 2 * (k65 * 65 + k129 * 129) * 4


def test_modelled_fields_name_the_assumed_link():
    """The fields that follow from the assumed link rate carry
    ``modelled_`` and the row states the assumption: at S = 2, 10 ms of
    compute and 100 GB/s, half the all-to-all and all-gather bytes and
    2(S-1)/S of the all-reduce's leave the rank."""
    r = sm.model(2, t_compute_ms=10.0, link_gbps=100.0)
    b = r["bytes_per_rank_step"]
    off = (b["all_to_all"] + b["all_gather"]) / 2 + b["all_reduce"]
    assert r["offchip_bytes"] == int(off)
    t_link = off / 100e9 * 1e3
    assert r["modelled_t_link_ms"] == pytest.approx(t_link)
    assert r["modelled_weak_scaling_efficiency"] == pytest.approx(
        10.0 / (10.0 + t_link))
    assert r["modelled_samples_per_s"] == pytest.approx(
        2 * sm.BATCH_PER_RANK / ((10.0 + t_link) / 1e3))
    assert r["link_gbps_assumed"] == 100.0
    assert "100.0 GB/s" in r["assumption"]
    assert "assumed, not measured" in r["assumption"]
    assert not {"t_link_ms", "weak_scaling_efficiency",
                "samples_per_s"} & set(r)
