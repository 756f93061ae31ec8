"""The port's measuring tools on the CPU at tiny sizes.

* ``tools/zoo_auc_torch.py``: one tiny model trains and scores into a
  row with ``ZOO_AUC.json``'s keys; the seed aggregation gives the JAX
  campaign's mean, spread and rounding (``ZOO_AUC.json``'s WDL row from
  its per-seed AUCs); a campaign writes the aggregated rows.
* ``tools/zoo_delta_torch.py`` and ``tools/write_bench_zoo_torch.py`` on
  fixture files.
* ``tools/model_benchmark_torch.py``: a tiny WDL's ``flops_per_step`` is
  its towers' GEMM count, ``2 B sum(in * out)`` three times (forward,
  and the backward's input and weight gradients).
* ``tools/serving_benchmark_torch.py``'s device rows, its ``c_abi``
  rows (``--abi-only``: the port's C ABI processor and worker) and
  ``tools/step_breakdown_torch.py``'s phases.
* ``tools/kernel_benchmark_torch.py``'s operands, and the bytes and
  bounds ``chip_smoke.py`` counts for them.
* ``tools/env_collect_torch.py --no-device`` touches no card.
* Without a card and without ``--cpu`` every tool fails.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import env_collect_torch  # noqa: E402
import kernel_benchmark_torch as kb  # noqa: E402
import model_benchmark_torch as mb  # noqa: E402
import serving_benchmark_torch as sb  # noqa: E402
import step_breakdown_torch as sbd  # noqa: E402
import write_bench_zoo_torch as wbz  # noqa: E402
import zoo_auc_torch as za  # noqa: E402
import zoo_delta_torch as zd  # noqa: E402

torch.set_num_threads(1)

ZOO_AUC_KEYS = {"metric", "mode", "backend", "steps", "batch", "seed",
                "train_s_incl_compile", "loss_epoch_means", "loss_drops",
                "auc"}


@pytest.fixture
def tiny_zoo(monkeypatch):
    """Shrink the campaign's DIN: 2**10 rows of width 4, narrow towers,
    sequences of 6."""
    monkeypatch.setitem(za.COLUMN_KWARGS, "din",
                        dict(embedding_dim=4, capacity=1 << 10))
    monkeypatch.setitem(za.MODULE_KWARGS, "din",
                        dict(hidden=(8, 4), att_hidden=(8, 4)))
    monkeypatch.setitem(za.SEQ_DATA, "seq_len", 6)


def test_zoo_auc_row_has_the_jax_keys(tiny_zoo):
    row = za.run("din", steps=4, batch=32, pool=2, items=300, cpu=True)
    assert ZOO_AUC_KEYS <= set(row)
    assert row["metric"] == "din_synthetic_accuracy"
    assert row["backend"] == "cpu" and row["mode"] == "bf16"
    assert row["steps"] == 4 and len(row["loss_epoch_means"]) == 2
    assert 0.0 < row["auc"] < 1.0


def test_seed_aggregation_is_the_jax_campaigns():
    """``ZOO_AUC.json``'s WDL row, rebuilt from its per-seed AUCs."""
    with open(os.path.join(REPO, "ZOO_AUC.json")) as f:
        want = next(r for r in json.load(f)["models"]
                    if r["metric"] == "wdl_synthetic_accuracy")
    per_seed = [dict(metric=want["metric"], mode="bf16", seed=s, auc=a,
                     loss_drops=True)
                for s, a in zip(want["seeds"], want["auc_seeds"])]
    row = za.aggregate(per_seed, want["seeds"])
    for k in ("auc", "auc_spread", "auc_seeds", "n_seeds", "seeds"):
        assert row[k] == want[k], k
    assert row["loss_drops"] is True and "seed" not in row
    per_seed[1]["loss_drops"] = False
    assert za.aggregate(per_seed, want["seeds"])["loss_drops"] is False
    # One seed: the row as it came.
    assert za.aggregate(per_seed[:1], [0]) == per_seed[0]


def test_campaign_writes_aggregated_rows(tmp_path, monkeypatch):
    calls = []

    def fake_one(cmd, name):
        calls.append(cmd)
        seed = int(cmd[cmd.index("--seed") + 1])
        return {"metric": f"{name}_synthetic_accuracy", "seed": seed,
                "auc": 0.6 + seed / 100, "loss_drops": True}

    monkeypatch.setattr(za, "_one", fake_one)
    out = tmp_path / "z.json"
    out.write_text(json.dumps({"models": [
        {"metric": "wdl_synthetic_accuracy", "auc": 0.5},
        {"metric": "din_synthetic_accuracy", "auc": 0.1}]}))
    argv = ["din,dlrm_cat", "--seeds", "0,1,2", "--fp32", "--jobs", "2",
            "--out", str(out)]
    za.main(argv)
    doc = json.loads(out.read_text())
    rows = {r["metric"]: r for r in doc["models"]}
    assert set(rows) == {"wdl_synthetic_accuracy", "din_synthetic_accuracy",
                         "dlrm_cat_synthetic_accuracy"}
    assert rows["din_synthetic_accuracy"]["auc"] == 0.61
    assert rows["din_synthetic_accuracy"]["auc_spread"] == 0.02
    assert rows["din_synthetic_accuracy"]["concurrent_runs"] == 2
    din = [c for c in calls if c[2] == "din"]
    assert len(din) == 3 and din[0][3] == "384"       # CAMPAIGN's steps
    for flag, value in (("--lr", "0.3"), ("--items", "20000")):
        assert din[0][din[0].index(flag) + 1] == value
    assert "--fp32" in din[0] and "--dense" not in din[0]
    cat = next(c for c in calls if c[2] == "dlrm_cat")
    assert cat[3] == "576" and cat[cat.index("--dense") + 1] == "adam"
    # One model with --seeds is a campaign of that model, its flags
    # passed on.
    calls.clear()
    za.main(["bst", "--batch", "2048", "--seeds", "0,1", "--out", str(out)])
    assert len(calls) == 2 and all(c[2] == "bst" for c in calls)
    assert calls[0][calls[0].index("--batch") + 1] == "2048"
    rows = {r["metric"]: r for r in json.loads(out.read_text())["models"]}
    assert rows["bst_synthetic_accuracy"]["auc_seeds"] == [0.6, 0.61]


def test_zoo_delta_merges_the_fp32_twins(tmp_path):
    main, fp32 = tmp_path / "m.json", tmp_path / "f.json"
    main.write_text(json.dumps({"note": "n", "models": [
        {"metric": "a_synthetic_accuracy", "auc": 0.70},
        {"metric": "b_synthetic_accuracy", "auc": 0.65},
        {"metric": "c_synthetic_accuracy", "loss_drops": True}]}))
    fp32.write_text(json.dumps({"models": [
        {"metric": "a_synthetic_accuracy", "auc": 0.6875,
         "auc_seeds": [0.68, 0.695]},
        {"metric": "b_synthetic_accuracy", "auc": 0.66}]}))
    assert zd.main(["--main", str(main), "--fp32", str(fp32)]) == 0
    doc = json.loads(main.read_text())
    a, b, c = doc["models"]
    assert (a["auc_fp32"], a["bf16_fp32_delta"]) == (0.6875, 0.0125)
    assert a["auc_fp32_seeds"] == [0.68, 0.695]
    assert (b["auc_fp32"], b["bf16_fp32_delta"]) == (0.66, 0.01)
    assert "auc_fp32" not in c
    assert doc["bf16_fp32_max_delta"] == 0.0125
    assert doc["bf16_fp32_note"] and doc["note"] == "n"


def test_write_bench_zoo_keeps_the_last_valid_row(tmp_path):
    first, second = tmp_path / "1.jsonl", tmp_path / "2.jsonl"
    first.write_text("noise\n" + json.dumps(
        {"metric": "wdl_samples_per_sec", "value": 1.0}) + "\n" + json.dumps(
        {"metric": "din_samples_per_sec", "error": "boom"}) + "\n")
    second.write_text(json.dumps(
        {"metric": "wdl_samples_per_sec", "error": "later failure"}) + "\n"
        + json.dumps({"metric": "din_samples_per_sec", "value": 2.0})
        + "\n" + json.dumps({"metric": "wdl_samples_per_sec",
                             "value": 3.0}) + "\n")
    out = tmp_path / "bench.json"
    assert wbz.main([str(first), str(second), "--out", str(out)]) == 0
    rows = json.loads(out.read_text())["rows"]
    assert [r["metric"] for r in rows] == ["din_samples_per_sec",
                                           "wdl_samples_per_sec"]
    assert rows[0]["value"] == 2.0 and rows[1]["value"] == 3.0
    assert rows[0]["note"] == mb.ROW_NOTES["din"]


def test_model_benchmark_counts_the_towers_gemms(monkeypatch):
    from deeprec_tpu_torch.feature_column.feature_column import \
        EmbeddingGroup
    from deeprec_tpu_torch.models import wdl

    hidden, B = (16, 8), 32
    monkeypatch.setitem(mb.COLUMN_KWARGS, "wdl",
                        dict(embedding_dim=4, capacity=1 << 8,
                             wide_in_deep=True))
    monkeypatch.setitem(mb.MODULE_KWARGS, "wdl", dict(hidden=hidden))
    monkeypatch.setattr(mb, "data_kwargs",
                        lambda name, batch: dict(batch_size=batch, vocab=300))
    row = mb.bench_model("wdl", B, device="cpu", warmup=2, measure=2)
    group = EmbeddingGroup(wdl.criteo_columns(**mb.COLUMN_KWARGS["wdl"]),
                           coalesce=True)
    widths = (wdl.input_width(group),) + hidden + (1,)
    gemm = sum(a * b for a, b in zip(widths, widths[1:]))
    assert row["flops_per_step"] == 3 * 2 * B * gemm
    assert row["device_kind"] == "cpu" and "mfu" not in row
    assert row["value"] > 0 and np.isfinite(row["loss"])
    assert row["vs_baseline"] == round(row["value"] / mb.BASELINES["wdl"], 3)
    eager = mb.bench_model("wdl", B, device="cpu", eager=True, warmup=2,
                           measure=2)
    assert eager["flops_per_step"] == row["flops_per_step"]
    assert eager["method"].startswith("eager loop")


def test_serving_benchmark_device_rows():
    rows = sb.bench_device((1, 4), "cpu", requests=3,
                           model=dict(capacity=1 << 8, hidden=(16, 8),
                                      vocab=300))
    assert [r["batch"] for r in rows] == [1, 4]
    for r in rows:
        assert r["path"] == "device" and r["device_kind"] == "cpu"
        assert 0 < r["p50"] <= r["p99"] and r["samples_per_sec"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA card"):
            sb.main(["--abi-only"])


def test_serving_benchmark_abi_rows(tmp_path, monkeypatch):
    """``--abi-only --cpu`` at a tiny size: c_abi rows at 1 and 64
    instances through the port's C ABI worker, merged into the file's
    other rows (an earlier c_abi row is replaced)."""
    monkeypatch.setattr(sb, "ABI_MODEL", dict(dim=4, capacity=256,
                                              hidden=[16, 8],
                                              dtype="float32"))
    monkeypatch.setattr(sb, "ABI_TRAIN", dict(steps=2, batch=64,
                                              vocab=300))
    monkeypatch.setattr(sb, "REQUESTS", 3)
    out = tmp_path / "serving.json"
    out.write_text(json.dumps({"note": "x", "rows": [
        {"path": "device", "batch": 1}, {"path": "c_abi", "batch": 7}]}))
    sb.main(["--abi-only", "--cpu", "--out", str(out)])
    rows = json.loads(out.read_text())["rows"]
    assert [(r["path"], r["batch"]) for r in rows] == [
        ("device", 1), ("c_abi", 1), ("c_abi", 64)]
    for r in rows[1:]:
        assert r["device_kind"] == "cpu" and r["requests"] == 3
        assert 0 < r["p50"] <= r["p99"] and r["initialize_s"] > 0


def test_step_breakdown_phases():
    args = sbd.parse_args(["--cpu", "--batch", "16", "--cap", "8",
                           "--steps", "1", "--light"])
    out = sbd.breakdown(args, torch.device("cpu"))
    assert set(out["phases_ms"]) == {"probe", "dedup", "gather", "lookup",
                                     "lookup_rest", "dense", "dense_apply",
                                     "apply", "full"}
    assert len(out["per_table"]) == 2           # the 65- and 129-wide
    assert out["ids_per_step"] == sum(t["ids"]
                                      for t in out["per_table"].values())
    for k in ("lookup", "dense", "dense_apply", "apply", "full"):
        assert out["phases_ms"][k] > 0, k
    assert out["phase_sum_ms"] == pytest.approx(
        sum(out["phases_ms"][k] for k in ("lookup", "dense", "dense_apply",
                                          "apply")), abs=1e-3)


@pytest.mark.parametrize("kind,per_element", [("adagrad", 20), ("adam", 28)])
def test_kernel_benchmark_apply_bytes(kind, per_element):
    import chip_smoke

    n, C, D = 64, 256, 8
    values, tables, slots, grads = kb.apply_operands(kind, n, "cpu", C=C,
                                                     D=D)
    assert len(tables) == (1 if kind == "adagrad" else 2)
    assert len(set(slots.tolist())) == n and grads.shape == (n, D)
    nbytes = chip_smoke._apply_bytes(kind, C, D, slots, None, None)
    assert nbytes == per_element * n * D + 4 * n
    assert chip_smoke.bound_ms(nbytes) == pytest.approx(nbytes / 3.35e9)


def test_kernel_benchmark_gather_and_lookup_operands():
    import chip_smoke

    values, slots = kb.gather_operands("cpu", D=8, C=256, n=100)
    distinct = len(set(slots.tolist()))
    assert chip_smoke._gather_bytes(values, slots, None, None, None) == (
        (100 + distinct) * 8 * 4 + 400)
    rows, qhi, qlo = kb.lookup_operands("cpu", C=1 << 10, n=300)
    assert rows.shape == ((1 << 10) // 64, 128) and qhi.shape == (300,)
    assert kb.JOBS[2] == ("lookup",)     # no max_probes argument


def test_env_collect_touches_no_card(monkeypatch, capsys):
    def no_card():
        raise AssertionError("touched the card")

    monkeypatch.setattr(torch.cuda, "is_available", no_card)
    info = env_collect_torch.main(["--no-device"])
    for k in ("python", "torch", "torch_cuda", "numpy", "nvcc", "env",
              "repo", "cpu_count"):
        assert k in info
    assert "cards" not in info and "cuda_available" not in info
    assert json.loads(capsys.readouterr().out) == info


@pytest.mark.parametrize("tool,argv", [
    (za, ["din", "4"]), (mb, ["wdl"]), (sb, []), (sbd, []), (kb, []),
    (env_collect_torch, [])])
def test_tools_fail_without_a_card(tool, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        tool.main(argv)
