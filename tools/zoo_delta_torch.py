"""Merge the fp32 twin of the card's zoo campaign
(``ZOO_AUC_H100_FP32.json``) into ``ZOO_AUC_H100.json`` as per-model
``auc_fp32`` and ``bf16_fp32_delta`` fields and a file-level
``bf16_fp32_max_delta``: the counterpart of ``tools/zoo_delta.py``.
Run after both campaigns of ``tools/zoo_auc_torch.py``:

  python3 tools/zoo_auc_torch.py all --seeds 0,1,2
  python3 tools/zoo_auc_torch.py all --seeds 0,1,2 --fp32
  python3 tools/zoo_delta_torch.py [--main FILE] [--fp32 FILE]
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOTE = (
    "Each fp32 twin is the same campaign with float32 towers: the same "
    "seeds, data streams and initial weights, trained from the start. "
    "The two runs part after the first bf16 rounding and train on "
    "separately, so a delta measures how far two trajectories drift "
    "apart over a few hundred steps, not the rounding error of one "
    "forward pass. Where both rows average several seeds, the delta "
    "compares the seed means.")


def merge(main_doc: dict, fp32_doc: dict) -> int:
    """Add the twins' AUCs to ``main_doc``'s rows in place; returns how
    many rows got one."""
    fp32 = {r["metric"]: r for r in fp32_doc.get("models", [])
            if "auc" in r}
    n = 0
    for row in main_doc.get("models", []):
        twin = fp32.get(row.get("metric"))
        if twin is None or "auc" not in row:
            continue
        row["auc_fp32"] = twin["auc"]
        if "auc_seeds" in twin:
            row["auc_fp32_seeds"] = twin["auc_seeds"]
        row["bf16_fp32_delta"] = round(abs(row["auc"] - twin["auc"]), 4)
        n += 1
    deltas = [r["bf16_fp32_delta"] for r in main_doc.get("models", [])
              if "bf16_fp32_delta" in r]
    main_doc["bf16_fp32_max_delta"] = max(deltas) if deltas else None
    main_doc["bf16_fp32_note"] = NOTE
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--main", default=os.path.join(ROOT, "ZOO_AUC_H100.json"))
    p.add_argument("--fp32",
                   default=os.path.join(ROOT, "ZOO_AUC_H100_FP32.json"))
    args = p.parse_args(argv)
    with open(args.main) as f:
        main_doc = json.load(f)
    with open(args.fp32) as f:
        fp32_doc = json.load(f)
    n = merge(main_doc, fp32_doc)
    with open(args.main, "w") as f:
        json.dump(main_doc, f, indent=1)
    print(f"merged {n} fp32 twins; max |delta| = "
          f"{main_doc['bf16_fp32_max_delta']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
