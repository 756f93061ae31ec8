"""The harness's column forms on the test cell ``TOY``: a table that two
columns share holds one row for an id, read alike by both, on the
program's side and the reference's; the frozen coalescing rule names
the port's tables, salts and keys for shared tables; padding is no id
in the byte models; and the reference, the test cell's with it, loads
neither the port nor JAX."""

import os
import subprocess
import sys

import torch

from benchmark import harness, manifest, roofline
from benchmark.reference import keys as keylib
from benchmark.reference import train as reflib
from benchmark.tests.conftest import REPO, SEED, TOY
from deeprec_tpu_torch.feature_column.feature_column import (EmbeddingGroup,
                                                             SparseIds)


def _cell(root, workload=TOY):
    return manifest.cell(root, workload,
                         bench_dir=os.path.join(root, "benchmark"))


def _pairs(item, seq):
    """Where ``item`` [B, 1] and ``seq`` [B, T] hold one id: the rows of
    ``item``, and the rows and positions of ``seq``."""
    i, j = (item == seq.reshape(1, -1)).nonzero(as_tuple=True)
    return i, j // seq.shape[1], j % seq.shape[1]


def test_shared_table_rows_are_one(tiny_root):
    cell = _cell(tiny_root)
    rn = harness.Runner(cell, SEED, "cpu")
    pool, raw = rn.feed.next(keep=1)
    item, seq = raw["ids"]["item"][0], raw["ids"]["seq_items"][0]
    i, b, t = _pairs(item, seq)
    assert i.numel() > 10
    # The program: one lookup of the packed batch, then the combine.
    g = rn.tr.group
    batch = {k: (SparseIds(v.hi[0], v.lo[0]) if isinstance(v, SparseIds)
                 else v[0]) for k, v in pool.items()}
    _, gl = g.lookup_train(rn.tr.ts.ev, batch,
                           torch.zeros((), dtype=torch.int32))
    embs = g.combine(gl, {n: lk.rows for n, lk in gl.lks.items()})
    assert torch.equal(embs["item"][i], embs["seq_items"][0][b, t])
    assert g.physical_table_of(next(
        c for c in rn.tr.columns if c.name == "item")) == \
        g.physical_table_of(next(c for c in rn.tr.columns
                                 if c.name == "seq_items"))
    # The reference.
    ref = reflib.Reference(cell.cfg, cell.ref_mod.columns(cell.cfg),
                           cell.ref_mod.forward, rn.tr.dense0, "cpu")
    rembs, _ = ref._embed({c: v[0] for c, v in raw["ids"].items()})
    assert torch.equal(rembs["item"][i], rembs["seq_items"][0][b, t])
    seq_rows, mask = rembs["seq_items"]
    assert torch.equal(mask, seq != keylib.EMPTY_KEY)
    assert (seq_rows[~mask] == 0).all()


def test_shared_tables_follow_the_port(tiny_root):
    """Salts, coalescing and keys of the frozen rule against the port's,
    for columns that share tables and columns of several ids."""
    cell = _cell(tiny_root)
    group = EmbeddingGroup(cell.cfg_mod.columns(cell.cfg), coalesce=True)
    specs = keylib.tables_of(cell.ref_mod.columns(cell.cfg))
    assert len(specs) == len(group.tables) == 1
    (spec,) = specs
    assert set(spec["members"]) == {"user", "item_emb", "recent_cats"}
    ids = torch.tensor([[3, keylib.EMPTY_KEY], [(1 << 41) + 17, 5]])
    for c, d in zip(group.embedding,
                    keylib.describe(cell.ref_mod.columns(cell.cfg))):
        t = group.physical_table_of(c)
        assert group.salts[t] == spec["salt"]
        assert c.table_name == d["table"]
        hi, lo = group.transform_ids(c, *keylib.split(ids))
        real = ids != keylib.EMPTY_KEY
        assert torch.equal(keylib.join(hi, lo)[real],
                           keylib.salted(ids, spec["members"][d["table"]])
                           [real])
        assert (keylib.join(hi, lo)[~real] == keylib.EMPTY_KEY).all()


def test_padding_is_no_id_in_the_byte_models(tiny_root):
    cell = _cell(tiny_root, "dlrm_train_stream")
    rn = harness.Runner(cell, SEED, "cpu")
    pool = rn.feed.next()[0]
    rn.call(harness.pool_slice(pool, 0, 2))
    key = rn.tr.group.PACKED_PREFIX + next(iter(rn.tr.group.tables))
    s = pool[key]
    pad = torch.full(s.hi.shape[:2] + (7,), keylib.EMPTY_HI,
                     dtype=torch.int32)
    padded = dict(pool)
    padded[key] = SparseIds(torch.cat([pad, s.hi, pad], dim=2),
                            torch.cat([pad * 0, s.lo, pad * 0], dim=2))
    lost = harness.lost_ids(rn, pool)
    assert 0 < lost < s.hi.numel()
    assert harness.lost_ids(rn, padded) == lost
    cap = next(iter(rn.tr.group.tables.values())).capacity
    counts = [roofline.step_counts(
        keylib.join(p[key].hi, p[key].lo).view(rn.K, -1), cap)
        for p in (pool, padded)]
    assert counts[0] == counts[1]
    assert counts[0]["ids"] == s.hi.numel()


REF_SCRIPT = """
import glob, sys
sys.path.insert(0, {repo!r})
from benchmark.manifest import load_module
from benchmark.reference import keys, train
for i, p in enumerate(sorted(glob.glob({pattern!r}))):
    load_module(p, "ref_%d" % i)
print(sorted({{m.split(".")[0] for m in sys.modules}}
             & {{"deeprec_tpu_torch", "deeprec_tpu", "jax", "jaxlib"}}))
"""


def test_reference_imports_neither_the_port_nor_jax(tiny_root):
    code = REF_SCRIPT.format(repo=REPO, pattern=os.path.join(
        tiny_root, "benchmark", "reference", "*.py"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
