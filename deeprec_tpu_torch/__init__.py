"""PyTorch port of ``deeprec_tpu`` for NVIDIA Hopper GPUs.

The package mirrors the JAX package's layout file for file: each module
here has exactly one counterpart in ``deeprec_tpu/`` and is held against
it by the parity tests in ``tests/test_torch_*.py``, except the port's
own: the hand-written kernels (``ops/kernels`` over ``csrc``) and the
recorder of spans and counters inside the port (``utils/trace.py``,
the program side of ``torch.profiler``). It imports
``torch`` and never JAX, so it runs on a machine without JAX.

Covered so far, for the headline WDL model: the serving path (hash-table
probe and row fetch with default select through the hand-written CUDA
kernels in ``csrc/hash_probe.cu`` and ``csrc/gather_rows.cu``, bag
combine, towers, checkpoint restore, full/delta updates, HTTP scoring
and the serving worker) and the single-device training step (insert
through the same probe kernel and first-occurrence dedup, with no host
read; the same fetch; the per-column or fused per-table combine; towers
forward and backward; dense Adagrad; and every sparse optimizer of the
JAX package, Adagrad, Adam and AdamAsync in the kernels of
``csrc/sparse_apply.cu``), with checkpoints that carry the optimizer
state; static hash-bucket columns (offset-coalesced matrices fetched by
the same kernel); and the input pipeline (the Kaggle TSV parser in
``native/host_ops.cc``, the compact wire format, ``data/prefetch.py``).
``bench.py`` times the four rows of the JAX package's ``bench.py``:
headline, static, dim16 and e2e.

The model zoo (``models/registry.py``: WDL, DeepFM, DLRM, DIN, DIEN, BST,
DSSM, ESMM, MMoE, DBMTL, SimpleMultiTask) trains through the same step,
sequence columns included; ``tools/train_zoo_torch.py`` drives any of
them. Tables shard over a ``torch.distributed`` mesh
(``embedding/sharded.py``). The table and column variants: weighted
columns, dynamic-dimension tables (``embedding/dyn_dim.py``), adaptive
embedding (``embedding/adaptive.py``), multi-hash embeddings and
growable tables (``embedding/multi_hash.py``, ``embedding/tensible.py``);
host and disk tiers (``embedding/multi_tier.py``). Serving also runs from sharded tables (``ServingModel(mesh=)``),
behind the KServe v2 front (``serving/kserve.py``), in remote mode over
a feature store (``serving/feature_store.py``, ``serving/resp.py``),
through the embeddable C ABI and its SDKs (``serving/native/``,
``serving/sdk/``), and from int8 tables (``tools/low_precision.py``).
"""
