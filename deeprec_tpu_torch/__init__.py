"""PyTorch port of ``deeprec_tpu`` for NVIDIA Hopper GPUs.

The package mirrors the JAX package's layout file for file: each module
here has exactly one counterpart in ``deeprec_tpu/`` and is held against
it by the parity tests in ``tests/test_torch_*.py``. It imports
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
them.
"""
