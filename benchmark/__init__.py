"""Benchmark of ``deeprec_tpu_torch`` on the H100: ``run.py`` runs one
cell of ``BENCHMARK.json`` (see ``harness.py``)."""
