"""Plain PyTorch reference of the benchmark's cells: the key arithmetic
(``keys``), the training steps (``train``) and each configuration's
towers (``<config>.py``). Nothing here imports the port or JAX."""
