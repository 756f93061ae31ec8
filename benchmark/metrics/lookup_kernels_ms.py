"""Device ms a traced step of the port's lookup kernels: the hash probe
and insert P1 (``csrc/hash_probe.cu``), the fresh rows' draw P2
(``csrc/init_rows.cu``) and the row fetch K1 (``csrc/gather_rows.cu``)."""

from benchmark.metrics.kernel_time import ms_a_step

PATTERNS = (
    r"\bfast_kernel\b",
    r"\bround_kernel\b",
    r"\bresolve_kernel\b",
    r"\bfind_kernel\b",
    r"\binit_fresh_kernel\b",
    r"\bgather_rows_kernel\b",
)


def read(ctx):
    return ms_a_step(ctx, PATTERNS)
