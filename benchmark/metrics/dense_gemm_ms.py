"""Device ms a traced step of the towers' matrix products: cuBLAS and
CUTLASS GEMM kernels by name (``gemm``, ``nvjet``, ``cutlass``,
``xmma``, ``cublas``), batched products included."""

from benchmark.metrics.kernel_time import ms_a_step

PATTERNS = (
    r"(?i)gemm",
    r"nvjet",
    r"(?i)cutlass",
    r"xmma",
    r"(?i)cublas",
)


def read(ctx):
    return ms_a_step(ctx, PATTERNS)
