"""Device ms a traced step of K2, the sparse Adagrad apply
(``csrc/sparse_apply.cu``'s ``apply_kernel`` over ``AdagradOp``)."""

from benchmark.metrics.kernel_time import ms_a_step

PATTERNS = (
    r"apply_kernel<.*AdagradOp",
)


def read(ctx):
    return ms_a_step(ctx, PATTERNS)
