"""Device ms a traced step of the embedding backward, autograd through
the fetch and the combine: PyTorch's ``indexing_backward_kernel``
family (the scatter-add of the occurrence gradients into the looked-up
rows), and the vectorized float32 fills and adds that the same backward
launches: each column's slice of a table's stacked combined output gets
a gradient of the whole stack, zero-filled, and autograd adds the
columns' gradients together. The patterns also count any other
vectorized float32 add or fill of the step."""

from benchmark.metrics.kernel_time import ms_a_step

PATTERNS = (
    r"indexing_backward_kernel",
    r"vectorized_elementwise_kernel<\d+, at::native::CUDAFunctor_add<float>",
    r"vectorized_elementwise_kernel<\d+, at::native::FillFunctor<float>",
)


def read(ctx):
    return ms_a_step(ctx, PATTERNS)
