"""Device ms a traced step of the port's embedding combine and its
backward: the ``occ_`` kernels of ``csrc/occ_combine.cu`` (the
gather-combine forward; the backward's segmented sum, long-segment
blocks and zero rows). The stable sort that orders the backward's
occurrences is ``torch.sort``'s, whose kernels the step's other sorts
share, so it is not read. None where the trace holds none of the
``occ_`` kernels, as in a program without them."""

from benchmark.metrics.kernel_time import ms_a_step

PATTERNS = (r"\bocc_[a-z_]+_kernel\b",)


def read(ctx):
    return ms_a_step(ctx, PATTERNS)
