"""C1/C2's least time over their measured time, in %: the bytes the
traced steps' embedding combine and its backward need
(``combine_bytes``: each real occurrence's row and output gradient,
17 + 16 bytes an occurrence, each distinct row's gradient and each
output element, counted from the traced pools' own keys and the
configuration's columns) at the card's peak memory rate, over the
device time of the ``occ_`` kernels in the trace (as ``combine_kernels_ms``
reads them, the backward's ``torch.sort`` left out on both sides). A
sequence column's outputs are ``max_seq_len`` positions a sample. None
where the trace holds no ``occ_`` kernel."""

from benchmark import combine_bytes
from benchmark.metrics.combine_kernels_ms import PATTERNS
from deeprec_tpu_torch.feature_column.feature_column import \
    SequenceEmbeddingColumn


def _columns(ctx):
    """(dim, positions a sample) of each embedding column; None where a
    sequence column's width is not in the configuration."""
    out = []
    for c in ctx.cfg_mod.columns(ctx.cfg):
        if not hasattr(c, "dim"):
            continue
        if isinstance(c, SequenceEmbeddingColumn):
            if "max_seq_len" not in ctx.cfg:
                return None
            out.append((c.dim, int(ctx.cfg["max_seq_len"])))
        else:
            out.append((c.dim, 1))
    return out


def read(ctx):
    if (ctx.trace is None or not ctx.tables or ctx.peaks is None
            or not ctx.traced_steps):
        return None
    us = ctx.trace.device_us(PATTERNS)
    cols = _columns(ctx)
    if us <= 0 or cols is None:
        return None
    nbytes = combine_bytes.combine_bytes(
        [(t["dim"], t["ids"], t["applied"]) for t in ctx.tables],
        combine_bytes.out_elements(cols, ctx.traced_steps * ctx.batch))
    return 100.0 * nbytes / ctx.peaks["hbm_bytes"] / (us / 1e6)
