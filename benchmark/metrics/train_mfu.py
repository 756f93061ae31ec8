"""The whole step's share of the card's bf16 dense peak, in %: model
FLOPs of every step of the measured window (6 x the configuration's
multiply-adds a sample, ``configs/<config>.py``'s ``macs_per_sample``,
counted from the shapes in its file: forward, and the backward to both
the weights and the inputs, since the embeddings train) over the
window's seconds, against 989 TFLOP/s."""


def read(ctx):
    if ctx.peaks is None:
        return None
    flops = 6 * ctx.cfg_mod.macs_per_sample(ctx.cfg) * ctx.samples
    return 100.0 * flops / ctx.window_s / ctx.peaks["bf16_flops"]
