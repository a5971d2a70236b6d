"""train_mfu (%): the untraced epoch's model FLOPs (portbench/work's
frozen count over its batches: every conv and 1x1 projection, forward
and backward) over its wall time times the card's dense peak in the
compute dtype (989 TFLOP/s in bf16 on an H100 SXM).  Read in the
``--trace 1`` run, from the untraced epoch before the traced one, so
the profiler does not stretch it; nothing off the card."""

from portbench.work.count import PEAK_FLOPS


def read(ctx):
    if not ctx.on_card or ctx.window_work is None or ctx.window_s <= 0:
        return None
    return 100.0 * ctx.window_work.flops / (
        ctx.window_s * PEAK_FLOPS[ctx.compute_dtype])
