"""text_train_mfu (%): the untraced epoch's model FLOPs (the frozen
counts over its batches: the FCN's convolutions, forward and backward,
from ``portbench/work/count.py``'s rules, and the text tower's and
``text_linear``'s from ``portbench/work/text.py``) over its wall time
times the card's dense bf16 peak (989 TFLOP/s on an H100 SXM), as
``train_mfu`` counts it.  Read in the ``--trace 1`` run, from the
untraced epoch before the traced one; nothing off the card."""

from portbench.work.count import PEAK_FLOPS


def read(ctx):
    if not ctx.on_card or ctx.window_work is None or ctx.window_s <= 0:
        return None
    return 100.0 * ctx.window_work.flops / (
        ctx.window_s * PEAK_FLOPS[ctx.compute_dtype])
