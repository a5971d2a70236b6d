"""conv_roofline (%): the least time of the traced steps' convolution
work (portbench/work: forward, input gradient and weight gradient of
every submanifold, strided and transposed conv and 1x1 projection, from
the live entries) over the device time spent in the conv layer's ranges
(portbench/trace.py: module hooks in the forward, autograd node hooks in
the backward).  Unpools are neither in the work nor in the time."""

from portbench.trace import CONV


def read(ctx):
    dev_s = ctx.trace.layer_device_s.get(CONV, 0.0)
    if dev_s <= 0 or ctx.work is None:
        return None
    return 100.0 * ctx.work["conv"].least_s / dev_s
