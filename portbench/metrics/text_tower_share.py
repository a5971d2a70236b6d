"""text_tower_share (%): the device time of the operations launched in
the text tower's forward (the program's span ``tdwss.text.tower``, with
``text_linear``) and in its backward (autograd-node ranges,
``portbench/trace_text.py``), over the traced epoch's device busy time
(the union of device activity).  Nothing without a device trace, or
from a program without the span."""


def read(ctx):
    from tdwss_torch.utils import profiling

    if not ctx.trace.device_ops or ctx.trace.busy_s <= 0 \
            or "tdwss.text.tower" not in profiling.span_totals():
        return None
    return 100.0 * ctx.tower_device_s / ctx.trace.busy_s
