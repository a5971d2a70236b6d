"""text_tower_roofline (%): the least time of the traced epoch's text
tower work (``portbench/work/text.py``: the tower's and ``text_linear``'s
FLOPs and bytes, forward and backward, over every (scene, slot) row at
the context length, in f32: max(FLOPs / 67 TFLOP/s, bytes / 3.35 TB/s))
over the device time of the tower's ranges, as ``text_tower_share``
reads it.  Nothing without that device time."""


def read(ctx):
    from tdwss_torch.utils import profiling

    if ctx.work is None or ctx.tower_device_s <= 0 \
            or "tdwss.text.tower" not in profiling.span_totals():
        return None
    return 100.0 * ctx.work["tower"].least_s / ctx.tower_device_s
