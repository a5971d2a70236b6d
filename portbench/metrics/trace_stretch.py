"""trace_stretch (x): the traced epoch's length (the profiler's window)
over the untraced epoch's before it, in the same run: how far
the profiler's host overhead stretches what ``device_idle_share`` reads
(1 is no stretch)."""


def read(ctx):
    t = ctx.trace
    if not t.device_ops or t.window_s <= 0 or not ctx.epoch_s:
        return None
    return t.window_s / (sum(ctx.epoch_s) / len(ctx.epoch_s))
