"""device_idle_share (%): the share of the traced epoch in which no
operation ran on the card, 1 - (union of device activity) / its length.

The traced epoch follows an untraced one, and the profiler's host
overhead stretches it by ``trace_stretch`` (its length over the
untraced epoch's): the idle time it reads includes that overhead, while
the device's busy time is the same work as untraced."""


def read(ctx):
    t = ctx.trace
    if not t.device_ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
