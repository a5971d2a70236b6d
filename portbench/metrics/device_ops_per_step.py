"""device_ops_per_step (ops/step): device activities (kernels, copies,
sets) in the traced epoch over the steps it ran."""


def read(ctx):
    if not ctx.trace.device_ops or not ctx.traced_steps:
        return None
    return ctx.trace.device_ops / ctx.traced_steps
