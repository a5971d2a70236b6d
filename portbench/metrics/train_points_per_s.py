"""train_points_per_s (points/s): the points of every scene the window's
completed epochs trained on (counted from the benchmark's own traffic),
over the window's wall time."""


def read(ctx):
    return ctx.points / ctx.window_s
