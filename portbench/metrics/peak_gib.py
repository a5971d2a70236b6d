"""peak_gib (GiB): ``torch.cuda.max_memory_allocated`` over set-up,
warm-up and the window, the loader's prefetched batches included."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
