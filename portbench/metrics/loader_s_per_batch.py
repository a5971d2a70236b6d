"""loader_s_per_batch (s): host seconds per batch of the program's train
loader (collate, augmentation, host planning) on one thread and without
prefetch: the public ``train_batches`` over one epoch of the cell's
traffic, outside the window."""

import dataclasses
import time


def read(ctx):
    from tdwss_torch.data.loader import train_batches

    cfg = dataclasses.replace(ctx.cfg, engine=dataclasses.replace(
        ctx.cfg.engine, collate_workers=1))
    n, t = 0, time.perf_counter()
    for _ in train_batches(ctx.scenes, cfg, ctx.loader_epoch,
                           prefetch=False):
        n += 1
    return (time.perf_counter() - t) / n if n else None
