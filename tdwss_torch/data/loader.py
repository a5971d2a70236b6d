"""Host batch iterators with background prefetch (twin of
``tdwss.data.loader``).

Shuffled drop_last train batches and val batches carrying global point
ids, each drawn from its own ``SeedSequence`` as in the reference, so the
port and the reference see the same views.  Collate and host planning
run on a pool of threads (:func:`_parallel_map_ordered`): numpy and the
native planner (a ctypes call, which releases the GIL) overlap with each
other and with the training step.  :func:`_prefetch` can also start each
batch's copy to the card from its thread, on a copy stream of its own.

There is no plan cache: the reference's (``tdwss/data/loader.py:89-175``)
keys batches by seed, epoch, start and scene identity, not by the config
or the scenes' contents, and replays stale batches where those change.
``engine.plan_cache_batches`` is not read here.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tdwss_torch.config import Config
from tdwss_torch.data.batch import PointBatch
from tdwss_torch.data.collate import CollateStats, train_collate, val_collate
from tdwss_torch.data.plans import attach_host_plans, slim_batch_for_train
from tdwss_torch.data.synthetic import Scene
from tdwss_torch.utils import profiling


class _OnCard:
    """A batch whose copy to the card was issued on a copy stream, and
    the event that marks the copy's end."""

    def __init__(self, batch: PointBatch, event, device: torch.device):
        self.batch = batch
        self.event = event
        self.device = device

    def take(self) -> PointBatch:
        """The batch, safe to use on the current stream: that stream waits
        for the copy, and the caching allocator is told that every tensor
        is used there (``record_stream``), so none of their memory is
        handed to the copy stream again before the work queued on the
        current stream is done."""
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.event)
        for t in self.batch.tensors():
            t.record_stream(stream)
        return self.batch


def _copy_to_card(batch: PointBatch, device: torch.device,
                  stream) -> _OnCard:
    with torch.cuda.device(device), torch.cuda.stream(stream):
        out = batch.to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return _OnCard(out, event, device)


def _prefetch(gen, depth: int = 2, to_device=None, epoch=None):
    """Iterate ``gen`` on a background thread, ``depth`` items ahead.

    With ``to_device`` (a card), the thread also issues each batch's copy
    there, from pinned memory on a copy stream of its own, so the copy
    overlaps the step running on the compute stream; the consumer's
    stream waits for the copy's event before the batch is yielded.  An
    exception in the thread (collate, plan, copy) is raised in the
    consumer after the items before it.  The copy and the consumer's
    wait for each item are the spans ``tdwss.loader.copy`` and
    ``tdwss.loader.wait``, keyed ``(epoch, ordinal)``; the last wait is
    the one for the end of ``gen``.
    """
    device = None if to_device is None else torch.device(to_device)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    failure: list = []

    def worker():
        try:
            stream = (torch.cuda.Stream(device)
                      if device is not None and device.type == "cuda"
                      else None)
            for i, item in enumerate(gen):
                if device is not None:
                    with profiling.span("tdwss.loader.copy", (epoch, i)):
                        item = (_copy_to_card(item, device, stream)
                                if stream is not None else item.to(device))
                q.put(item)
        except BaseException as e:          # re-raised in the consumer
            failure.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    for i in itertools.count():
        with profiling.span("tdwss.loader.wait", (epoch, i)):
            item = q.get()
            if isinstance(item, _OnCard):
                item = item.take()
        if item is sentinel:
            if failure:
                raise failure[0]
            return
        yield item


def _parallel_map_ordered(fn, items, num_workers: int, depth: int = 4):
    """``fn`` over ``items`` on a pool of at most ``num_workers`` threads
    (capped at the host's cores), yielding the results in order with at
    most ``num_workers + depth`` in flight; one worker maps in the
    caller's thread."""
    num_workers = min(num_workers, os.cpu_count() or num_workers)
    if num_workers <= 1:
        for it in items:
            yield fn(it)
        return
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        it = iter(list(items))
        pending = []
        for x in it:
            pending.append(pool.submit(fn, x))
            if len(pending) >= num_workers + depth:
                break
        i = 0
        while i < len(pending):
            yield pending[i].result()
            pending[i] = None               # the consumer owns it now
            i += 1
            nxt = next(it, None)
            if nxt is not None:
                pending.append(pool.submit(fn, nxt))


def shard_starts(starts: Sequence[int], shard: Tuple[int, int]
                 ) -> List[int]:
    """The batch starts of rank ``r`` of ``world`` (``shard``): each
    group of ``world`` consecutive batches is one data-parallel step,
    rank ``r`` takes the ``r``-th of each, and an incomplete last group
    is dropped (the reference's ``dp_train_batches``,
    tdwss/parallel/dp.py:295-305)."""
    r, world = shard
    return [starts[k * world + r] for k in range(len(starts) // world)]


def train_batches(scenes: Sequence[Scene], cfg: Config, epoch: int,
                  stats: Optional[CollateStats] = None,
                  prefetch: bool = True,
                  to_device=None,
                  shard: Optional[Tuple[int, int]] = None
                  ) -> Iterator[PointBatch]:
    """Shuffled, drop_last batches of ``cfg.pointcloud_data.batch_size``
    scenes: the epoch's order from ``SeedSequence([seed, epoch])``, each
    batch's augmentation from ``SeedSequence([seed, epoch, start])``;
    host plans attached and the batch slimmed for training (as the
    engine config asks).  With ``prefetch``, ``to_device`` also copies
    each batch to that device ahead of use (see :func:`_prefetch`).
    ``shard=(rank, world)`` gives only that rank's batches of each
    data-parallel step (:func:`shard_starts`; ``cfg`` then holds the
    per-rank batch size), and plans no other.  Each batch's collate and
    plans are the span ``tdwss.loader.batch`` with the children
    ``tdwss.loader.collate`` (with ``tdwss.loader.tokenize`` inside,
    for text configs) and ``tdwss.loader.plan``, keyed
    ``(epoch, ordinal)`` as the step that trains on it."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, epoch]))
    order = rng.permutation(len(scenes))
    bs = cfg.pointcloud_data.batch_size
    starts = list(range(0, len(order) - bs + 1, bs))
    if shard is not None:
        starts = shard_starts(starts, shard)

    def make(item):
        ordinal, start = item
        key = (epoch, ordinal)
        with profiling.span("tdwss.loader.batch", key):
            sel = [scenes[i] for i in order[start: start + bs]]
            brng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, epoch, start]))
            with profiling.span("tdwss.loader.collate", key):
                batch = train_collate(sel, cfg, brng, stats, key)
            if cfg.engine.host_plans:
                with profiling.span("tdwss.loader.plan", key):
                    batch = attach_host_plans(batch, cfg)
                    if cfg.engine.slim_train_batch:
                        batch = slim_batch_for_train(batch, cfg)
        return batch

    gen = _parallel_map_ordered(make, list(enumerate(starts)),
                                cfg.engine.collate_workers)
    return (_prefetch(gen, to_device=to_device, epoch=epoch) if prefetch
            else gen)


def warm_plan_shapes(scenes: Sequence[Scene], cfg: Config,
                     epochs=(1,),
                     shard: Optional[Tuple[int, int]] = None) -> List[int]:
    """Converge the sticky plan-shape registry before training.

    Window sizes and spill capacities ratchet up across batches
    (:mod:`tdwss_torch.ops.host_plan`), so a batch's padded shapes depend
    on the batches planned before it, and with several collate workers
    on the order in which they run.  One dry pass over each of
    ``epochs`` (collate + plans, results dropped), then up to 8 more
    epochs until an epoch ratchets nothing, pushes the shapes to where
    the batches of those epochs ratchet nothing more.  Returns the epochs
    planned.
    """
    if not cfg.engine.host_plans:
        return []
    from tdwss_torch.ops.host_plan import _ECAP_REGISTRY

    planned = list(epochs)
    for e in epochs:
        for _ in train_batches(scenes, cfg, epoch=e, prefetch=False,
                               shard=shard):
            pass
    last = max(epochs, default=0)
    for e in range(last + 1, last + 9):
        before = dict(_ECAP_REGISTRY)
        for _ in train_batches(scenes, cfg, epoch=e, prefetch=False,
                               shard=shard):
            pass
        planned.append(e)
        if _ECAP_REGISTRY == before:
            break
    return planned


def val_batches(scenes: Sequence[Scene], cfg: Config,
                scene_offsets: np.ndarray, rep: int,
                stats: Optional[CollateStats] = None
                ) -> Iterator[PointBatch]:
    """Sequential val batches (one random view per scene and rep, from
    ``SeedSequence([seed, 7777, rep, start])``), with point_ids, planned
    in the caller's thread."""
    bs = cfg.pointcloud_data.batch_size
    for start in range(0, len(scenes), bs):
        brng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, 7777, rep, start]))
        idx = list(range(start, min(start + bs, len(scenes))))
        batch = val_collate([scenes[i] for i in idx], cfg, brng,
                            scene_offsets, idx, stats, num_scenes=bs)
        if cfg.engine.host_plans:
            batch = attach_host_plans(batch, cfg)
        yield batch


def steps_per_epoch(num_scenes: int, batch_size: int) -> int:
    return num_scenes // batch_size
