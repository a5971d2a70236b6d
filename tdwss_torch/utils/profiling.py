"""Profiling helpers (twin of ``tdwss.utils.profiling``): a
``torch.profiler`` trace around a block, and a wall-clock step timer."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional


@contextlib.contextmanager
def trace(logdir: str = "exp/profile",
          name: str = "trace.json") -> Iterator[object]:
    """Record the host's and, where a card is present, the card's
    activity in the block, and write it as a Chrome trace,
    ``<logdir>/<name>``, gzipped where ``name`` ends in ``.gz``
    (ui.perfetto.dev opens either).  Yields the profiler, whose
    ``key_averages()`` the caller may read after the block::

        with profiling.trace("exp/run1/profile") as prof:
            train_step(cfg, model, opt, sched, batch)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total"))
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, name))


class StepTimer:
    """Rolling wall-clock step timer (reference train.py:52,88)."""

    def __init__(self) -> None:
        self._t0: Optional[float] = None
        self.history: list = []

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() before start()")
        dt = time.perf_counter() - self._t0
        self.history.append(dt)
        self._t0 = None
        return dt

    @property
    def mean(self) -> float:
        return sum(self.history) / max(len(self.history), 1)
