"""Scalar logging (twin of ``tdwss.utils.logging_util``): JSONL under the
experiment directory, mirrored to TensorBoard where its writer can be
imported."""

from __future__ import annotations

import json
import os
import time


class ScalarLogger:
    def __init__(self, directory: str, use_tensorboard: bool = True):
        os.makedirs(directory, exist_ok=True)
        self._path = os.path.join(directory, "scalars.jsonl")
        self._file = open(self._path, "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(directory)
            except Exception:
                self._tb = None

    def scalar(self, tag: str, value: float, step: int) -> None:
        rec = {"tag": tag, "value": float(value), "step": int(step),
               "time": time.time()}
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self) -> None:
        self._file.close()
        if self._tb is not None:
            self._tb.close()
