"""Epoch-numbered checkpoints with auto-resume (twin of
``tdwss.utils.checkpoint``, in the port's own format).

One ``torch.save`` file per epoch, ``epoch_<N>.pt``, holding whatever
state the caller passes (the :class:`tdwss_torch.engine.train.Trainer`
saves the model, optimiser and scheduler state dicts and the step).  A
file is written under a temporary name and renamed, so a run stopped
mid-write leaves no partial checkpoint; the newest ``max_to_keep`` are
kept.  The port's checkpoints live in their own directory and neither
package reads the other's; :mod:`tdwss_torch.convert` carries parameters
across.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, List, Optional, Tuple

import torch

_NAME = re.compile(r"epoch_(\d+)\.pt$")


def _epochs(directory: str) -> List[int]:
    out = []
    for path in glob.glob(os.path.join(directory, "epoch_*.pt")):
        m = _NAME.search(os.path.basename(path))
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def path(self, epoch: int) -> str:
        """The file of ``epoch``'s checkpoint."""
        return os.path.join(self._dir, f"epoch_{epoch}.pt")

    def save(self, epoch: int, state: Any) -> None:
        final = self.path(epoch)
        tmp = final + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, final)
        for old in _epochs(self._dir)[:-self.max_to_keep]:
            os.remove(self.path(old))

    @property
    def latest_epoch(self) -> Optional[int]:
        epochs = _epochs(self._dir)
        return epochs[-1] if epochs else None

    def restore_latest(self, map_location=None) -> Tuple[Optional[Any], int]:
        """(state, next epoch) of the newest checkpoint; (None, 1) when
        there is none."""
        epoch = self.latest_epoch
        if epoch is None:
            return None, 1
        state = torch.load(self.path(epoch), map_location=map_location,
                           weights_only=False)
        return state, epoch + 1


def load_pretrain(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Seed ``model``'s parameters and batch-norm buffers from the newest
    checkpoint of the Checkpointer directory ``path`` (fine-tuning: the
    optimiser, schedule and step stay fresh, unlike a resume)."""
    epochs = _epochs(os.path.abspath(path))
    if not epochs:
        raise FileNotFoundError(f"no checkpoint found under {path}")
    state = torch.load(os.path.join(path, f"epoch_{epochs[-1]}.pt"),
                       map_location="cpu", weights_only=False)
    model.load_state_dict(state["model"])
    return model
