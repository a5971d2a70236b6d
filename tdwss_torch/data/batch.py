"""Fixed-capacity point batch (twin of ``tdwss.data.batch.PointBatch``
and ``TextBatch``).

Host batches hold numpy arrays (and, after
:func:`tdwss_torch.data.plans.slim_batch_for_train`, a bf16 CPU tensor of
voxel features); :meth:`PointBatch.to` moves every array and tensor (and
the plans and the text) to a torch device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Iterator, Optional

import numpy as np
import torch

from tdwss_torch.ops.plan import _to_tensor


def _move(obj, device, non_blocking: bool):
    """A dataclass with every array and tensor field on ``device``."""
    kw = {f.name: _to_tensor(getattr(obj, f.name), device, non_blocking)
          for f in dataclasses.fields(obj)
          if isinstance(getattr(obj, f.name), (np.ndarray, torch.Tensor))}
    return dataclasses.replace(obj, **kw)


@dataclass
class TextBatch:
    """Padded text of a train batch: tokens (B', T, L) int32 ids, 0-padded
    (ids reach 49,407, past int16); has_text (B',) int32, the owning scene
    of each row; valid (B',) bool, the rows whose scene has texts."""

    tokens: Any
    has_text: Any
    valid: Any

    def to(self, device, non_blocking: bool = False) -> "TextBatch":
        return _move(self, device, non_blocking)


@dataclass
class PointBatch:
    """coords (N, 4) int32 [x, y, z, scene]; feats (N, C); valid (N,) bool;
    scene_label (B, 20); scene_mask (B,); point_label (N,); point_ids (N,)
    global val-point index (-1 unused); plans / vox_feats (V0, C) /
    point2voxel (N,) / point_perm (N,) from the host planner."""

    coords: Any
    feats: Any
    valid: Any
    scene_label: Any
    scene_mask: Any
    point_label: Any
    point_ids: Any
    plans: Optional[Any] = None
    vox_feats: Optional[Any] = None
    point2voxel: Optional[Any] = None
    point_perm: Optional[Any] = None
    text: Optional[TextBatch] = None

    @property
    def num_points(self) -> int:
        return self.coords.shape[0]

    @property
    def num_scenes(self) -> int:
        return self.scene_label.shape[0]

    def replace(self, **kw) -> "PointBatch":
        return dataclasses.replace(self, **kw)

    def to(self, device, non_blocking: bool = False) -> "PointBatch":
        """Every array and tensor (and the plans and the text) on
        ``device``; with ``non_blocking``, host arrays go through pinned
        memory and the copies to a card are asynchronous on the current
        stream (see :func:`tdwss_torch.ops.plan._to_tensor`)."""
        out = _move(self, device, non_blocking)
        kw = {f: getattr(self, f).to(device, non_blocking)
              for f in ("plans", "text") if getattr(self, f) is not None}
        return dataclasses.replace(out, **kw)

    def tensors(self) -> Iterator[torch.Tensor]:
        """Every tensor of the batch and its plans."""
        yield from _tensors(self)


def _tensors(obj) -> Iterator[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v)
