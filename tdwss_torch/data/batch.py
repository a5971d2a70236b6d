"""Fixed-capacity point batch (twin of ``tdwss.data.batch.PointBatch``,
``TextBatch`` and ``BoxBatch``).

Host batches hold numpy arrays (and, after
:func:`tdwss_torch.data.plans.slim_batch_for_train`, a bf16 CPU tensor of
voxel features); :meth:`PointBatch.to` moves every array and tensor (and
the plans, the text and the boxes) to a torch device.
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


def _host(a) -> np.ndarray:
    """A numpy array of an array or a tensor on any device."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclass
class BoxBatch:
    """GSS proposal boxes and the inverse augmentation of each scene
    (the reference trainMerge's ``boxes`` and ``transform``, padded):
    boxes (B, K, 6) float32 [centre xyz, extent xyz] in world space;
    valid (B, K) bool, the real proposals; align (B, 4, 4) float32, the
    scan's axis-align matrix; center (B, 3) float32, the mean subtracted
    in prep; rot_inv (B, 3, 3) float32, the inverse of the augmentation's
    rotation; offset (B, 3) float32, its translation."""

    boxes: Any
    valid: Any
    align: Any
    center: Any
    rot_inv: Any
    offset: Any

    def to(self, device, non_blocking: bool = False) -> "BoxBatch":
        return _move(self, device, non_blocking)

    def concat_boxes(self) -> np.ndarray:
        """(M, 7) [centre, extent, scene index] over the valid rows: the
        reference's concatenated layout (:func:`crop_box`'s input)."""
        boxes = _host(self.boxes)
        b, k, _ = boxes.shape
        scene = np.repeat(np.arange(b, dtype=np.float32), k)
        flat = boxes.reshape(b * k, 6)
        keep = _host(self.valid).reshape(b * k)
        return np.concatenate([flat, scene[:, None]], axis=1)[keep]

    def transform_tuple(self):
        """(align, centers, rot_inv, offsets) as numpy arrays:
        :func:`crop_box`'s ``transform``."""
        return (_host(self.align), _host(self.center), _host(self.rot_inv),
                _host(self.offset))


@dataclass
class PointBatch:
    """coords (N, 4) int32 [x, y, z, scene]; feats (N, C); valid (N,) bool;
    scene_label (B, 20); scene_mask (B,); point_label (N,); point_ids (N,)
    global val-point index (-1 unused); plans / vox_feats (V0, C) /
    point2voxel (N,) / point_perm (N,) from the host planner; text, the
    descriptions' tokens; box, the GSS proposals and the inverse
    augmentation (``pointcloud_data.with_boxes``)."""

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
    box: Optional[BoxBatch] = None

    @property
    def num_points(self) -> int:
        return self.coords.shape[0]

    @property
    def num_scenes(self) -> int:
        return self.scene_label.shape[0]

    def replace(self, **kw) -> "PointBatch":
        return dataclasses.replace(self, **kw)

    def to(self, device, non_blocking: bool = False) -> "PointBatch":
        """Every array and tensor (and the plans, the text and the box) on
        ``device``; with ``non_blocking``, host arrays go through pinned
        memory and the copies to a card are asynchronous on the current
        stream (see :func:`tdwss_torch.ops.plan._to_tensor`)."""
        out = _move(self, device, non_blocking)
        kw = {f: getattr(self, f).to(device, non_blocking)
              for f in ("plans", "text", "box")
              if getattr(self, f) is not None}
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
