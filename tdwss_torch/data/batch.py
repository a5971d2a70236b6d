"""Fixed-capacity point batch (twin of ``tdwss.data.batch.PointBatch``).

Host batches hold numpy arrays (and, after
:func:`tdwss_torch.data.plans.slim_batch_for_train`, a bf16 CPU tensor of
voxel features); :meth:`PointBatch.to` moves every array and tensor (and
the plans) to a torch device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch


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

    @property
    def num_points(self) -> int:
        return self.coords.shape[0]

    @property
    def num_scenes(self) -> int:
        return self.scene_label.shape[0]

    def replace(self, **kw) -> "PointBatch":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "PointBatch":
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                kw[f.name] = torch.from_numpy(
                    np.ascontiguousarray(v)).to(device)
            elif isinstance(v, torch.Tensor):
                kw[f.name] = v.to(device)
            elif f.name == "plans" and v is not None:
                kw[f.name] = v.to(device)
        return dataclasses.replace(self, **kw)
