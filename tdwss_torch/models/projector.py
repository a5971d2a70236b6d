"""Box projector (twin of :mod:`tdwss.models.projector`): crop GSS boxes,
matte, voxelize, max-project to 2D views.

- :func:`crop_box` (host numpy, f64 as in the reference): undo the train
  augmentation (offset, rotation, recentre, axis-align) and crop the
  points to each proposal box, normalised into the unit cube;
- :class:`MattingModule`: the per-point linear matting head;
- :func:`voxelize_views`: the mean of each voxel's points
  (:func:`tdwss_torch.ops.voxelize.voxelize`, mode ``mean``) max-projected
  along H, W and Z by a scatter-max into one image row per (box, pixel)
  plus a dump row for the invalid voxels; a pixel no voxel reaches is 0;
- :class:`Projector` and :func:`project_from_batch`, which runs the head
  from a train batch that carries a :class:`~tdwss_torch.data.batch.BoxBatch`.

The scatter-max fills with ``finfo.min`` and includes it, as the
reference's ``.at[].max`` does, so the gradient of tied maxima is split
evenly among them in both packages.  :func:`project_from_batch` gathers
the cropped points' features on the projector's device, so the gradient
reaches per-point features that arrive as a tensor.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tdwss_torch.data.batch import _host
from tdwss_torch.device import resolve_device
from tdwss_torch.models.transformer import normal_linear
from tdwss_torch.ops.voxelize import voxelize


def crop_rows(coords: np.ndarray, boxes: np.ndarray,
              transform: Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]
              ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`crop_box`'s coordinates and, in place of the features, the
    row of ``coords`` each cropped point came from.  Each scene's points
    are taken back to world space once, for all of its boxes (the
    reference does it per box, with the same operations)."""
    axis_align, centers, rot_inv, offsets = transform
    coords_pool: List[np.ndarray] = []
    rows_pool: List[np.ndarray] = []
    world = {}
    for bid, box in enumerate(boxes):
        centre, length = box[:3], box[3:6]
        mn, mx = centre - length / 2, centre + length / 2
        b = int(box[-1])
        if b not in world:
            sel = coords[:, -1] == b
            pc = coords[sel, :3].astype(np.float64)
            pc = (pc - offsets[b]) @ rot_inv[b] + centers[b]
            pc = np.concatenate([pc, np.ones((pc.shape[0], 1))], -1) \
                @ axis_align[b].T
            world[b] = (np.nonzero(sel)[0], pc)
        scene_rows, pc = world[b]
        inside = np.all(pc[:, :3] >= mn, -1) & np.all(pc[:, :3] <= mx, -1)
        if not inside.any():
            continue
        crop = pc[inside, :3]
        crop -= crop.min(0)
        crop /= np.maximum(crop.max(0), 1e-9)
        out = np.concatenate(
            [crop, np.full((crop.shape[0], 1), bid, np.float64)], -1)
        coords_pool.append(out.astype(np.float32))
        rows_pool.append(scene_rows[inside])
    if not coords_pool:
        return np.zeros((0, 4), np.float32), np.zeros((0,), np.int64)
    return np.concatenate(coords_pool), np.concatenate(rows_pool)


def crop_box(coords: np.ndarray, feats: np.ndarray, boxes: np.ndarray,
             transform: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Crop augmented grid points, back in world space, to proposal boxes.

    coords (N, 4) [x, y, z, batch] grid coordinates; feats (N, C); boxes
    (M, 7) [centre xyz, extent xyz, batch]; transform = (axis_align
    (B, 4, 4), centers (B, 3), rot_inv (B, 3, 3), offsets (B, 3)).
    Returns (coords (N', 4) [xyz normalised to [0, 1], box index],
    feats (N', C)).
    """
    crop, rows = crop_rows(coords, boxes, transform)
    if rows.shape[0] == 0:
        return crop, np.zeros((0, feats.shape[1]), feats.dtype)
    return crop, feats[rows]


class MattingModule(nn.Module):
    """Per-point linear matting head (reference components.py:54-62):
    ``model`` is flax's ``matting/model`` Dense."""

    def __init__(self, in_channels: int, out_channels: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.model = normal_linear(in_channels, out_channels,
                                   (1.0 / in_channels) ** 0.5, generator)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.model(feats)


_AXES = {"H": 0, "W": 1, "Z": 2}


def voxelize_views(coords: torch.Tensor, feats: torch.Tensor,
                   valid: torch.Tensor, resolution: int, num_boxes: int,
                   view: str = "HWZ") -> torch.Tensor:
    """Voxel means max-projected along the axes of ``view``.

    coords (N, 4) with xyz in [0, 1] and the box index; feats (N, C);
    valid (N,) bool.  Returns (len(view) * num_boxes, C, res, res).
    """
    res = int(resolution)
    grid_coords = torch.cat(
        [torch.clamp((coords[:, :3] * res).to(torch.int32), 0, res - 1),
         coords[:, 3:4].to(torch.int32)], dim=1)
    grid, vfeats, _ = voxelize(grid_coords, feats, valid, coords.shape[0])
    c = feats.shape[1]
    neg = torch.finfo(vfeats.dtype).min
    pixels = num_boxes * res * res
    gc = grid.coords.long()
    views = []
    for v in view:
        a = _AXES[v]
        u, w = (d for d in range(3) if d != a)
        flat = gc[:, 3] * (res * res) + gc[:, u] * res + gc[:, w]
        flat = torch.where(grid.valid, flat, torch.full_like(flat, pixels))
        img = torch.full((pixels + 1, c), neg, dtype=vfeats.dtype,
                         device=vfeats.device)
        img = img.scatter_reduce(0, flat[:, None].expand(-1, c), vfeats,
                                 "amax", include_self=True)[:pixels]
        img = torch.where(img == neg, torch.zeros_like(img), img)
        views.append(img.reshape(num_boxes, res, res, c).permute(0, 3, 1, 2))
    return torch.cat(views, dim=0)


class Projector(nn.Module):
    """crop -> matting -> voxelize / max-project (reference
    projector.py:6-19).  ``in_channels`` is the width of the per-point
    features (flax infers it at ``init``)."""

    def __init__(self, in_channels: int, out_channels: int = 2,
                 resolution: int = 256, view: str = "HWZ", seed: int = 0,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.resolution = int(resolution)
        self.view = view
        self.matting = MattingModule(in_channels, out_channels, gen)
        self.to(dev)

    def forward(self, coords: torch.Tensor, feats: torch.Tensor,
                valid: torch.Tensor, num_boxes: int) -> torch.Tensor:
        """coords (N, 4) cropped and normalised (:func:`crop_box`)."""
        matted = self.matting(feats)
        return voxelize_views(coords, matted, valid, self.resolution,
                              num_boxes, self.view)


def project_from_batch(batch, feats, projector: Projector) -> torch.Tensor:
    """The :class:`Projector` head over a train batch that carries a
    ``BoxBatch`` (``pointcloud_data.with_boxes``): the padded boxes back
    in the reference's (M, 7) layout with the transform quartet, the crop
    on the host, the render on the projector's device.

    feats (N, C): per-point features aligned with ``batch.coords``, a
    numpy array or a tensor (the gradient reaches a tensor's rows).
    Returns (len(view) * M, C_out, res, res).
    """
    if batch.box is None:
        raise ValueError(
            "batch has no BoxBatch; set pointcloud_data.with_boxes")
    dev = next(projector.parameters()).device
    boxes = batch.box.concat_boxes()
    keep = np.nonzero(_host(batch.valid))[0]
    crop, rows = crop_rows(_host(batch.coords)[keep], boxes,
                           batch.box.transform_tuple())
    feats = (feats if isinstance(feats, torch.Tensor)
             else torch.from_numpy(np.asarray(feats))).to(dev)
    num_boxes = max(int(boxes.shape[0]), 1)
    if crop.shape[0] == 0:
        return projector(torch.zeros((1, 4), device=dev),
                         torch.zeros((1, feats.shape[1]), device=dev),
                         torch.zeros((1,), dtype=torch.bool, device=dev),
                         num_boxes)
    crop_feats = feats[torch.from_numpy(keep[rows]).to(dev)]
    return projector(torch.from_numpy(crop).to(dev), crop_feats,
                     torch.ones((crop.shape[0],), dtype=torch.bool,
                                device=dev), num_boxes)
