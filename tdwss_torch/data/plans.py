"""Attach host-built sparse-conv plans to a collated batch, and slim a
planned batch for the training step (twin of ``tdwss.data.plans``)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tdwss_torch.config import Config
from tdwss_torch.data.batch import PointBatch
from tdwss_torch.models.meta_arch import model_reads
from tdwss_torch.ops.host_plan import host_voxelize_and_plan


def encoder_plan_spec(cfg: Config, n_points: int):
    """(num_levels, capacities, downsample) for the configured encoder."""
    from tdwss_torch.models.sparse_encoders import plan_spec

    return plan_spec(cfg.pointcloud_model, cfg.engine, n_points)


def _slim_win(win):
    """rb_local travels at the narrowest dtype that holds its values:
    sub-form locals live in [0, subwin] (sentinel == subwin), so with
    subwin <= 255 they fit uint8; flat-form locals (sentinel == window)
    fit int16.  :meth:`tdwss_torch.ops.plan.LevelPlans.to` upcasts them
    to int32 on the device."""
    if win is None:
        return win
    want = np.uint8 if (win.sub and win.subwin <= 255) else np.int16
    if win.rb_local.dtype == want:
        return win
    return win.replace(rb_local=np.asarray(win.rb_local, want))


def slim_plans_for_device(plans):
    """Drop the plan leaves the device never reads.

    Windowed levels never read the global rulebooks (they are inputs to
    the window builders), coarse levels need only ``grid.valid`` and
    level 0 only the scene-id column; zero-row placeholders keep the
    static tap counts.
    """
    new_levels = []
    for i, lvl in enumerate(plans.levels):
        grid = lvl.grid
        subm_rb = lvl.subm_rb
        parent, child_offset, down_rb = lvl.parent, lvl.child_offset, lvl.down_rb
        if lvl.win is not None and subm_rb is not None and subm_rb.shape[0]:
            subm_rb = np.zeros((0, subm_rb.shape[1]), np.int32)
        if lvl.wg_down is not None and lvl.wg_up is not None:
            if down_rb is not None and down_rb.shape[0]:
                down_rb = np.zeros((0, down_rb.shape[1]), np.int32)
            if parent is not None and parent.shape[0]:
                parent = np.zeros((0,), np.int32)
            if child_offset is not None and child_offset.shape[0]:
                child_offset = np.zeros((0,), np.int32)
        if i > 0 and grid.coords.shape[0]:
            grid = grid.replace(coords=np.zeros((0, 4), np.int32),
                                key_hi=np.zeros((0,), np.int32),
                                key_lo=np.zeros((0,), np.int32),
                                counts=np.zeros((0,), np.int32))
        elif grid.key_hi.shape[0]:
            grid = grid.replace(key_hi=np.zeros((0,), np.int32),
                                key_lo=np.zeros((0,), np.int32),
                                coords=np.asarray(grid.coords[:, 3:4],
                                                  np.int16))
        new_levels.append(lvl.replace(
            grid=grid, subm_rb=subm_rb, parent=parent,
            child_offset=child_offset, down_rb=down_rb,
            win=_slim_win(lvl.win),
            wg_down=_slim_win(lvl.wg_down), wg_up=_slim_win(lvl.wg_up)))
    return plans.replace(levels=tuple(new_levels))


def slim_batch_for_train(batch: PointBatch,
                         cfg: Optional[Config] = None) -> PointBatch:
    """Drop the point leaves no training step reads once plans are
    attached, as the reference does (``tdwss/data/plans.py:97-158``).

    ``feats`` and ``point_ids`` become zero-row placeholders; with
    ``cfg``, labels travel as int8 and, under bf16 compute, ``vox_feats``
    as a bf16 CPU tensor.  ``coords`` stays only for models whose step
    reads point coordinates, and ``point2voxel``, ``point_perm``,
    ``point_label`` and ``valid`` only for those that read the point
    leaves or train on pseudo labels
    (:func:`tdwss_torch.models.meta_arch.model_reads`).
    """
    if batch.plans is None:
        return batch
    out = batch.replace(
        feats=np.zeros((0, batch.feats.shape[1]),
                       np.asarray(batch.feats).dtype),
        point_ids=np.zeros((0,), np.asarray(batch.point_ids).dtype))
    if cfg is not None:
        out = out.replace(
            point_label=np.asarray(batch.point_label).astype(np.int8))
        if (cfg.engine.compute_dtype == "bfloat16"
                and out.vox_feats is not None):
            out = out.replace(vox_feats=torch.from_numpy(
                np.asarray(out.vox_feats, np.float32)).to(torch.bfloat16))
    reads_coords, reads_points = (model_reads(cfg.model_name)
                                  if cfg is not None else (False, True))
    if not reads_coords:
        out = out.replace(coords=np.zeros(
            (0, batch.coords.shape[1]), np.asarray(batch.coords).dtype))
    if cfg is not None and cfg.label != "pseudo" and not reads_points:
        out = out.replace(
            point2voxel=np.zeros((0,), np.int32),
            point_perm=np.zeros((0,), np.int32),
            point_label=np.zeros((0,), np.asarray(out.point_label).dtype),
            valid=np.zeros((0,), np.asarray(out.valid).dtype))
    return out


def attach_host_plans(batch: PointBatch, cfg: Config,
                      slim: bool = True) -> PointBatch:
    """Return the batch with plans / vox_feats / point2voxel / point_perm
    filled in (numpy).  No-op if the batch already carries plans."""
    if batch.plans is not None:
        return batch
    coords = np.asarray(batch.coords)
    num_levels, caps, downsample = encoder_plan_spec(cfg, coords.shape[0])
    plans, vox_feats, p2v, perm = host_voxelize_and_plan(
        coords, np.asarray(batch.feats), np.asarray(batch.valid),
        num_levels, caps, downsample)
    if slim and cfg.engine.slim_device_plans:
        plans = slim_plans_for_device(plans)
    return batch.replace(plans=plans, vox_feats=vox_feats, point2voxel=p2v,
                         point_perm=perm)
