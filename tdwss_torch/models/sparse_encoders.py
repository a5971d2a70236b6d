"""Sparse-conv UNet encoder (twin of :mod:`tdwss.models.sparse_encoders`).

``SparseConvUNet`` runs the scn pipeline over host-built plans:
stem SubmConv(3 -> m) -> UNet body over 7 levels (planes m..7m, concat
skips) -> BatchNormReLU -> per-point readback.  Module and parameter
names follow the flax modules' paths (``body.inner.enc0.conv1.kernel``),
so :mod:`tdwss_torch.convert` maps flax variables onto this tree one to
one.  With ``istrain`` the encoder returns per-scene features: the
count-weighted mean over voxels (the reference model's mean over points,
``tdwss/models/sparse_encoders.py:270-283``).  The plans-free branch
(on-device voxelization) is a later slice.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from tdwss_torch.models.layers import (BatchNormReLU, Deconv,
                                       NetworkInNetwork, StridedConv,
                                       SubmConv)
from tdwss_torch.ops.plan import LevelPlans, level_capacities
from tdwss_torch.ops.segment import segment_mean_weighted
from tdwss_torch.ops.voxelize import devoxelize, devoxelize_seg

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ConvBlock(nn.Module):
    """VGG (BNReLU -> SubmConv) or ResNet (two convs + shortcut) block."""

    def __init__(self, in_channels: int, out_channels: int,
                 residual: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        a, b = in_channels, out_channels
        self.residual = residual
        if not residual:
            self.bnrelu = BatchNormReLU(a)
            self.conv = SubmConv(a, b, 27, generator)
            return
        self.nin = NetworkInNetwork(a, b, generator) if a != b else None
        self.bnrelu1 = BatchNormReLU(a)
        self.conv1 = SubmConv(a, b, 27, generator)
        self.bnrelu2 = BatchNormReLU(b)
        self.conv2 = SubmConv(b, b, 27, generator)

    def forward(self, feats, rulebook, valid, train: bool, win=None):
        if not self.residual:
            return self.conv(self.bnrelu(feats, valid, train), rulebook, win)
        shortcut = feats if self.nin is None else self.nin(feats)
        h = self.bnrelu1(feats, valid, train)
        h = self.conv1(h, rulebook, win)
        h = self.bnrelu2(h, valid, train)
        h = self.conv2(h, rulebook, win)
        return shortcut + h


class UNetBody(nn.Module):
    """scn.UNet: recursive U with concat skip and decoder blocks."""

    def __init__(self, n_planes: Sequence[int], reps: int, residual: bool,
                 kernel_volume: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        planes = tuple(n_planes)
        self.reps = reps
        self.deep = len(planes) > 1
        for i in range(reps):
            self.add_module(f"enc{i}", ConvBlock(planes[0], planes[0],
                                                 residual, generator))
        if self.deep:
            self.down_bnrelu = BatchNormReLU(planes[0])
            self.down_conv = StridedConv(planes[0], planes[1], kernel_volume,
                                         generator)
            self.inner = UNetBody(planes[1:], reps, residual, kernel_volume,
                                  generator)
            self.up_bnrelu = BatchNormReLU(planes[1])
            self.up_deconv = Deconv(planes[1], planes[0], kernel_volume,
                                    generator)
            for i in range(reps):
                cin = 2 * planes[0] if i == 0 else planes[0]
                self.add_module(f"dec{i}", ConvBlock(cin, planes[0],
                                                     residual, generator))

    def forward(self, feats, plans: LevelPlans, level: int, train: bool):
        lvl = plans.levels[level]
        valid = lvl.grid.valid
        for i in range(self.reps):
            feats = getattr(self, f"enc{i}")(feats, lvl.subm_rb, valid,
                                             train, lvl.win)
        if self.deep:
            identity = feats
            h = self.down_bnrelu(feats, valid, train)
            h = self.down_conv(h, lvl.down_rb, lvl.parent, lvl.child_offset,
                               lvl.wg_down, lvl.wg_up)
            h = self.inner(h, plans, level + 1, train)
            h = self.up_bnrelu(h, plans.levels[level + 1].grid.valid, train)
            h = self.up_deconv(h, lvl.parent, lvl.child_offset, valid,
                               lvl.down_rb, lvl.wg_up, lvl.wg_down)
            feats = torch.cat([identity, h], dim=-1)
            for i in range(self.reps):
                feats = getattr(self, f"dec{i}")(feats, lvl.subm_rb, valid,
                                                 train, lvl.win)
        return feats


def unet_planes(m: int) -> Tuple[int, ...]:
    """SparseConvUNet's plane schedule: 7 levels, m..7m (depth is unused,
    as in the reference)."""
    return tuple((i + 1) * m for i in range(7))


def plan_spec(pc_config, engine, n_points: int):
    """(num_levels, capacities, downsample) for the configured encoder —
    shared with the host planner so plans match the model's levels."""
    if pc_config.name != "SparseConvUNet":
        raise NotImplementedError(
            f"encoder {pc_config.name!r} is not ported yet")
    planes = unet_planes(pc_config.m)
    schedule = (tuple(engine.level_capacity_schedule)
                if engine.level_capacity_schedule else None)
    caps = level_capacities(engine.max_voxels or n_points, len(planes),
                            engine.level_capacity_shrink,
                            engine.min_level_capacity, schedule)
    return len(planes), caps, tuple(pc_config.downsample)


class SparseConvUNet(nn.Module):
    """scn.UNet encoder, planes [m..7m] (reference models/SparseConvNet.py:57-71)."""

    def __init__(self, m: int = 16, block_reps: int = 1,
                 residual_blocks: bool = False,
                 downsample: Sequence[int] = (2, 2),
                 compute_dtype: str = "float32", in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if downsample[0] != downsample[1]:
            raise NotImplementedError("filter != stride is not supported")
        self.m = m
        self.compute_dtype = _DTYPES[compute_dtype]
        self.stem = SubmConv(in_channels, m, 27, generator)
        self.body = UNetBody(unet_planes(m), block_reps, residual_blocks,
                             int(downsample[0]) ** 3, generator)
        self.final_bnrelu = BatchNormReLU(m)

    def forward(self, coords, feats, valid, istrain: bool = False,
                train: bool = False, num_scenes: int = 1, plans=None,
                vox_feats=None, point2voxel=None, point_perm=None):
        """Host plans + voxel features -> per-point features (f32, (N, m)),
        or per-scene features (f32, (num_scenes, m)) with ``istrain``."""
        if plans is None:
            raise NotImplementedError(
                "the plans-free branch (on-device voxelization) is not "
                "ported; attach host plans (tdwss_torch.data.plans)")
        lvl0 = plans.levels[0]
        h = self.stem(vox_feats.to(self.compute_dtype), lvl0.subm_rb,
                      lvl0.win)
        h = self.body(h, plans, 0, train)
        h = self.final_bnrelu(h, lvl0.grid.valid, train)
        if istrain:
            # slim plans ship only the scene-id column of grid.coords
            grid = lvl0.grid
            return segment_mean_weighted(h.float(), grid.coords[:, -1],
                                         grid.counts, num_scenes, grid.valid)
        if point_perm is not None:
            return devoxelize_seg(h.float(), point2voxel, point_perm,
                                  lvl0.grid.counts)
        return devoxelize(h.float(), point2voxel)
