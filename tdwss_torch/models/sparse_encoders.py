"""Sparse-conv encoders (twin of :mod:`tdwss.models.sparse_encoders`).

Every encoder runs the scn pipeline over host-built plans: stem
SubmConv(3 -> m) -> a body over one level per plane -> BatchNormReLU ->
per-point readback.  The encoders and their plane schedules:

- ``SparseConvUNet``: UNet body (concat skips, decoder blocks), planes
  m..7m, output width m;
- ``SparseConvFCNet``: FCN body (each level's output concatenated with
  the unpooled output of the level below), planes m..depth*m, output
  width the sum of the planes;
- ``SparseConvFCNetNarrow``: FCN body, planes (m,) + ``n_planes``
  (default 64, 128, 192, 256);
- ``SparseConvFCNetDirectUpPool`` / ``...Light``: direct up-pool body
  (no skips: the unpooled output of the level below replaces the
  level's), planes (m,) + ``n_planes`` (default 64..256 / 32..128),
  output width the last plane.

Module and parameter names follow the flax modules' paths
(``body.inner.enc0.conv1.kernel``), so :mod:`tdwss_torch.convert` maps
flax variables onto this tree one to one.  With ``istrain`` the encoder
returns per-scene features: the count-weighted mean over voxels (the
reference model's mean over points,
``tdwss/models/sparse_encoders.py:270-283``).  Without host plans (the
plans-free branch, ``engine.host_plans: false``) the encoder voxelizes
the points and builds every level's rulebooks on the device
(:func:`tdwss_torch.ops.voxelize.voxelize`,
:func:`tdwss_torch.ops.plan.build_plans`), and its convs run the
rulebook routes.  With ``engine.remat`` the body runs under
``torch.utils.checkpoint`` (one segment, as the reference's ``nn.remat``
over the body): its forward runs again in the backward, and batch norm
updates its running statistics in the first forward only.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from tdwss_torch.config import EngineConfig
from tdwss_torch.models.layers import (BatchNormReLU, Deconv,
                                       NetworkInNetwork, StridedConv,
                                       SubmConv, recomputing)
from tdwss_torch.ops.plan import LevelPlans, build_plans, level_capacities
from tdwss_torch.ops.segment import segment_mean_weighted
from tdwss_torch.ops.sparse_conv import unpool, wg_unpool_apply
from tdwss_torch.ops.voxelize import devoxelize, devoxelize_seg, voxelize
from tdwss_torch.registry import MODEL_REGISTRY
from tdwss_torch.utils import profiling

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


class _DownBody(nn.Module):
    """What the FCN and direct up-pool bodies share: ``reps`` blocks at
    the level's plane, then (below the last level) BatchNormReLU, a
    strided conv to the next plane, the body of the level below, and an
    unpool of its output back to this level.  While a torch profiler
    records, the unpool and the join are the span ``tdwss.unpool``."""

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
            self.inner = type(self)(planes[1:], reps, residual,
                                    kernel_volume, generator)

    def _join(self, identity, unpooled):
        raise NotImplementedError

    def forward(self, feats, plans: LevelPlans, level: int, train: bool):
        lvl = plans.levels[level]
        valid = lvl.grid.valid
        for i in range(self.reps):
            feats = getattr(self, f"enc{i}")(feats, lvl.subm_rb, valid,
                                             train, lvl.win)
        if not self.deep:
            return feats
        h = self.down_bnrelu(feats, valid, train)
        h = self.down_conv(h, lvl.down_rb, lvl.parent, lvl.child_offset,
                           lvl.wg_down, lvl.wg_up)
        h = self.inner(h, plans, level + 1, train)
        with profiling.span("tdwss.unpool"):
            if lvl.wg_up is not None and lvl.wg_down is not None:
                h = wg_unpool_apply(h, lvl.wg_up, lvl.wg_down)
            else:
                h = unpool(h, lvl.parent, fine_valid=valid,
                           down_rb=lvl.down_rb)
            return self._join(feats, h)


class FCNBody(_DownBody):
    """scn.FullyConvolutionalNet: the level's output concatenated with the
    unpooled output of the level below (width: the sum of the planes)."""

    def _join(self, identity, unpooled):
        return torch.cat([identity, unpooled], dim=-1)


class DirectUpPoolBody(_DownBody):
    """The reference FCNEncoder: the unpooled output of the level below
    replaces the level's (width: the last plane)."""

    def _join(self, identity, unpooled):
        return unpooled


def _unet_planes(pc):
    return tuple((i + 1) * pc.m for i in range(7))


def _fcnet_planes(pc):
    return tuple((i + 1) * pc.m for i in range(pc.depth))


def _narrow_planes(default):
    def planes(pc):
        extra = tuple(pc.n_planes) if pc.n_planes else default
        return (pc.m,) + tuple(extra)
    return planes


class EncoderSpec:
    """A registered encoder: its body class, its planes from the config
    (:meth:`planes`) and its output width from the planes
    (:meth:`width`), as the reference's encoder classes define them
    (tdwss/models/sparse_encoders.py:291-343).  The registry's
    ``embed_length`` is the reference's; MultiLabel's head does not read
    it: its flax ``Dense`` takes the encoder's real output width, which
    differs where FCNet's depth is not 7 (smoke_cpu.yaml: depth 3, m=4
    gives 24 against 28m = 112) or Narrow's planes are not the default."""

    body: type = nn.Module

    @staticmethod
    def planes(pc) -> Tuple[int, ...]:
        raise NotImplementedError

    @staticmethod
    def width(planes: Tuple[int, ...]) -> int:
        raise NotImplementedError


@MODEL_REGISTRY.register(embed_length=lambda m: m)
class SparseConvUNet(EncoderSpec):
    body = UNetBody
    planes = staticmethod(_unet_planes)
    width = staticmethod(lambda p: p[0])


@MODEL_REGISTRY.register(embed_length=lambda m: 7 * (7 + 1) * m // 2)
class SparseConvFCNet(EncoderSpec):
    body = FCNBody
    planes = staticmethod(_fcnet_planes)
    width = staticmethod(sum)


@MODEL_REGISTRY.register(embed_length=lambda m: sum([m, 64, 128, 192, 256]))
class SparseConvFCNetNarrow(EncoderSpec):
    body = FCNBody
    planes = staticmethod(_narrow_planes((64, 128, 192, 256)))
    width = staticmethod(sum)


@MODEL_REGISTRY.register(embed_length=lambda m: 256)
class SparseConvFCNetDirectUpPool(EncoderSpec):
    body = DirectUpPoolBody
    planes = staticmethod(_narrow_planes((64, 128, 192, 256)))
    width = staticmethod(lambda p: p[-1])


@MODEL_REGISTRY.register(embed_length=lambda m: 128)
class SparseConvFCNetDirectUpPoolLight(EncoderSpec):
    body = DirectUpPoolBody
    planes = staticmethod(_narrow_planes((32, 64, 96, 128)))
    width = staticmethod(lambda p: p[-1])


def encoder_names() -> Tuple[str, ...]:
    """The registered encoders' names."""
    return tuple(sorted(n for n, (obj, _) in MODEL_REGISTRY
                        if isinstance(obj, type)
                        and issubclass(obj, EncoderSpec)))


def _encoder_entry(name: str):
    spec, _ = MODEL_REGISTRY.get(name)
    if not (isinstance(spec, type) and issubclass(spec, EncoderSpec)):
        raise KeyError(f"'{name}' in '{MODEL_REGISTRY.name}' registry is "
                       f"not a point-cloud encoder")
    return spec


def plane_schedule(pc_config) -> Tuple[int, ...]:
    """The configured encoder's planes, one per level."""
    return tuple(_encoder_entry(pc_config.name).planes(pc_config))


def output_width(pc_config) -> int:
    """Width of the configured encoder's per-voxel output."""
    spec = _encoder_entry(pc_config.name)
    return int(spec.width(spec.planes(pc_config)))


def embed_length_of(name: str, m: int) -> int:
    """The registry's ``embed_length`` of encoder ``name``."""
    _, meta = MODEL_REGISTRY.get(name)
    return meta.get("embed_length", lambda m_: m_)(m)


def plan_spec(pc_config, engine, n_points: int):
    """(num_levels, capacities, downsample) for the configured encoder —
    shared with the host planner so plans match the model's levels (one
    level per plane)."""
    planes = plane_schedule(pc_config)
    schedule = (tuple(engine.level_capacity_schedule)
                if engine.level_capacity_schedule else None)
    caps = level_capacities(engine.max_voxels or n_points, len(planes),
                            engine.level_capacity_shrink,
                            engine.min_level_capacity, schedule)
    return len(planes), caps, tuple(pc_config.downsample)


class SparseEncoder(nn.Module):
    """The scn pipeline around a body: stem SubmConv(in -> m), the body
    over one level per plane, BatchNormReLU, readback (the reference's
    ``_SparseEncoderBase``, tdwss/models/sparse_encoders.py:196-297).

    ``pc_config`` and ``engine`` (the encoder's and the engine's
    configs) give the plans-free branch its capacities
    (:func:`plan_spec`); without them the encoder runs on host plans
    only.  ``remat`` recomputes the body in the backward."""

    def __init__(self, body_cls, planes: Sequence[int], out_width: int,
                 block_reps: int = 1, residual_blocks: bool = False,
                 downsample: Sequence[int] = (2, 2),
                 compute_dtype: str = "float32", in_channels: int = 3,
                 generator: Optional[torch.Generator] = None,
                 pc_config=None, engine=None, remat: bool = False):
        super().__init__()
        self.pc_config, self.engine = pc_config, engine
        self.remat = remat
        if downsample[0] != downsample[1]:
            raise NotImplementedError("filter != stride is not supported")
        self.m = planes[0]
        self.body_planes = tuple(planes)
        self.out_width = out_width
        self.compute_dtype = _DTYPES[compute_dtype]
        self.stem = SubmConv(in_channels, planes[0], 27, generator)
        self.body = body_cls(planes, block_reps, residual_blocks,
                             int(downsample[0]) ** 3, generator)
        self.final_bnrelu = BatchNormReLU(out_width)

    def forward(self, coords, feats, valid, istrain: bool = False,
                train: bool = False, num_scenes: int = 1, plans=None,
                vox_feats=None, point2voxel=None, point_perm=None):
        """Points (and host plans with their voxel features, or none) ->
        per-point features (f32, (N, out_width)), or per-scene features
        (f32, (num_scenes, out_width)) with ``istrain``."""
        if plans is None:
            # InputLayer(mode=4): average the points into voxels, then
            # every level's rulebooks, on the points' device
            if self.pc_config is None:
                raise ValueError("no plans given, and the encoder has no "
                                 "configs to plan on the device: build it "
                                 "with build_sparse_encoder")
            num_levels, caps, downsample = plan_spec(
                self.pc_config, self.engine or EngineConfig(),
                coords.shape[0])
            grid, vox_feats, point2voxel = voxelize(coords, feats, valid,
                                                    caps[0], mode="mean")
            plans = build_plans(grid, num_levels, caps, downsample, 3)
        lvl0 = plans.levels[0]
        h = self.stem(vox_feats.to(self.compute_dtype), lvl0.subm_rb,
                      lvl0.win)
        h = self._run_body(h, plans, train)
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

    def _run_body(self, h, plans, train: bool):
        if not (self.remat and torch.is_grad_enabled()):
            return self.body(h, plans, 0, train)
        # the whole body is recomputed (no early stop), so each of its
        # forward kernels runs twice per training step
        with torch.utils.checkpoint.set_checkpoint_early_stop(False):
            return torch.utils.checkpoint.checkpoint(
                self.body, h, plans, 0, train, use_reentrant=False,
                preserve_rng_state=False,
                context_fn=lambda: (contextlib.nullcontext(), recomputing()))


def build_sparse_encoder(pc_config, compute_dtype: str = "float32",
                         generator: Optional[torch.Generator] = None,
                         engine=None) -> SparseEncoder:
    """The encoder ``pc_config.name`` with its plane schedule, the
    config's ``block_reps``, ``residual_blocks`` and ``downsample``, and
    the capacities of ``engine`` (an ``EngineConfig``; its defaults when
    None) for the plans-free branch."""
    body_cls = _encoder_entry(pc_config.name).body
    return SparseEncoder(body_cls, plane_schedule(pc_config),
                         output_width(pc_config),
                         block_reps=pc_config.block_reps,
                         residual_blocks=pc_config.residual_blocks,
                         downsample=tuple(pc_config.downsample),
                         compute_dtype=compute_dtype, generator=generator,
                         pc_config=pc_config, engine=engine,
                         remat=bool(engine and engine.remat))
