"""Blocks of the KPConv backbone (twin of :mod:`tdwss.models.kpconv.blocks`).

``nn.Module``s on top of :mod:`tdwss_torch.models.kpconv.ops`: the
kernel-point convolution layer (rigid, deformable, modulated), batch norm
over the valid rows, the unary (linear + BN + LeakyReLU) block, the
simple and ResNet-bottleneck KPConv blocks, the max-pool, nearest
upsample and global average blocks, and :func:`block_decider`.  Every
block takes (features, :class:`KPBatch`, train) and returns (features,
auxes); a deformable conv's aux (``KPConvAux``, extent) feeds the fitting
regularizer.

Unlike flax, a torch module needs its input width when it is built, so
every block takes ``in_dim``.  Child and parameter names follow the flax
modules' (``KPConv.weights``, ``KPConv.offset_conv``, ``bn.bn``,
``mlp``), so :mod:`tdwss_torch.convert` maps the reference's variables
onto this tree.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tdwss_torch.models.kpconv.kernel_points import load_kernels
from tdwss_torch.models.kpconv.ops import (KPConvAux, closest_pool,
                                           global_average, kpconv_apply,
                                           max_pool)
from tdwss_torch.models.layers import MaskedBatchNorm


class KPBatch(NamedTuple):
    """Static-shape multi-layer input pyramid.

    Per layer l: points[l] (Nl, 3) with padding rows at SHADOW_COORD;
    neighbors[l] (Nl, n); pools[l] (N_{l+1}, n) indices into layer l;
    upsamples[l] (Nl, n) indices into layer l+1 (valid for l < L-1);
    batch_ids[l] (Nl,) scene index; valids[l] (Nl,) bool.  Shadow
    neighbour entries hold the layer's row capacity (out of bounds).
    :func:`~tdwss_torch.models.kpconv.pyramid.segmentation_inputs` fills
    it with numpy arrays; :meth:`to` makes tensors on a device.
    """

    points: Tuple
    neighbors: Tuple
    pools: Tuple
    upsamples: Tuple
    batch_ids: Tuple
    valids: Tuple
    features: object
    labels: object
    num_scenes: int

    def to(self, device, non_blocking: bool = False) -> "KPBatch":
        """Every array as a tensor on ``device`` (indices as int64)."""

        def put(a):
            t = torch.as_tensor(a)
            if t.dtype == torch.int32:
                t = t.long()
            return t.to(device, non_blocking=non_blocking)

        def each(arrays):
            return tuple(put(a) for a in arrays)

        return KPBatch(
            points=each(self.points), neighbors=each(self.neighbors),
            pools=each(self.pools), upsamples=each(self.upsamples),
            batch_ids=each(self.batch_ids), valids=each(self.valids),
            features=put(self.features), labels=put(self.labels),
            num_scenes=self.num_scenes)


def _kp_init(shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Kaiming-uniform over fan_in = K * Cin."""
    k, cin, _ = shape
    bound = float(np.sqrt(6.0 / (k * cin)))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def _dense(in_dim: int, out_dim: int,
           generator: Optional[torch.Generator]) -> nn.Linear:
    """``nn.Linear`` without bias, flax ``Dense``'s LeCun-normal init
    (truncated at two standard deviations)."""
    lin = nn.Linear(in_dim, out_dim, bias=False)
    std = (1.0 / in_dim) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        w = torch.randn((out_dim, in_dim), generator=generator)
        while True:
            bad = w.abs() > 2.0
            if not bad.any():
                break
            w[bad] = torch.randn(int(bad.sum()), generator=generator)
        lin.weight.copy_(w * std)
    return lin


class KPConvLayer(nn.Module):
    """One kernel-point convolution; ``deformable`` adds the offset conv
    (a rigid KPConv to 3K offsets, or 4K with ``modulated``) and its
    ``offset_bias``."""

    def __init__(self, in_channels: int, out_channels: int, radius: float,
                 kp_extent: float, num_kernel_points: int = 15,
                 influence: str = "linear", aggregation: str = "sum",
                 fixed_kernel_points: str = "center",
                 deformable: bool = False, modulated: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k = num_kernel_points
        self.kp_extent = kp_extent
        self.influence = influence
        self.aggregation = aggregation
        self.deformable = deformable
        self.modulated = modulated
        self.num_kernel_points = k
        self.register_buffer("kernel_points", torch.from_numpy(load_kernels(
            radius, k, dimension=3, fixed=fixed_kernel_points)),
            persistent=False)
        self.weights = nn.Parameter(_kp_init((k, in_channels, out_channels),
                                             generator))
        if deformable:
            offset_dim = (4 if modulated else 3) * k
            self.offset_conv = KPConvLayer(
                in_channels, offset_dim, radius, kp_extent, k, influence,
                aggregation, fixed_kernel_points, generator=generator)
            self.offset_bias = nn.Parameter(torch.zeros(offset_dim))

    def forward(self, q_pts, s_pts, neighb_inds, x
                ) -> Tuple[torch.Tensor, KPConvAux]:
        k = self.num_kernel_points
        offsets = modulations = None
        if self.deformable:
            raw, _ = self.offset_conv(q_pts, s_pts, neighb_inds, x)
            raw = raw + self.offset_bias
            if self.modulated:
                unscaled = raw[:, : 3 * k].reshape(-1, k, 3)
                modulations = 2.0 * torch.sigmoid(raw[:, 3 * k:])
            else:
                unscaled = raw.reshape(-1, k, 3)
            offsets = unscaled * self.kp_extent
        return kpconv_apply(
            q_pts, s_pts, neighb_inds, x, self.kernel_points, self.weights,
            kp_extent=self.kp_extent, influence=self.influence,
            aggregation=self.aggregation, offsets=offsets,
            modulations=modulations)


class BatchNormBlock(nn.Module):
    """Batch norm over the valid rows (momentum ``bn_momentum`` in the
    torch convention, eps 1e-5), or a learned bias when BN is off."""

    def __init__(self, num_features: int, use_bn: bool = True,
                 bn_momentum: float = 0.98):
        super().__init__()
        self.use_bn = use_bn
        if use_bn:
            self.bn = MaskedBatchNorm(num_features,
                                      momentum=1.0 - bn_momentum, eps=1e-5)
        else:
            self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x, valid, train: bool):
        if self.use_bn:
            return self.bn(x, valid, use_running_average=not train)
        return x + self.bias


class UnaryBlock(nn.Module):
    """Linear (no bias) + BN + LeakyReLU(0.1)."""

    def __init__(self, in_dim: int, out_dim: int, use_bn: bool = True,
                 bn_momentum: float = 0.98, no_relu: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.no_relu = no_relu
        self.mlp = _dense(in_dim, out_dim, generator)
        self.bn = BatchNormBlock(out_dim, use_bn, bn_momentum)

    def forward(self, x, valid, train: bool):
        x = self.bn(self.mlp(x), valid, train)
        if not self.no_relu:
            x = nn.functional.leaky_relu(x, 0.1)
        return x


def _layer_io(batch: KPBatch, layer_ind: int, strided: bool):
    """(q_pts, s_pts, neighb_inds, out_layer) for a conv at this layer."""
    if strided:
        return (batch.points[layer_ind + 1], batch.points[layer_ind],
                batch.pools[layer_ind], layer_ind + 1)
    return (batch.points[layer_ind], batch.points[layer_ind],
            batch.neighbors[layer_ind], layer_ind)


def _kpconv(block_name: str, in_dim: int, out_dim: int, radius: float,
            extent: float, cfg, generator) -> KPConvLayer:
    return KPConvLayer(
        in_dim, out_dim, radius, extent, cfg.num_kernel_points,
        cfg.KP_influence, cfg.aggregation_mode, cfg.fixed_kernel_points,
        deformable="deform" in block_name, modulated=cfg.modulated,
        generator=generator)


class SimpleBlock(nn.Module):
    """KPConv -> BN -> LeakyReLU, out_dim // 2 channels."""

    def __init__(self, block_name: str, in_dim: int, out_dim: int,
                 radius: float, layer_ind: int, config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config
        self.layer_ind = layer_ind
        self.strided = "strided" in block_name
        self.extent = radius * cfg.KP_extent / cfg.conv_radius
        self.KPConv = _kpconv(block_name, in_dim, out_dim // 2, radius,
                              self.extent, cfg, generator)
        self.bn = BatchNormBlock(out_dim // 2, cfg.use_batch_norm,
                                 cfg.batch_norm_momentum)

    def forward(self, x, batch: KPBatch, train: bool
                ) -> Tuple[torch.Tensor, List]:
        q, s, inds, out_l = _layer_io(batch, self.layer_ind, self.strided)
        out, aux = self.KPConv(q, s, inds, x)
        out = self.bn(out, batch.valids[out_l], train)
        auxes = [(aux, self.extent)] if aux.min_d2 is not None else []
        return nn.functional.leaky_relu(out, 0.1), auxes


class ResnetBottleneckBlock(nn.Module):
    """unary -> KPConv -> unary with a (max-pooled) shortcut."""

    def __init__(self, block_name: str, in_dim: int, out_dim: int,
                 radius: float, layer_ind: int, config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config
        self.layer_ind = layer_ind
        self.strided = "strided" in block_name
        self.extent = radius * cfg.KP_extent / cfg.conv_radius
        use_bn, mom = cfg.use_batch_norm, cfg.batch_norm_momentum
        q = out_dim // 4
        if in_dim != q:
            self.unary1 = UnaryBlock(in_dim, q, use_bn, mom,
                                     generator=generator)
        self.KPConv = _kpconv(block_name, q, q, radius, self.extent, cfg,
                              generator)
        self.bn_conv = BatchNormBlock(q, use_bn, mom)
        self.unary2 = UnaryBlock(q, out_dim, use_bn, mom, no_relu=True,
                                 generator=generator)
        if in_dim != out_dim:
            self.unary_shortcut = UnaryBlock(in_dim, out_dim, use_bn, mom,
                                             no_relu=True,
                                             generator=generator)

    def forward(self, x, batch: KPBatch, train: bool
                ) -> Tuple[torch.Tensor, List]:
        q, s, inds, out_l = _layer_io(batch, self.layer_ind, self.strided)
        valid_out = batch.valids[out_l]
        h = x
        if hasattr(self, "unary1"):
            h = self.unary1(h, batch.valids[self.layer_ind], train)
        h, aux = self.KPConv(q, s, inds, h)
        h = nn.functional.leaky_relu(self.bn_conv(h, valid_out, train), 0.1)
        h = self.unary2(h, valid_out, train)
        shortcut = max_pool(x, inds) if self.strided else x
        if hasattr(self, "unary_shortcut"):
            shortcut = self.unary_shortcut(shortcut, valid_out, train)
        auxes = [(aux, self.extent)] if aux.min_d2 is not None else []
        return nn.functional.leaky_relu(h + shortcut, 0.1), auxes


class MaxPoolBlock(nn.Module):
    """Max pool to the next layer."""

    def __init__(self, layer_ind: int):
        super().__init__()
        self.layer_ind = layer_ind

    def forward(self, x, batch: KPBatch, train: bool):
        return max_pool(x, batch.pools[self.layer_ind]), []


class NearestUpsampleBlock(nn.Module):
    """Closest-neighbour upsample to the previous layer."""

    def __init__(self, layer_ind: int):
        super().__init__()
        self.layer_ind = layer_ind

    def forward(self, x, batch: KPBatch, train: bool):
        return closest_pool(x, batch.upsamples[self.layer_ind - 1]), []


class GlobalAverageBlock(nn.Module):
    """Per-cloud average over the last layer."""

    def forward(self, x, batch: KPBatch, train: bool):
        return global_average(x, batch.batch_ids[-1], batch.valids[-1],
                              batch.num_scenes), []


class _UnaryAdapter(nn.Module):
    """UnaryBlock with the (x, batch, train) block calling convention."""

    def __init__(self, in_dim: int, out_dim: int, config, layer_ind: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layer_ind = layer_ind
        self.unary = UnaryBlock(in_dim, out_dim, config.use_batch_norm,
                                config.batch_norm_momentum,
                                generator=generator)

    def forward(self, x, batch: KPBatch, train: bool):
        return self.unary(x, batch.valids[self.layer_ind], train), []


def block_decider(block_name: str, radius: float, in_dim: int, out_dim: int,
                  layer_ind: int, config,
                  generator: Optional[torch.Generator] = None) -> nn.Module:
    """Name -> block module."""
    if block_name == "unary":
        return _UnaryAdapter(in_dim, out_dim, config, layer_ind, generator)
    if block_name.startswith("simple"):
        return SimpleBlock(block_name, in_dim, out_dim, radius, layer_ind,
                           config, generator)
    if block_name.startswith("resnetb"):
        return ResnetBottleneckBlock(block_name, in_dim, out_dim, radius,
                                     layer_ind, config, generator)
    if block_name in ("max_pool", "max_pool_wide"):
        return MaxPoolBlock(layer_ind)
    if block_name == "global_average":
        return GlobalAverageBlock()
    if block_name == "nearest_upsample":
        return NearestUpsampleBlock(layer_ind)
    raise ValueError(f"unknown block name {block_name!r}")


def block_out_dim(block_name: str, in_dim: int, out_dim: int) -> int:
    """Output width of the block ``block_decider`` builds."""
    if block_name.startswith("simple"):
        return out_dim // 2
    if block_name == "unary" or block_name.startswith("resnetb"):
        return out_dim
    return in_dim
