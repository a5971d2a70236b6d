"""Sparse-voxel layers (twin of :mod:`tdwss.models.layers`).

Each module acts on a (V, C) active-voxel feature matrix plus host-built
plans.  Conventions of scn, kept from the reference:

- convolutions are bias-free, weights ``kernel`` (K, Cin, Cout) with
  He-normal init over fan_in = K * Cin;
- batch norm takes its statistics over valid voxels only, eps 1e-4,
  running averages with momentum 0.9 in the flax convention (new =
  0.9 * old + 0.1 * batch), an unbiased running variance, and zeroes the
  padding rows on output.

Parameters are float32; the convolutions cast them to the features'
compute dtype (bf16 in the bench config).  Initialisation draws from the
``torch.Generator`` the caller passes.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
from torch import nn

from tdwss_torch.ops.sparse_conv import (deconv_apply, strided_conv_apply,
                                         subm_conv_apply, wg_conv_apply)


_state = threading.local()


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype that sums and products over ``dtype`` operands take:
    f32 for bf16 and f32 (the reference's ``preferred_element_type``),
    f64 for f64, so that an f64 step (the yardstick of
    ``tdwss_torch.tools.kpconv_grads``) is f64 all through."""
    return torch.promote_types(dtype, torch.float32)


@contextlib.contextmanager
def recomputing():
    """Mark a checkpointed forward's recomputation in the backward (on
    this thread): batch norm keeps its running statistics there, as the
    first forward has updated them once."""
    prev = getattr(_state, "recomputing", False)
    _state.recomputing = True
    try:
        yield
    finally:
        _state.recomputing = prev


def he_normal(shape, fan_in: int, generator: Optional[torch.Generator]):
    """normal(0, sqrt(2 / fan_in)) drawn on the CPU from ``generator``."""
    return torch.randn(shape, generator=generator) * (2.0 / fan_in) ** 0.5


class _Conv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_volume: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = nn.Parameter(he_normal(
            (kernel_volume, in_channels, out_channels),
            kernel_volume * in_channels, generator))


class SubmConv(_Conv):
    """Submanifold convolution over a fixed coordinate set; ``win``
    (Windowed27) selects the windowed route."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_volume: int = 27,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel_volume, generator)

    def forward(self, feats, rulebook, win=None):
        return subm_conv_apply(feats, rulebook, self.kernel, win)


class StridedConv(_Conv):
    """Downsampling convolution fine -> coarse (scn.Convolution)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_volume: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel_volume, generator)

    def forward(self, fine_feats, down_rb, parent=None, child_offset=None,
                wg_down=None, wg_up=None):
        if wg_down is not None and wg_up is not None:
            return wg_conv_apply(fine_feats, self.kernel, wg_down, wg_up)
        return strided_conv_apply(fine_feats, down_rb, self.kernel, parent,
                                  child_offset)


class Deconv(_Conv):
    """Transposed convolution coarse -> fine (scn.Deconvolution)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_volume: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel_volume, generator)

    def forward(self, coarse_feats, parent, child_offset, fine_valid,
                down_rb=None, wg_up=None, wg_down=None):
        if wg_up is not None and wg_down is not None:
            return wg_conv_apply(coarse_feats, self.kernel, wg_up, wg_down)
        return deconv_apply(coarse_feats, parent, child_offset, self.kernel,
                            fine_valid, down_rb)


class NetworkInNetwork(nn.Module):
    """1x1 channel mixing without bias (scn.NetworkInNetwork)."""

    def __init__(self, in_channels: int, out_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = nn.Parameter(he_normal((in_channels, out_channels),
                                             in_channels, generator))

    def forward(self, feats):
        w = self.kernel.to(feats.dtype).float()
        return (feats.float() @ w).to(feats.dtype)


class MaskedBatchNorm(nn.Module):
    """Batch norm over valid rows (scn defaults: eps 1e-4, momentum 0.9).

    Not ``nn.BatchNorm1d``: padding rows stay out of the statistics and
    come out as zeros, and the running averages follow the flax update
    ``ra = momentum * ra + (1 - momentum) * batch`` with the unbiased
    batch variance (the normalisation uses the biased one).  Inside
    :func:`recomputing` the running averages stay as they are.
    """

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-4):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, feats, valid, use_running_average: bool = True):
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            m = valid.to(acc_dtype(feats.dtype))
            count = torch.clamp(m.sum(), min=1.0)
            xf = feats.to(m.dtype) * m[:, None]
            mean = xf.sum(0) / count
            var = torch.clamp((xf * xf).sum(0) / count - mean * mean,
                              min=0.0)
            if not getattr(_state, "recomputing", False):
                self._update_running(mean, var, count)
        inv = torch.rsqrt(var + self.eps) * self.weight
        out = ((feats.to(acc_dtype(feats.dtype)) - mean) * inv
               + self.bias).to(feats.dtype)
        return torch.where(valid[:, None], out, torch.zeros_like(out))

    def _update_running(self, mean, var, count):
        with torch.no_grad():
            unbiased = var * (count / torch.clamp(count - 1.0, min=1.0))
            self.running_mean.mul_(self.momentum).add_(
                (1 - self.momentum) * mean)
            self.running_var.mul_(self.momentum).add_(
                (1 - self.momentum) * unbiased)


class BatchNormReLU(nn.Module):
    """scn.BatchNormReLU (leakiness 0) / BatchNormLeakyReLU."""

    def __init__(self, num_features: int, leakiness: float = 0.0,
                 momentum: float = 0.9, eps: float = 1e-4):
        super().__init__()
        self.leakiness = leakiness
        self.bn = MaskedBatchNorm(num_features, momentum, eps)

    def forward(self, feats, valid, train: bool):
        h = self.bn(feats, valid, use_running_average=not train)
        if self.leakiness == 0.0:
            return torch.relu(h)
        return nn.functional.leaky_relu(h, negative_slope=self.leakiness)
