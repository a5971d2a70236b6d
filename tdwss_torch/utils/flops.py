"""Compute-cost accounting (twin of :mod:`tdwss.utils.flops`).

The reference reads MegaMulAdd from XLA's cost analysis of the compiled
step (flops / 2 per scene).  No PyTorch counter sees the port's
hand-written kernels, so the port counts the multiply-adds of its step
from the plans and the module tree, without running anything:

- every convolution: the rows of its output level's capacity (padding
  included, as the kernels and XLA see padded shapes) x its taps x Cin x
  Cout, once for the forward and, in a training step, once for dW and
  once for dfeats (none for the stem, whose input needs no gradient);
- the windowed unpool (identity weights through K1): rows x taps x C x
  C forward and, in training, again for its backward; the rulebook
  unpool is a gather and counts nothing;
- the dense layers: ``NetworkInNetwork`` (level rows), the heads (scene
  rows in the scene-level training forward, point rows otherwise) and
  the text tower's linear layers (every token row; its attention
  products are not counted), x3 in training where they take gradients.

The spill tiers' entries beyond the windows, batch norm, the losses and
Adam are not counted; the reference's figure counts every op of the
compiled step, so the two differ.
"""

from __future__ import annotations

import torch
from torch import nn

from tdwss_torch.config import EngineConfig
from tdwss_torch.models.sparse_encoders import (DirectUpPoolBody, FCNBody,
                                                plan_spec)


def param_count(model: torch.nn.Module) -> int:
    """#classifier parameters (reference train.py:44)."""
    return sum(p.numel() for p in model.parameters())


def _block_width(block) -> int:
    conv = block.conv if hasattr(block, "conv") else block.conv2
    return int(conv.kernel.shape[2])


def _body_width(body) -> int:
    """Output width of an encoder body (the level's own or the join)."""
    own = _block_width(getattr(body, f"enc{body.reps - 1}"))
    if not body.deep:
        return own
    if isinstance(body, FCNBody):
        return own + _body_width(body.inner)
    if isinstance(body, DirectUpPoolBody):
        return _body_width(body.inner)
    return _block_width(getattr(body, f"dec{body.reps - 1}"))


def _conv(rows: int, kernel: torch.Tensor, train: bool,
          dfeats: bool = True) -> int:
    k, cin, cout = kernel.shape
    passes = 1 + (train * (2 if dfeats else 1))
    return passes * int(rows) * int(k) * int(cin) * int(cout)


def encoder_mul_adds(encoder, plans, train: bool = True,
                     n_points: int = 0) -> int:
    """Multiply-adds of a sparse encoder's convolutions and NINs on
    ``plans`` (see the module docstring); without plans (the plans-free
    branch) on the capacities it plans ``n_points`` points with."""
    if plans is None:
        _, rows, _ = plan_spec(encoder.pc_config,
                               encoder.engine or EngineConfig(), n_points)
        levels = [None] * len(rows)
    else:
        levels = plans.levels
        rows = [lvl.grid.valid.shape[0] for lvl in levels]
    total = _conv(rows[0], encoder.stem.kernel, train, dfeats=False)
    body, i = encoder.body, 0
    while True:
        lvl = levels[i]
        blocks = [getattr(body, f"enc{j}") for j in range(body.reps)]
        if body.deep and hasattr(body, "dec0"):
            blocks += [getattr(body, f"dec{j}") for j in range(body.reps)]
        for blk in blocks:
            for name in ("conv", "conv1", "conv2"):
                if hasattr(blk, name):
                    total += _conv(rows[i], getattr(blk, name).kernel, train)
            if getattr(blk, "nin", None) is not None:
                a, b = blk.nin.kernel.shape
                total += (3 if train else 1) * rows[i] * int(a) * int(b)
        if not body.deep:
            return total
        total += _conv(rows[i + 1], body.down_conv.kernel, train)
        if hasattr(body, "up_deconv"):
            total += _conv(rows[i], body.up_deconv.kernel, train)
        elif (lvl is not None and lvl.wg_up is not None
              and lvl.wg_down is not None):
            c = _body_width(body.inner)
            taps = int(lvl.wg_up.rb_local.shape[1])
            total += (2 if train else 1) * rows[i] * taps * c * c
        body, i = body.inner, i + 1


def _linear(lin: nn.Linear, rows: int, train: bool) -> int:
    passes = 3 if train and lin.weight.requires_grad else 1
    return passes * int(rows) * lin.in_features * lin.out_features


def step_mul_adds(model, batch, train: bool = True) -> int:
    """Multiply-adds of one step of a port model on ``batch`` (a
    ``PointBatch``): the forward, and with ``train`` the training step's
    forward and backward."""
    point_rows = batch.valid.shape[0]
    total = encoder_mul_adds(model.pc_encoder, batch.plans, train,
                             point_rows)
    scene_head = train and not getattr(model, "reads_point_leaves", False)
    total += _linear(model.linear, batch.num_scenes if scene_head
                     else point_rows, train)
    text = getattr(batch, "text", None)
    if train and hasattr(model, "text_encoder") and text is not None \
            and text.tokens.shape[0] > 0:
        slots = text.tokens.shape[0] * text.tokens.shape[1]
        for mod in model.text_encoder.modules():
            if isinstance(mod, nn.Linear):
                total += _linear(mod, slots * text.tokens.shape[2], train)
        total += _linear(model.text_linear, slots, train)
    return total


def mega_mul_add(model, batch, per: int = 1, train: bool = True) -> float:
    """MegaMulAdd of one step per ``per`` scenes (the reference's
    flops / 2 / 1e6 / per)."""
    return step_mul_adds(model, batch, train) / 1e6 / max(per, 1)
