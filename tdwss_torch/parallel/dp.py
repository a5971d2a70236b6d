"""Data-parallel training over a ``torch.distributed`` process group
(twin of :mod:`tdwss.parallel.dp`).

Each rank holds the whole model and optimiser and trains on its own
shard of every global batch (:func:`tdwss_torch.data.loader.train_batches`
with ``shard``).  :func:`tdwss_torch.engine.steps.train_step` with a
``group`` calls :func:`average_gradients` and :func:`average_batch_stats`
between the backward and Adam, and so computes what the reference's
``shard_map`` step computes (``make_dp_train_step``,
``make_train_step(pmean_axis=...)``, tdwss/engine/steps.py:85-109):

- forward and backward are local: batch norm normalises with this rank's
  batch statistics (no sync-BN);
- the gradients are averaged over the ranks (``pmean(grads)``), every
  trainable parameter in ``model.parameters()`` order, zeros where a
  parameter has no gradient, in one flat all-reduce;
- every ``MaskedBatchNorm``'s running mean and variance, as this step's
  forward updated them, are averaged over the ranks in one flat
  all-reduce (``pmean(new_stats)``: the average of the updated running
  averages, not a pooled variance);
- the loss and its parts are averaged (``pmean(aux)``) by
  :func:`average_scalars`, which the ``Trainer`` calls once per epoch on
  the epoch's mean loss (the mean over the ranks of per-step means);
- each all-reduce sums the f32 values in f64, where a sum of a few f32
  values is exact but for the rare operands more than 2^29 apart, and
  rounds the mean back to f32 once: so the mean does not depend on the
  order in which the collective adds the ranks (gloo, NCCL and a
  one-process sum in turn give the same f32 bits).  An f32 sum in the
  collective's own order would move Adam's first update of a parameter
  whose gradients nearly cancel across the ranks (the update is
  lr * g / (|g| + eps));
- Adam and the schedule then run on every rank on identical inputs, so
  the parameters stay identical on every rank once
  :func:`broadcast_state` has made them so at the start.

Only ``all_reduce``, ``broadcast`` and ``barrier`` are used: gloo runs
them on CUDA tensors as well (the card check runs several gloo ranks on
one card), and NCCL on several cards.  ``DistributedDataParallel`` is not
used: its default ``broadcast_buffers=True`` would overwrite every rank's
running statistics with rank 0's instead of averaging them.

The reference's window harmonising (``_expand_window``, ``_flatten_sub``,
``_harmonize_residual_caps``, ``stack_batches``, ``shard_batch``,
``make_mesh``) is not ported: it exists only because ``jit`` needs one
stacked shape across devices, and it re-expresses each rank's plan
exactly, so ranks that each run their own plans compute the same numbers.
"""

from __future__ import annotations

import os
from typing import Dict, List

import torch
import torch.distributed as dist

from tdwss_torch.models.layers import MaskedBatchNorm


def dp_device(device) -> torch.device:
    """The device of this rank: an unqualified ``cuda`` means
    ``cuda:LOCAL_RANK`` (the rank where ``LOCAL_RANK`` is unset),
    and that card must exist: two ranks never share a card unless the
    caller names it.  Any other device is taken as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    count = torch.cuda.device_count()
    if local >= count:
        raise RuntimeError(
            f"LOCAL_RANK {local} has no card of its own ({count} visible); "
            "start at most one rank per card, or name the device")
    return torch.device("cuda", local)


def _flat_mean(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """The element-wise mean of ``tensors`` over the ranks, through one
    all-reduce of their values in f64 (see the module docstring); the
    means rounded to f32, flat."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1).double() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat = (flat / dist.get_world_size(group)).float()
    return list(torch.split(flat, [t.numel() for t in tensors]))


def trainable(model: torch.nn.Module) -> List[torch.nn.Parameter]:
    return [p for p in model.parameters() if p.requires_grad]


def batch_stat_buffers(model: torch.nn.Module) -> List[torch.Tensor]:
    """Every ``MaskedBatchNorm``'s running mean and variance, in module
    order: the reference's ``batch_stats`` collection."""
    out = []
    for mod in model.modules():
        if isinstance(mod, MaskedBatchNorm):
            out += [mod.running_mean, mod.running_var]
    return out


def average_gradients(model: torch.nn.Module, group=None) -> None:
    """Replace every trainable parameter's gradient by its mean over the
    ranks; a parameter without one counts as zeros (``pmean`` covers every
    leaf), so every rank reduces the same layout and Adam then updates
    the same parameters on every rank."""
    params = trainable(model)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    for p, g in zip(params, _flat_mean(grads, group)):
        p.grad = g.view_as(p).to(p.dtype)


@torch.no_grad()
def average_batch_stats(model: torch.nn.Module, group=None) -> None:
    """Average every batch norm's running statistics over the ranks."""
    bufs = batch_stat_buffers(model)
    for b, m in zip(bufs, _flat_mean(bufs, group)):
        b.copy_(m.view_as(b))


def average_scalars(aux: Dict[str, torch.Tensor], group=None
                    ) -> Dict[str, torch.Tensor]:
    """The mean over the ranks of each scalar of ``aux`` (sorted keys)."""
    keys = sorted(aux)
    return dict(zip(keys, (m.reshape(()) for m in _flat_mean(
        [aux[k].detach() for k in keys], group))))


@torch.no_grad()
def broadcast_state(model: torch.nn.Module, src: int = 0,
                    group=None) -> None:
    """Give every rank ``src``'s parameters and buffers."""
    for t in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(t.data, src=src, group=group)
