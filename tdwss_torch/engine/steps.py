"""Train step, eval step and vote accumulation (twin of
``tdwss.engine.steps``).

The training iteration of the reference (train.py:55-81): forward with
``istrain=True`` (batch norm in train mode, its running statistics
updated), the scene-level Classification loss (plus the point-level
cross-entropy on the pseudo labels in the pseudo-label round, plus
``TextContrastive`` for text configs that ask for it), backward
through the kernels, an Adam step and the StepLR schedule by epoch.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from tdwss_torch.config import Config
from tdwss_torch.data.batch import PointBatch
from tdwss_torch.parallel import dp
from tdwss_torch.utils.losses import Classification, TextContrastive


def make_lr_schedule(cfg: Config, steps_per_epoch: int
                     ) -> Callable[[int], float]:
    """Learning rate at a step: Adam(1e-3) + StepLR(step_size=100 epochs,
    gamma=0.1) parity, the epoch being ``step // steps_per_epoch``."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return cfg.lr * (cfg.lr_decay_gamma ** (epoch // cfg.lr_decay_epochs))

    return schedule


def make_optimizer(cfg: Config, model: torch.nn.Module,
                   steps_per_epoch: int):
    """``(torch.optim.Adam, LambdaLR)`` over the model's parameters:
    betas (0.9, 0.999) and eps 1e-8 outside the square root, as optax's
    ``adam``; the scheduler steps once per training step."""
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr,
                           betas=(0.9, 0.999), eps=1e-8)
    schedule = make_lr_schedule(cfg, steps_per_epoch)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: schedule(step) / cfg.lr)
    return opt, sched


def text_mask(text) -> torch.Tensor:
    """(B', T) bool: the description slots that count in the text loss,
    those of scenes with texts (``valid``) holding a token."""
    return text.valid[:, None] & (text.tokens != 0).any(dim=-1)


def compute_loss(cfg: Config, model, batch: PointBatch
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, aux scalars) of one forward in training mode."""
    out, meta = model(batch, istrain=True)
    loss = torch.zeros((), dtype=torch.float32, device=out.device)
    aux = {}
    if cfg.loss.Classification:
        cls_loss = Classification(out, batch.scene_label,
                                  mask=batch.scene_mask)
        loss = loss + cls_loss
        aux["cls_loss"] = cls_loss
        if cfg.label == "pseudo":
            point_loss = Classification(meta, batch.point_label,
                                        mask=batch.valid)
            loss = loss + point_loss
            aux["point_loss"] = point_loss
    if cfg.has_text and cfg.loss.TextContrastive:
        gfeats, tfeats, has_text = meta
        if tfeats is not None:
            text_loss = TextContrastive(gfeats, tfeats, has_text,
                                        text_mask=text_mask(batch.text),
                                        scene_mask=batch.scene_mask)
            loss = loss + text_loss
            aux["text_loss"] = text_loss
    aux["loss"] = loss
    return loss, aux


def train_step(cfg: Config, model, optimizer, scheduler, batch: PointBatch,
               group=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One optimisation step on the batch's device: forward (batch-norm
    running statistics updated), backward, Adam update, schedule step.

    With a ``torch.distributed`` ``group``, one data-parallel step on this
    rank's batch (the reference's ``make_train_step(pmean_axis=...)``):
    forward and backward stay local, then the gradients and the running
    statistics are averaged over the group's ranks
    (:mod:`tdwss_torch.parallel.dp`) before Adam.  The aux scalars stay
    this rank's own; :func:`tdwss_torch.parallel.dp.average_scalars`
    averages them where a caller needs the mean.  The all-reduces wait
    for the other ranks (gloo also copies through the host), so what
    follows on host synchronisation holds for one process.

    Returns the loss and aux scalars as detached tensors, with no host
    synchronisation: on a card the call returns once the step is issued,
    not when it is done (``chip_smoke.py`` runs a warm step of the bench
    UNet, of FullySupervised and of MultiLabelContrastive under
    ``torch.cuda.set_sync_debug_mode`` and fails on any synchronising
    call).  The host's issue of the step's
    launches can still take as long as the card's work."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss, aux = compute_loss(cfg, model, batch)
    loss.backward()
    if group is not None:
        dp.average_gradients(model, group)
        dp.average_batch_stats(model, group)
    optimizer.step()
    scheduler.step()
    return loss.detach(), {k: v.detach() for k, v in aux.items()}


@torch.no_grad()
def eval_step(model, batch: PointBatch) -> torch.Tensor:
    """Per-point logits in eval mode (running BN statistics)."""
    return model(batch, istrain=False, train=False)


@torch.no_grad()
def accumulate_votes(store: torch.Tensor, logits: torch.Tensor,
                     point_ids: torch.Tensor, valid: torch.Tensor
                     ) -> torch.Tensor:
    """Add each valid point's logits into its global vote row, in place.

    Invalid rows and negative or out-of-range ids are dropped before the
    scatter (torch, like numpy, would wrap a negative id to the last row).

    A point id cannot repeat within one call: ``val_collate`` gives each
    kept point its scene offset plus its index in the scene, and subsamples
    without replacement.  So every row of ``store`` receives at most one
    add per call, and the result does not depend on the order in which
    ``index_add_``'s atomics land: the votes are reproducible without a
    sorted sum.
    """
    n = store.shape[0]
    keep = valid & (point_ids >= 0) & (point_ids < n)
    store.index_add_(0, point_ids[keep].long(), logits[keep].to(store.dtype))
    return store
