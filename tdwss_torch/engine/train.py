"""Training loop (twin of ``tdwss.engine.train``; reference train.py).

The epoch loop: train steps (Adam 1e-3, StepLR 100/0.1) over the
prefetching train loader, a checkpoint every epoch with auto-resume,
validation at power-of-two epochs and every 32nd
(``scn.is_power2(epoch) or epoch % 32 == 0``, train.py:94), the train
loss and validation mIoU logged as scalars, and the parameter count
printed.  The epoch line carries MegaMulAdd per scene, counted from the
first batch's plans (:func:`tdwss_torch.utils.flops.mega_mul_add`; the
reference reads XLA's cost analysis of the step, which counts other
ops).

With ``mesh.data > 1`` the ``Trainer`` trains data-parallel over an
initialised ``torch.distributed`` group of ``mesh.data`` ranks (started
by ``torchrun``; the ``Trainer`` never starts one): ``batch_size`` stays
global, each rank trains on its ``batch_size / mesh.data`` scenes of
every step (:func:`tdwss_torch.engine.steps.train_step` with the
group), rank 0
writes the checkpoints and scalars and validates, as the reference's
mesh branch does (tdwss/engine/train.py:63-93, 137-148, 199-210).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import List, Optional

import torch

from tdwss_torch.config import Config
from tdwss_torch.data.dataset import load_train_val
from tdwss_torch.data.loader import (steps_per_epoch, train_batches,
                                     warm_plan_shapes)
from tdwss_torch.device import resolve_device
from tdwss_torch.engine.evaluate import validate
from tdwss_torch.engine.steps import make_optimizer, train_step
from tdwss_torch.models.meta_arch import build_model
from tdwss_torch.parallel import dp
from tdwss_torch.utils.checkpoint import Checkpointer, load_pretrain
from tdwss_torch.utils.flops import mega_mul_add, param_count
from tdwss_torch.utils.logging_util import ScalarLogger

# Steps the host may run ahead of the card: each in-flight step holds
# its batch on the card, so the loop waits for the step this many back.
_PIPELINE_DEPTH = 4


def is_power2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def local_config(cfg: Config, ndev: int) -> Config:
    """``cfg`` with each rank's share of the global batch size."""
    bs = cfg.pointcloud_data.batch_size
    if bs % ndev:
        raise ValueError(f"batch_size {bs} must divide across mesh.data="
                         f"{ndev} devices")
    return dataclasses.replace(cfg, pointcloud_data=dataclasses.replace(
        cfg.pointcloud_data, batch_size=bs // ndev))


def _process_group(ndev: int) -> tuple:
    """``(rank, world)`` of the initialised default group, which must hold
    ``ndev`` ranks."""
    if not (torch.distributed.is_available()
            and torch.distributed.is_initialized()):
        raise RuntimeError(
            f"mesh.data={ndev} trains data-parallel over a torch.distributed "
            f"process group, and none is initialised: start it with "
            f"`torchrun --nproc_per_node={ndev} -m tdwss_torch.cli.train "
            f"...`, or initialise one before building the Trainer")
    rank, world = (torch.distributed.get_rank(),
                   torch.distributed.get_world_size())
    if world != ndev:
        raise ValueError(f"mesh.data={ndev} but the process group holds "
                         f"{world} ranks")
    return rank, world


class Trainer:
    """Model, optimiser and schedule of ``cfg`` on ``device`` (``cuda``
    unless the caller asks for the CPU), resumed from the newest
    checkpoint under ``exp/<training_name>/checkpoints_torch`` when
    ``use_checkpoints``, else (or with none there) seeded from
    ``cfg.pretrain`` when set.

    With ``mesh.data > 1``, one rank of a data-parallel run: the default
    process group must hold ``mesh.data`` ranks, and an unqualified
    ``cuda`` device means ``cuda:LOCAL_RANK``."""

    def __init__(self, cfg: Config, train_scenes=None, val_scenes=None,
                 use_checkpoints: bool = True, verbose: bool = True,
                 device=None):
        self.cfg = cfg
        self.ndev = max(int(cfg.mesh.data or 1), 1)
        self.rank, self.shard, self.group = 0, None, None
        self._local_cfg = cfg
        if self.ndev > 1:
            self._local_cfg = local_config(cfg, self.ndev)
            self.shard = _process_group(self.ndev)
            self.rank = self.shard[0]
            self.group = torch.distributed.group.WORLD
            device = dp.dp_device(device)
        verbose = self.verbose = verbose and self.rank == 0
        self.device = resolve_device(device)
        if self.shard is not None and self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        if train_scenes is None or val_scenes is None:
            train_scenes, val_scenes = load_train_val(cfg)
        self.train_scenes = train_scenes
        self.val_scenes = val_scenes
        if verbose:
            print("Training examples:", len(train_scenes))
            print("Validation examples:", len(val_scenes))

        self.model = build_model(cfg, seed=0, device=self.device)
        self.spe = max(steps_per_epoch(len(train_scenes),
                                       cfg.pointcloud_data.batch_size), 1)
        self.optimizer, self.scheduler = make_optimizer(cfg, self.model,
                                                        self.spe)
        self.step = 0
        self.madds: Optional[float] = None
        self.warmed_epochs = []
        if cfg.engine.prewarm_shapes:
            self.warmed_epochs = warm_plan_shapes(
                train_scenes, self._local_cfg,
                epochs=cfg.engine.prewarm_epochs, shard=self.shard)
        if verbose:
            print("#classifier parameters", param_count(self.model))

        self.ckpt: Optional[Checkpointer] = None
        self.start_epoch = 1
        if use_checkpoints:
            self.ckpt = Checkpointer(os.path.join(
                "exp", cfg.training_name, "checkpoints_torch"))
            # on the host: load_state_dict copies the tensors to the
            # parameters' device and keeps Adam's step counts on the host
            state, self.start_epoch = self.ckpt.restore_latest(
                map_location="cpu")
            if state is not None:
                self.load_state_dict(state)
            if verbose:
                print("Start from epoch", self.start_epoch)
        if cfg.pretrain and self.start_epoch == 1:
            load_pretrain(cfg.pretrain, self.model)
            if verbose:
                print("Loaded pretrain weights from", cfg.pretrain)
        if self.shard is not None:
            dp.broadcast_state(self.model)
        self.logger = (ScalarLogger(os.path.join("exp", cfg.training_name))
                       if self.rank == 0 else None)

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.step = int(state["step"])

    def run_epoch(self, epoch: int) -> float:
        """One epoch of train steps; the mean loss.

        The losses stay on the card until the epoch ends; after each
        step the loop waits only for the step ``_PIPELINE_DEPTH`` back,
        so the host plans and issues ahead of the card without holding
        more than that many batches there.
        """
        losses = []
        done = collections.deque()
        cuda = self.device.type == "cuda"
        for batch in train_batches(self.train_scenes, self._local_cfg, epoch,
                                   to_device=self.device, shard=self.shard):
            if self.madds is None:
                # this rank's batch over its scenes: per scene as the
                # reference's count of the device-stacked batch
                self.madds = mega_mul_add(
                    self.model, batch,
                    per=self._local_cfg.pointcloud_data.batch_size)
            loss, _ = train_step(self._local_cfg, self.model,
                                 self.optimizer, self.scheduler, batch,
                                 group=self.group)
            del batch
            self.step += 1
            losses.append(loss)
            if cuda:
                done.append(torch.cuda.Event())
                done[-1].record()
                if len(done) > _PIPELINE_DEPTH:
                    done.popleft().synchronize()
        if not losses:
            return 0.0
        mean = torch.stack(losses).mean()
        if self.shard is not None:
            # every rank ran as many steps: the mean over the ranks of
            # their mean losses is the mean of the steps' averaged losses
            mean = dp.average_scalars({"loss": mean})["loss"]
        return float(mean)

    def fit(self, epochs: Optional[int] = None) -> List[float]:
        """Epochs ``start_epoch`` .. ``epochs`` (default ``cfg.epochs``);
        the mean train loss of each."""
        cfg = self.cfg
        epochs = epochs or cfg.epochs
        history = []
        for epoch in range(self.start_epoch, epochs + 1):
            start = time.time()
            mean_loss = self.run_epoch(epoch)
            history.append(mean_loss)
            if self.verbose:
                print(epoch, "Train loss", mean_loss,
                      "MegaMulAdd", round(self.madds or 0.0, 1),
                      "time", round(time.time() - start, 2), "s")
            if self.rank == 0:
                self.logger.scalar("Train Loss", mean_loss, epoch)
                if self.ckpt is not None:
                    self.ckpt.save(epoch, self.state_dict())
                if (is_power2(epoch) or epoch % 32 == 0) and self.val_scenes:
                    # the per-rank batch size, as the reference validates
                    ious = validate(self._local_cfg, self.model,
                                    self.val_scenes, verbose=self.verbose,
                                    device=self.device)
                    self.logger.scalar("Validation accuracy", ious[-1],
                                       epoch)
            if self.shard is not None:
                torch.distributed.barrier()
        return history
