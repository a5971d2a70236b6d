"""What decides ``correct``: the program's first training steps held
against the reference's on the same scenes and weights.

The numbers, of which the cell's file gives the compared ones their
limits:

- ``loss_gap``: the largest of the first steps' relative loss gaps,
  ``|L_program - L_reference| / |L_reference|``;
- ``logit_gap``: the first step's scene logits (both sides at the same
  weights), ``|z_program - z_reference| / |z_reference|`` over the
  batch's scenes and tags: the forward at first order, where the loss
  and the norms below average rounding out;
- of the first step's gradient (the program's as its Adam got it,
  worked out from Adam's first moment after one step), per leaf the gap
  of norms ``|norm_program - norm_reference|`` over the larger of the
  reference leaf's norm and the median leaf's: ``grad_gap`` the worst
  leaf's, ``grad_median_gap`` the median leaf's;
- ``change_gap``: the worst leaf's gap of norms of each leaf's change
  over the first steps, over the leaves whose reference gradient is at
  least a thousandth of the median leaf's (smaller ones move by Adam's
  round-off alone).

The reference runs the same batches (worked out again from the raw
scenes, :mod:`portbench.reference.collate`), the same weights, batch
norm on the batch statistics, the loss and Adam, in f32 with TF32 off
(or in the fp8 control's precision).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference import collate
from portbench.reference.model import (Adam, Net, geometry, plan_capacities,
                                       soft_margin)

BETA1 = 0.9
NUMBERS = ("loss_gap", "logit_gap", "grad_gap", "grad_median_gap",
           "change_gap")
QUIET_LEAF = 1e-3       # a leaf whose gradient is under this share of the
                        # median leaf's is left out of the change


@dataclass
class Trajectory:
    """A side's first steps: each step's loss, the first step's scene
    logits (f32, on the host), the first gradient's norm per leaf and
    each leaf's change over the steps."""

    losses: List[float] = field(default_factory=list)
    logits: torch.Tensor = None
    grad_norms: Dict[str, float] = field(default_factory=dict)
    change_norms: Dict[str, float] = field(default_factory=dict)


def collate_params(cfg: dict) -> dict:
    pcd, pc, eng = (cfg["pointcloud_data"], cfg["pointcloud_model"],
                    cfg["engine"])
    return {"scale": pcd["scale"], "full_scale": pc.get("full_scale", 4096),
            "batch_size": pcd["batch_size"], "max_points": eng["max_points"],
            "elastic_deformation": pcd.get("elastic_deformation", False)}


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32, copy=True)


def reference_steps(scenes: Sequence, cfg: dict, seed: int,
                    weights: Dict[str, torch.Tensor], steps: int,
                    device, precision: str = "float32",
                    half_batch: bool = False) -> Trajectory:
    """The reference's first ``steps`` steps of epoch 1 from ``weights``
    (left as they are).  ``half_batch`` plants a fault: the loss is the
    mean over the batch's first half of scenes only."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = {n: w.detach().clone().float().to(device).requires_grad_(True)
              for n, w in weights.items()}
    start = {n: w.detach().clone() for n, w in params.items()}
    net = Net(cfg["pointcloud_model"], params, precision)
    opt = Adam(params, lr=cfg.get("lr", 1e-3))
    cp = collate_params(cfg)
    caps = plan_capacities(cfg)
    out = Trajectory()
    starts = collate.epoch_starts(len(scenes), cp["batch_size"])
    if len(starts) < steps:
        raise ValueError(f"an epoch has {len(starts)} steps, the check "
                         f"follows {steps}")
    for s in starts[:steps]:
        b = collate.train_batch(scenes, cp, seed, 1, s)
        g = geometry(torch.from_numpy(b.coords).to(device), caps)
        logits = net.scene_logits(g, torch.from_numpy(b.feats).to(device),
                                  b.scene_label.shape[0])
        tags = torch.from_numpy(b.scene_label).to(device)
        if out.logits is None:
            out.logits = _host(logits)
        if half_batch:
            keep = max(tags.shape[0] // 2, 1)
            logits, tags = logits[:keep], tags[:keep]
        loss = soft_margin(logits, tags)
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = dict(zip(params, grads))
        out.losses.append(float(loss.detach()))
        if not out.grad_norms:
            out.grad_norms = {n: _norm(v) for n, v in grads.items()}
        opt.step(grads)
        del g, logits, loss, grads
    out.change_norms = {n: _norm(params[n] - start[n]) for n in params}
    return out


def _shares(values: Dict[str, float], scale: Dict[str, float],
            leaves: Sequence[str]) -> np.ndarray:
    """Each leaf's value over the larger of its ``scale`` and the median
    leaf's."""
    med = float(np.median([scale[n] for n in leaves]))
    return np.array([values[n] / max(scale[n], med, 1e-30) for n in leaves])


def readings(prog: Trajectory, ref: Trajectory) -> Dict[str, float]:
    """The numbers of a program (or control) trajectory against the
    reference's."""
    if set(prog.grad_norms) != set(ref.grad_norms):
        raise ValueError("the two sides' leaves differ")
    leaves = sorted(ref.grad_norms)
    norm = ref.grad_norms
    med = float(np.median([norm[n] for n in leaves]))
    moving = [n for n in leaves if norm[n] >= QUIET_LEAF * med]
    losses = [abs(a - b) / abs(b) for a, b in zip(prog.losses, ref.losses)]
    if len(prog.losses) != len(ref.losses) or not all(
            np.isfinite(prog.losses)):
        losses = [float("inf")]
    gap = _shares({n: abs(prog.grad_norms[n] - norm[n]) for n in leaves},
                  norm, leaves)
    logit = (_norm(prog.logits - ref.logits) / max(_norm(ref.logits), 1e-30)
             if prog.logits is not None
             and prog.logits.shape == ref.logits.shape else float("inf"))
    change = _shares({n: abs(prog.change_norms[n] - ref.change_norms[n])
                      for n in moving}, ref.change_norms, moving)
    return {"loss_gap": max(losses), "logit_gap": logit,
            "grad_gap": float(gap.max()),
            "grad_median_gap": float(np.median(gap)),
            "change_gap": float(change.max())}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit (a NaN is outside)."""
    return all(values[k] <= limits[k] for k in limits)


class ProgramCapture:
    """The program's first ``steps`` steps, read while its own loop runs
    them: each step's loss from the model's output (a forward hook; the
    loss is the program's own function of it), the first gradient from
    Adam's first moment after one step, and each leaf's change from
    ``start`` after the last (optimizer post-step hooks).  Public
    mechanisms only: nothing of the program is replaced."""

    def __init__(self, model, optimizer, start: Dict[str, torch.Tensor],
                 steps: int, loss_fn):
        self.traj = Trajectory()
        self.steps, self.start, self.loss_fn = steps, start, loss_fn
        self._losses: List[torch.Tensor] = []
        self._done = 0
        self._names = {id(p): n for n, p in model.named_parameters()}
        self._opt = optimizer
        self._hooks = [
            model.register_forward_hook(self._on_forward, with_kwargs=True),
            optimizer.register_step_post_hook(self._on_step)]

    def _on_forward(self, module, args, kwargs, output):
        if self._done < self.steps and kwargs.get("istrain") \
                and module.training and torch.is_grad_enabled():
            batch = args[0]
            with torch.no_grad():
                if not self._losses:
                    self.traj.logits = _host(output[0])
                self._losses.append(self.loss_fn(
                    output[0], batch.scene_label, batch.scene_mask).float())

    def _params(self):
        for group in self._opt.param_groups:
            for p in group["params"]:
                yield self._names[id(p)], p

    def _on_step(self, optimizer, args, kwargs):
        self._done += 1
        if self._done == 1:
            self.traj.grad_norms = {
                n: _norm(optimizer.state[p]["exp_avg"] / (1 - BETA1))
                for n, p in self._params()}
        if self._done == self.steps:
            self.traj.change_norms = {n: _norm(p - self.start[n])
                                      for n, p in self._params()}
            self.traj.losses = [float(x) for x in self._losses]
            self.close()

    def close(self) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks = []

    def result(self) -> Trajectory:
        if self._done < self.steps:
            raise RuntimeError(f"the program ran {self._done} steps, the "
                               f"check follows {self.steps}")
        return self.traj
