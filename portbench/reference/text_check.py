"""What decides ``correct`` in a text cell: the program's first training
steps of ``MultiLabelContrastive`` held against the text reference's
(:mod:`portbench.reference.text_model`) on the same scenes, texts and
weights.

The numbers of :mod:`portbench.reference.check`, with the same meaning
over every leaf, the text tower's included (``loss_gap`` on the total
loss, the scene tags' soft margin plus ``TextContrastive``), and three
more, of the first step (both sides at the same weights):

- ``grad_vector_gap``: the first step's gradient, per leaf
  ``||g_program - g_reference||`` over the larger of the reference
  leaf's norm and the median leaf's, the median leaf's.  Where
  ``grad_median_gap`` compares norms, this compares the vectors: a loss
  over half of the batch has its own gradient direction, whose norms
  may match the whole batch's;

- ``text_loss_gap``: the ``TextContrastive`` terms of every (scene,
  slot), ``-log softmax_c <text[b, t], scene[c]>`` at the slot's owner,
  0 where the slot does not count: ``||d|| / ||reference||`` over the
  slots.  The program's terms come from its own scene features, text
  features, owners and mask.  Per slot, not their mean: at the seed's
  weights the text features are not yet aligned with their scenes, so a
  wrong pairing moves each slot's term by units but their mean over the
  batch's slots by about as much as the 3D tower's bf16 rounding does;
- ``text_feature_gap``: the text features (after ``text_linear``, every
  (scene, slot) row), ``max |d|`` over ``max |reference|``: the text
  tower's forward, which depends on the tokens and the weights alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference import check, collate
from portbench.reference.check import ProgramCapture, Trajectory
from portbench.reference.model import Adam, geometry, soft_margin
from portbench.reference.text_collate import Tokenizer, text_params, text_rows
from portbench.reference.text_model import (FCNet, TextTower, fcn_planes,
                                            text_contrastive)
from portbench.reference.voxels import capacities

NUMBERS = check.NUMBERS + ("grad_vector_gap", "text_loss_gap",
                           "text_feature_gap")


@dataclass
class TextTrajectory(Trajectory):
    """A side's first steps, with the first step's gradient, text
    features and per-slot ``TextContrastive`` terms (f32, on the
    host)."""

    grads: Dict[str, torch.Tensor] = None
    text_feats: torch.Tensor = None
    text_slots: torch.Tensor = None


def slot_terms(scene: torch.Tensor, text: torch.Tensor, owners: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """(B', T) f32 on the host: each slot's ``TextContrastive`` term,
    ``-log softmax_c <text[b, t], scene[c]>`` at ``c = owners[b]``, 0
    where the slot does not count."""
    logp = torch.log_softmax(torch.einsum(
        "btm,cm->btc", text.float(), scene.float()), dim=-1)
    own = owners.long()[:, None, None].expand(-1, text.shape[1], 1)
    nll = -torch.gather(logp, -1, own)[..., 0]
    return check._host(nll * mask.to(nll.dtype))


def plan_capacities(cfg: dict) -> List[int]:
    """The FCN's level capacities of a configuration."""
    eng = cfg["engine"]
    return capacities(eng.get("max_voxels") or eng["max_points"],
                      len(fcn_planes(cfg["pointcloud_model"])),
                      eng.get("level_capacity_shrink", 2),
                      eng.get("min_level_capacity", 2048),
                      eng.get("level_capacity_schedule") or ())


def reference_steps(scenes: Sequence, cfg: dict, seed: int,
                    weights: Dict[str, torch.Tensor], steps: int, device,
                    pc_precision: str = "float32",
                    text_precision: str = "float32",
                    half_batch: bool = False,
                    rolled: bool = False) -> TextTrajectory:
    """The text reference's first ``steps`` steps of epoch 1 from
    ``weights`` (left as they are); ``pc_precision`` and
    ``text_precision`` as :mod:`portbench.reference.text_model` takes
    them.  Planted faults: ``half_batch``, the loss over the batch's
    first half of scenes (their tags and their descriptions) only;
    ``rolled``, each scene paired with the next scene's descriptions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = {n: w.detach().clone().float().to(device).requires_grad_(True)
              for n, w in weights.items()}
    start = {n: w.detach().clone() for n, w in params.items()}
    net = FCNet(cfg["pointcloud_model"], params, pc_precision)
    tower = TextTower(cfg["text_model"], params, text_precision)
    opt = Adam(params, lr=cfg.get("lr", 1e-3))
    cp, tp = check.collate_params(cfg), text_params(cfg)
    caps = plan_capacities(cfg)
    tok = Tokenizer()
    out = TextTrajectory()
    starts = collate.epoch_starts(len(scenes), cp["batch_size"])
    if len(starts) < steps:
        raise ValueError(f"an epoch has {len(starts)} steps, the check "
                         f"follows {steps}")
    for s in starts[:steps]:
        b = collate.train_batch(scenes, cp, seed, 1, s)
        rows = text_rows(scenes, tp, seed, 1, s, tok, rolled=rolled)
        g = geometry(torch.from_numpy(b.coords).to(device), caps)
        pooled = net.scene_features(g, torch.from_numpy(b.feats).to(device),
                                    b.scene_label.shape[0])
        logits = net.head(pooled)
        text = tower.features(torch.from_numpy(rows.tokens).to(device))
        tags = torch.from_numpy(b.scene_label).to(device)
        mask = torch.from_numpy(rows.mask).to(device)
        keep = max(tags.shape[0] // 2, 1) if half_batch else None
        if out.logits is None:
            out.logits = check._host(logits)
            out.text_feats = check._host(text)
            out.text_slots = slot_terms(
                pooled, text, torch.arange(text.shape[0], device=device),
                mask)
        loss = soft_margin(logits[:keep], tags[:keep]) \
            + text_contrastive(pooled, text, mask, keep)
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = dict(zip(params, grads))
        out.losses.append(float(loss.detach()))
        if not out.grad_norms:
            out.grad_norms = {n: check._norm(v) for n, v in grads.items()}
            out.grads = {n: check._host(v) for n, v in grads.items()}
        opt.step(grads)
        del g, pooled, logits, text, loss, grads
    out.change_norms = {n: check._norm(params[n] - start[n])
                        for n in params}
    return out


def _gap(prog, ref, norm) -> float:
    if prog is None or prog.shape != ref.shape:
        return float("inf")
    return float(norm(prog - ref) / norm(ref).clamp(min=1e-30))


def readings(prog: TextTrajectory, ref: TextTrajectory) -> Dict[str, float]:
    """The numbers of a program (or control, or fault) trajectory
    against the reference's."""
    out = check.readings(prog, ref)
    leaves = sorted(ref.grad_norms)
    gaps = check._shares({n: check._norm(prog.grads[n] - ref.grads[n])
                          for n in leaves}, ref.grad_norms, leaves)
    out["grad_vector_gap"] = float(np.median(gaps))
    out["text_loss_gap"] = _gap(prog.text_slots, ref.text_slots,
                                torch.linalg.vector_norm)
    out["text_feature_gap"] = _gap(prog.text_feats, ref.text_feats,
                                   lambda t: t.abs().max())
    return out


class TextCapture(ProgramCapture):
    """:class:`ProgramCapture` for ``MultiLabelContrastive``, whose
    training output is ``(scene logits, (scene features, text features,
    owners))``: ``loss_fn(output, batch)`` is the program's own total
    loss of it, ``mask_fn(batch)`` the program's mask of the slots that
    count."""

    def __init__(self, model, optimizer, start, steps: int, loss_fn,
                 mask_fn):
        super().__init__(model, optimizer, start, steps, loss_fn)
        self.traj = TextTrajectory()
        self.mask_fn = mask_fn

    def _on_forward(self, module, args, kwargs, output):
        if self._done < self.steps and kwargs.get("istrain") \
                and module.training and torch.is_grad_enabled():
            batch = args[0]
            with torch.no_grad():
                if not self._losses:
                    logits, (gfeats, tfeats, owners) = output
                    self.traj.logits = check._host(logits)
                    self.traj.text_feats = check._host(tfeats)
                    self.traj.text_slots = slot_terms(
                        gfeats, tfeats, owners, self.mask_fn(batch))
                self._losses.append(self.loss_fn(output, batch).float())

    def _on_step(self, optimizer, args, kwargs):
        super()._on_step(optimizer, args, kwargs)
        if self._done == 1:
            self.traj.grads = {
                n: check._host(optimizer.state[p]["exp_avg"]
                               / (1 - check.BETA1))
                for n, p in self._params()}
