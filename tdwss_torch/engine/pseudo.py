"""Weak-supervision loop, stage 2: the pseudo-label threshold sweep and
pseudo-label generation (twin of ``tdwss.engine.pseudo``).

- :func:`threshold_sweep` (reference statistics.py:26-73): logits once
  per batch, every threshold of ``linspace(0.6, 0.8, 9)`` counted on the
  device, generated and correct labels over the train set, the curve
  plotted to ``visualization/Statistics.jpg`` where matplotlib is
  importable;
- :func:`generate_pseudo_labels` (pseudoLabelGeneration.py:38-59): one
  threshold, a full-length ``<scene><suffix>`` label file per scene, -100
  at points with no label.

Both score deterministic val-style views (every point, global point
ids); the sweep can instead score the train-augmented loader.  Both run
on ``cuda`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import copy
import os
from typing import Optional, Tuple

import numpy as np
import torch

from tdwss_torch.config import Config
from tdwss_torch.data.dataset import val_offsets
from tdwss_torch.data.loader import val_batches
from tdwss_torch.device import check_model_device, resolve_device
from tdwss_torch.engine.steps import eval_step
from tdwss_torch.utils.pseudo import preprocess_logits

DEFAULT_THRESHOLDS = np.linspace(0.6, 0.8, 9)


def _scores(model, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """(confidence (N,), label (N,) int32) of a batch on the model's
    device."""
    logits = eval_step(model, batch)
    s = preprocess_logits(logits, batch.scene_label, batch.coords[:, 3])
    conf, label = s.max(dim=-1)
    return conf, label.to(torch.int32)


def threshold_sweep(cfg: Config, model, scenes,
                    thresholds: Optional[np.ndarray] = None,
                    plot_path: str = "visualization/Statistics.jpg",
                    verbose: bool = True, train_augmented: bool = False,
                    device=None):
    """dict(thresholds, labelnum_prop, correct_prop, generated, correct,
    total): per threshold, the share of the ``total`` valid points that
    get a label and the share of those that match the point labels, and
    the two counts.

    ``train_augmented`` scores the train loader's augmented views, as
    the reference statistics.py:41-56 does; that needs ground-truth point
    labels, so it is refused under label ``pseudo`` (whose point labels
    are the pseudo labels).
    """
    dev = resolve_device(device)
    check_model_device(model, dev)
    thresholds = np.asarray(
        DEFAULT_THRESHOLDS if thresholds is None else thresholds, np.float32)
    t = torch.as_tensor(thresholds, device=dev)
    generated = torch.zeros(len(thresholds), dtype=torch.int64, device=dev)
    correct = torch.zeros_like(generated)
    total = torch.zeros((), dtype=torch.int64, device=dev)

    if train_augmented:
        if cfg.label == "pseudo":
            raise ValueError(
                "threshold_sweep(train_augmented=True) needs ground-truth "
                "point labels: run it with the base config (label="
                "'scene_level'), not a with_pseudo config")
        from tdwss_torch.data.loader import train_batches

        # keep coords: the scores read coords[:, 3], which the slim batch
        # drops for scene-level models
        sweep_cfg = copy.deepcopy(cfg)
        sweep_cfg.engine.slim_train_batch = False
        batches = train_batches(scenes, sweep_cfg, epoch=0, prefetch=False)
    else:
        batches = val_batches(scenes, cfg, val_offsets(scenes)[0], rep=0)
    model.eval()
    for batch in batches:
        batch = batch.to(dev)
        conf, label = _scores(model, batch)
        valid = batch.valid
        keep = (conf[None, :] >= t[:, None]) & valid[None, :]
        generated += keep.sum(dim=1)
        match = (label == batch.point_label.to(torch.int32))[None, :]
        correct += (keep & match).sum(dim=1)
        total += valid.sum()
    generated = generated.cpu().numpy()
    correct = correct.cpu().numpy()
    total = int(total)
    labelnum_prop = generated / max(total, 1)
    correct_prop = correct / np.maximum(generated, 1)
    if verbose:
        for i, th in enumerate(thresholds):
            print(f"Thresh={th:.3f}: generated {generated[i]} labels "
                  f"({100 * labelnum_prop[i]:.2f}%), of which {correct[i]} "
                  f"correct ({100 * correct_prop[i]:.2f}%)")
    _plot(thresholds, labelnum_prop, correct_prop, plot_path)
    return {"thresholds": thresholds, "labelnum_prop": labelnum_prop,
            "correct_prop": correct_prop, "generated": generated,
            "correct": correct, "total": total}


def _plot(thresholds, labelnum_prop, correct_prop, path: str) -> None:
    """The two curves to ``path``; nothing where matplotlib is missing."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt
    except Exception:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt.figure()
    plt.plot(thresholds, labelnum_prop, label="Label number")
    plt.plot(thresholds, correct_prop, label="Label precision")
    plt.legend()
    plt.savefig(path)
    plt.close()


def generate_pseudo_labels(cfg: Config, model, scenes,
                           threshold: Optional[float] = None,
                           saving_path: Optional[str] = None,
                           verbose: bool = True,
                           device=None) -> Tuple[int, int, int]:
    """Write ``<saving_path>/<scene><cfg.suffix>`` per scene (default
    ``<cfg.path>/<training_name>_thresh<threshold>``); returns
    (generated, correct, total points)."""
    dev = resolve_device(device)
    check_model_device(model, dev)
    threshold = cfg.threshold if threshold is None else threshold
    if saving_path is None:
        saving_path = os.path.join(
            cfg.path, f"{cfg.training_name}_thresh{threshold}")
    os.makedirs(saving_path, exist_ok=True)

    offsets, gt_all = val_offsets(scenes)
    store = np.full(int(offsets[-1]), -100, np.int64)
    model.eval()
    for batch in val_batches(scenes, cfg, offsets, rep=0):
        conf, label = _scores(model, batch.to(dev))
        keep = (conf >= threshold).cpu().numpy() & np.asarray(batch.valid)
        pids = np.asarray(batch.point_ids)
        sel = keep & (pids >= 0)
        store[pids[sel]] = label.cpu().numpy()[sel]

    generated = int((store != -100).sum())
    correct = int(((store == gt_all) & (store != -100)).sum())
    total = int(store.shape[0])
    for i, scene in enumerate(scenes):
        seg = store[offsets[i]: offsets[i + 1]].astype(np.int32)
        np.save(os.path.join(saving_path, scene.name + cfg.suffix), seg)
    if verbose:
        print(f"Using Thresh={threshold}. Generated {generated} labels "
              f"({100 * generated / max(total, 1):.2f}%), of which "
              f"{correct} correct ({100 * correct / max(generated, 1):.2f}%)")
    return generated, correct, total
