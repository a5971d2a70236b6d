"""Pseudo-label math of the weak-supervision loop (twin of
``tdwss.utils.pseudo``; the reference's ``utils/stats.py``).

- :func:`preprocess_logits`: per-point logits masked by the owning
  scene's tags, L2-normalised over classes, through a sigmoid;
- :func:`get_pseudo_labels`: confidence = the largest score, label = its
  class, ``-100`` below the threshold;
- :func:`assess_label_quality`: generated labels that match the ground
  truth;
- :func:`store_pseudo_label`: one ``.npy`` file per scene.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

IGNORE_LABEL = -100


def preprocess_logits(logits: torch.Tensor, scene_label: torch.Tensor,
                      point_batch: torch.Tensor) -> torch.Tensor:
    """(N, C) logits, (B, C) {0, 1} scene tags, (N,) owning-scene index
    -> (N, C) scores in (0, 1); scene indices are clipped into [0, B)."""
    b = scene_label.shape[0]
    idx = point_batch.long().clamp(0, b - 1)
    masked = logits * scene_label[idx].to(logits.dtype)
    norm = torch.linalg.vector_norm(masked, dim=-1, keepdim=True)
    return torch.sigmoid(masked / torch.clamp(norm, min=1e-12))


def get_pseudo_labels(logits: torch.Tensor, scene_label: torch.Tensor,
                      point_batch: torch.Tensor, threshold: float = 0.5,
                      valid: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pseudo labels (N,) int32, -100 below the threshold or outside
    ``valid``; the number generated, a 0-d tensor)."""
    scores = preprocess_logits(logits, scene_label, point_batch)
    conf, labels = scores.max(dim=-1)
    keep = conf >= threshold
    if valid is not None:
        keep = keep & valid
    pseudo = torch.where(keep, labels.to(torch.int32),
                         torch.full_like(labels, IGNORE_LABEL,
                                         dtype=torch.int32))
    return pseudo, keep.sum()


def assess_label_quality(pseudo_labels: torch.Tensor, labels: torch.Tensor,
                         valid: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(correct, generated) over the points that carry a pseudo label."""
    mask = pseudo_labels != IGNORE_LABEL
    if valid is not None:
        mask = mask & valid
    correct = (mask & (pseudo_labels == labels)).sum()
    return correct, mask.sum()


def store_pseudo_label(pseudo_labels: np.ndarray, scene_names: Sequence[str],
                       batch_offsets: Sequence[int], path: str,
                       suffix: str = "_pseudo_label.npy") -> None:
    """Write ``<path>/<scene><suffix>`` for each scene: its slice
    ``batch_offsets[b]:batch_offsets[b + 1]`` of ``pseudo_labels``."""
    os.makedirs(path, exist_ok=True)
    pseudo_labels = np.asarray(pseudo_labels)
    for b, name in enumerate(scene_names):
        segment = pseudo_labels[batch_offsets[b]: batch_offsets[b + 1]]
        np.save(os.path.join(path, name + suffix), segment)
