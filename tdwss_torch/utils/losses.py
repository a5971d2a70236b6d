"""Training losses (twin of :mod:`tdwss.utils.losses`).

``Classification`` with (B, C) scene tags: the multi-label soft-margin
loss over scene logits, masked over padded scenes.  The point-level
cross-entropy branch (1-D labels, the pseudo-label round) and
``TextContrastive`` are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def multilabel_soft_margin(logits: torch.Tensor, labels: torch.Tensor,
                           scene_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Mean over scenes of the mean over classes of
    ``-[y log sigmoid(x) + (1 - y) log sigmoid(-x)]``; with
    ``scene_mask`` the mean runs over the valid scenes only."""
    labels = labels.to(logits.dtype)
    per_class = (labels * F.logsigmoid(logits)
                 + (1.0 - labels) * F.logsigmoid(-logits))
    per_scene = -per_class.mean(dim=-1)
    if scene_mask is None:
        return per_scene.mean()
    m = scene_mask.to(logits.dtype)
    return (per_scene * m).sum() / torch.clamp(m.sum(), min=1.0)


def Classification(logits: torch.Tensor, labels: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch on label rank (reference utils/loss.py:27-33): (B, C)
    labels -> scene-level multi-label soft margin."""
    if labels.dim() == 2:
        return multilabel_soft_margin(logits, labels, scene_mask=mask)
    if labels.dim() == 1:
        raise NotImplementedError("the point-level cross-entropy (pseudo-"
                                  "label round) is not ported yet")
    raise ValueError(f"unsupported label rank: {labels.dim()}")
