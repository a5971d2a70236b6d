"""Training losses (twin of :mod:`tdwss.utils.losses`).

``Classification`` dispatches on the label rank: (B, C) scene tags take
the multi-label soft-margin loss over scene logits, masked over padded
scenes; (N,) point labels (the pseudo-label round) take the
cross-entropy with ``-100`` ignored.  ``TextContrastive`` aligns each
description's feature with its scene's pooled feature.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

IGNORE_LABEL = -100


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


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         valid: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Mean cross-entropy of (N, C) logits against (N,) integer labels
    over the rows whose label is not -100 (and, with ``valid``, that are
    valid); 0 when no row counts."""
    keep = labels != IGNORE_LABEL
    if valid is not None:
        keep = keep & valid
    safe = torch.where(keep, labels, torch.zeros_like(labels)).long()
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, safe[:, None])[:, 0]
    keep_f = keep.to(logits.dtype)
    return (nll * keep_f).sum() / torch.clamp(keep_f.sum(), min=1.0)


def Classification(logits: torch.Tensor, labels: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch on label rank (reference utils/loss.py:27-33): (B, C)
    labels -> scene-level multi-label soft margin; (N,) labels ->
    point-level cross-entropy with -100 ignored."""
    if labels.dim() == 2:
        return multilabel_soft_margin(logits, labels, scene_mask=mask)
    if labels.dim() == 1:
        return masked_cross_entropy(logits, labels, valid=mask)
    raise ValueError(f"unsupported label rank: {labels.dim()}")


def TextContrastive(pc: torch.Tensor, text: torch.Tensor,
                    has_text: torch.Tensor,
                    text_mask: Optional[torch.Tensor] = None,
                    scene_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Scene-text contrastive loss (reference utils/loss.py:6-18).

    pc (B, m) pooled scene features; text (B', T, m) description
    features; has_text (B',) each row's owning scene; text_mask (B',) or
    (B', T) valid rows or slots; scene_mask (B,) valid scenes.

    ``similarity[b', t, b] = <text[b', t], pc[b]>``, padded scenes set to
    ``finfo.min`` so that they leave the softmax over scenes (the
    reference runs unpadded batches); the cross-entropy against the
    owning scene (clipped into range; a negative owner is dropped),
    averaged over the kept (b', t).
    """
    if text.dim() != 3:
        raise ValueError(f"text must be (B', T, m), got {tuple(text.shape)}")
    dtype = torch.promote_types(text.dtype, pc.dtype)
    similarity = torch.einsum("btm,cm->btc", text.to(dtype), pc.to(dtype))
    if scene_mask is not None:
        similarity = similarity.masked_fill(~scene_mask.bool()[None, None],
                                            torch.finfo(dtype).min)
    logp = F.log_softmax(similarity, dim=-1)
    num_text = text.shape[1]
    labels = has_text[:, None].expand(-1, num_text)
    safe = labels.clamp(0, pc.shape[0] - 1).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    if text_mask is None:
        keep = torch.ones_like(nll)
    else:
        keep = text_mask.to(nll.dtype)
        if keep.dim() == 1:
            keep = keep[:, None].expand(-1, num_text)
    keep = keep * (labels >= 0).to(nll.dtype)
    return (nll * keep).sum() / torch.clamp(keep.sum(), min=1.0)
