"""Scene-keyed segment reductions (twin of :mod:`tdwss.ops.segment`).

The scene count B is tiny, so a reduction over rows is a (B, N) one-hot
mask matmul, as in the reference: deterministic, with another matmul
as its gradient (no scatter).
"""

from __future__ import annotations

from typing import Optional

import torch


def _one_hot_mask(batch_idx: torch.Tensor, num_segments: int,
                  valid: Optional[torch.Tensor],
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(num_segments, N) f32 membership mask, optionally weighted; rows
    outside ``valid`` belong to no segment."""
    ids = batch_idx.long()
    if valid is not None:
        ids = torch.where(valid, ids, torch.full_like(ids, num_segments))
    seg = torch.arange(num_segments, device=ids.device)
    mask = (seg[:, None] == ids[None, :]).float()
    if weights is not None:
        mask = mask * weights.float()[None, :]
    return mask


def segment_mean_weighted(feats: torch.Tensor, batch_idx: torch.Tensor,
                          weights: torch.Tensor, num_segments: int,
                          valid: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Weighted per-scene mean: sum_i w_i f_i / sum_i w_i per segment.

    Pools scene features over voxels with per-voxel point counts as the
    weights, which equals the reference model's mean over points (each
    point reads its voxel's features).  -> (num_segments, C) in feats'
    dtype.
    """
    mask = _one_hot_mask(batch_idx, num_segments, valid, weights)
    summed = mask @ feats.float()
    denom = mask.sum(dim=1)
    return (summed / torch.clamp(denom, min=1e-9)[:, None]).to(feats.dtype)


def segment_sum_by_batch(feats: torch.Tensor, batch_idx: torch.Tensor,
                         num_segments: int,
                         valid: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """(N, C) rows summed into (num_segments, C) by scene index, in
    feats' dtype."""
    mask = _one_hot_mask(batch_idx, num_segments, valid)
    return (mask @ feats.float()).to(feats.dtype)


def segment_mean_by_batch(feats: torch.Tensor, batch_idx: torch.Tensor,
                          num_segments: int,
                          valid: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Per-scene mean over the valid rows (postProcessing parity); a
    scene with no valid row gives zeros.  -> (num_segments, C) in feats'
    dtype."""
    mask = _one_hot_mask(batch_idx, num_segments, valid)
    summed = mask @ feats.float()
    counts = mask.sum(dim=1)
    return (summed / torch.clamp(counts, min=1.0)[:, None]).to(feats.dtype)
