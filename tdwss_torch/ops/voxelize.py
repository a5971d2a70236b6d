"""Voxel -> point readback (twin of ``tdwss.ops.voxelize.devoxelize*``).

The eval path reads each point's owning-voxel features (scn.OutputLayer
parity); :func:`devoxelize_seg` is the same readback made differentiable
for the point-level loss, with a backward that adds no two values with
atomics.
"""

from __future__ import annotations

import torch


def devoxelize(vox_feats: torch.Tensor, point2voxel: torch.Tensor
               ) -> torch.Tensor:
    """(V, C), (N,) -> (N, C); ids outside [0, V) (dropped points) read 0."""
    v = vox_feats.shape[0]
    ok = (point2voxel >= 0) & (point2voxel < v)
    idx = torch.where(ok, point2voxel, torch.zeros_like(point2voxel)).long()
    return vox_feats[idx] * ok.unsqueeze(-1).to(vox_feats.dtype)


def run_sums(dpts: torch.Tensor, point_perm: torch.Tensor,
             counts: torch.Tensor) -> torch.Tensor:
    """(V, C) f32: row j is the sum of ``dpts`` over voxel j's contiguous
    run of ``point_perm`` (voxel j's points, in the host-sorted order),
    added left to right.

    ``torch.segment_reduce`` over the sorted rows with ``counts`` as the
    run lengths: one sequential sum per (voxel, channel), so the result
    is the same bit for bit on every run, on the CPU and on the card
    (no ``index_add_`` atomics, no floating-point ``cumsum``, whose CUDA
    scan may combine its tiles in another order from run to run, and no
    padded (V, max count, C) tensor).  Sorted rows past the last run
    (dropped and padding points) belong to no voxel; ``unsafe`` skips the
    check that the lengths cover every row, which would read the counts
    back to the host.
    """
    sorted_d = dpts.float()[point_perm.long()]
    return torch.segment_reduce(sorted_d, "sum", lengths=counts.long(),
                                axis=0, unsafe=True)


class _DevoxelizeSeg(torch.autograd.Function):
    """Forward: :func:`devoxelize`.  Backward: :func:`run_sums` of the
    points' cotangents (the reference's custom VJP,
    ``tdwss/ops/voxelize.py:148-188``, takes a cumsum difference, which
    rounds differently; the two agree within f32 rounding)."""

    @staticmethod
    def forward(ctx, vox_feats, point2voxel, point_perm, counts):
        ctx.save_for_backward(point_perm, counts)
        ctx.vox_dtype = vox_feats.dtype
        return devoxelize(vox_feats, point2voxel)

    @staticmethod
    def backward(ctx, dpts):
        point_perm, counts = ctx.saved_tensors
        dvox = run_sums(dpts, point_perm, counts).to(ctx.vox_dtype)
        return dvox, None, None, None


def devoxelize_seg(vox_feats: torch.Tensor, point2voxel: torch.Tensor,
                   point_perm: torch.Tensor, counts: torch.Tensor
                   ) -> torch.Tensor:
    """Differentiable :func:`devoxelize` with a fixed-order backward.

    ``point_perm`` (N,) orders the points into contiguous per-voxel runs
    with dropped and padding points at the tail; ``counts`` (V,) is the
    points per voxel (both from the host voxelizer,
    :func:`tdwss_torch.ops.host_plan.host_voxelize_and_plan`).
    """
    return _DevoxelizeSeg.apply(vox_feats, point2voxel, point_perm, counts)
