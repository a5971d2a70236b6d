"""Point-cloud voxelization and voxel -> point readback (twin of
:mod:`tdwss.ops.voxelize`).

:func:`voxelize` is the device voxelizer of the plans-free branch
(``engine.host_plans: false``; scn.InputLayer mode 4 parity): a stable
sort of the points by their packed coordinate keys, the first point of
each key run opening a voxel, each voxel's features the sum, mean or
first of its run.  Every shape is fixed by the capacity, and nothing is
read back to the host: a scatter "with drop" writes into one extra dump
row that is sliced off.

The eval path reads each point's owning-voxel features (scn.OutputLayer
parity); :func:`devoxelize_seg` is the same readback made differentiable
for the point-level loss, with a backward that adds no two values with
atomics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tdwss_torch.ops.coords import INVALID_KEY, make_keys, sort_by_keys
from tdwss_torch.ops.plan import SparseGrid


def _scatter_drop(fill, shape, dtype, index, values):
    """A ``shape`` tensor of ``fill`` with ``values`` written at rows
    ``index``; rows at ``shape[0]`` (the reference's ``mode="drop"``) go
    to a dump row that is sliced off.  Rows written more than once get
    equal values here."""
    out = torch.full((shape[0] + 1,) + tuple(shape[1:]), fill, dtype=dtype,
                     device=index.device)
    out[index.long()] = values.to(dtype)
    return out[:shape[0]]


def voxelize(coords: torch.Tensor, feats: Optional[torch.Tensor],
             valid: torch.Tensor, num_voxels: int, mode: str = "mean"
             ) -> Tuple[SparseGrid, Optional[torch.Tensor], torch.Tensor]:
    """Deduplicate integer point coordinates into a key-sorted voxel grid.

    coords (N, 4) int [x, y, z, b] in [0, full_scale); feats (N, C) or
    None (a structure-only pass, for the coarser levels); valid (N,)
    bool; ``num_voxels`` the capacity V; ``mode`` "mean" (InputLayer
    mode 4), "sum" or "first" (the run's first point in input order:
    the sort is stable).

    Returns ``(grid, vox_feats (V, C) or None, point2voxel (N,) int32)``.
    A voxel whose rank is V or more is dropped (``grid.num_valid`` still
    counts it), and an invalid or dropped point maps to V.  A voxel's
    points are one run of the sorted points, so its features are summed
    by ``torch.segment_reduce`` over the runs, left to right, the same on
    every run and device.
    """
    n = coords.shape[0]
    v = int(num_voxels)
    dev = coords.device
    coords = coords.to(torch.int32)
    hi, lo = make_keys(coords, valid)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    s_hi, s_lo, s_idx = sort_by_keys(hi, lo, idx)
    s_coords = coords[s_idx.long()]
    s_valid = valid[s_idx.long()]
    first_key = torch.full((1,), -2, dtype=torch.int32, device=dev)
    prev_hi = torch.cat([first_key, s_hi[:-1]])
    prev_lo = torch.cat([first_key, s_lo[:-1]])
    is_first = ((s_hi != prev_hi) | (s_lo != prev_lo)) & s_valid
    ranks = torch.cumsum(is_first.to(torch.int32), 0, dtype=torch.int32) - 1
    num_valid = is_first.sum(dtype=torch.int32)
    vox_id = torch.where(s_valid & (ranks < v), ranks,
                         torch.full_like(ranks, v))

    point2voxel = torch.empty((n,), dtype=torch.int32, device=dev)
    point2voxel[s_idx.long()] = vox_id
    counts = torch.zeros((v + 1,), dtype=torch.int32, device=dev)
    counts.scatter_add_(0, vox_id.long(), torch.ones_like(vox_id))
    counts = counts[:v]
    grid = SparseGrid(
        coords=_scatter_drop(0, (v, 4), torch.int32, vox_id, s_coords),
        key_hi=_scatter_drop(INVALID_KEY, (v,), torch.int32, vox_id, s_hi),
        key_lo=_scatter_drop(INVALID_KEY, (v,), torch.int32, vox_id, s_lo),
        valid=counts > 0,
        counts=counts,
        num_valid=num_valid)

    vox_feats = None
    if feats is not None:
        s_feats = feats[s_idx.long()]
        if mode == "first":
            s_feats = torch.where(is_first[:, None], s_feats,
                                  torch.zeros_like(s_feats))
        elif mode not in ("mean", "sum"):
            raise ValueError(f"voxelize mode {mode!r}")
        # voxel j's points are sorted rows [sum(counts[:j]), +counts[j]);
        # the rows past the last run (dropped, invalid) belong to none
        vox_feats = torch.segment_reduce(s_feats, "sum",
                                         lengths=counts.long(), axis=0,
                                         unsafe=True)
        if mode == "mean":
            denom = torch.clamp(counts, min=1).to(vox_feats.dtype)
            vox_feats = vox_feats / denom[:, None]
    return grid, vox_feats, point2voxel


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
