"""Brick-form submanifold convolution.

Twin of ``tdwss/ops/experimental/brick_conv.py``: a 3^3 submanifold
convolution computed as a dense ``conv3d`` over the occupied bricks of a
``BrickPlan``.  Fill the bricks from the voxel array, assemble a one-cell
halo from the 26 adjacent bricks (one gather of a neighbour's face, edge
or corner per offset), convolve VALID, and read the occupied cells back.
Equal to :func:`tdwss_torch.ops.sparse_conv.subm_conv_apply` at the
occupied cells: empty cells are zero, so missing neighbours add nothing.

Every absent source reads zero, as the reference's ``jnp.take(...,
mode="fill")`` does: a cell whose ``cell2vox`` is V, a neighbour
``neighbors == B`` and a voxel whose ``vox2cell`` is ``B * S^3`` (outside
the brick capacity).  ``_gather_rows`` moves an out-of-range index into
range and zeroes its row, so no index ever wraps.

The conv is ``torch.nn.functional.conv3d`` in the input's dtype (the
reference leaves it to XLA's ``conv_general_dilated``, outside any Pallas
kernel); cuDNN and oneDNN accumulate a bf16 convolution in f32, as the
reference's ``preferred_element_type=f32`` does, and round the result
once.  Gradients come from autograd over these operations, as JAX
differentiates the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tdwss_torch.ops.experimental.brick_plan import (_NEIGHBOR_OFFSETS,
                                                     BrickPlan)
from tdwss_torch.ops.sparse_conv import _gather_rows


def plan_to(plan: BrickPlan, device) -> BrickPlan:
    """The plan with its index arrays as tensors on ``device``."""
    def dev(a):
        return torch.as_tensor(a, device=device)

    return plan._replace(cell2vox=dev(plan.cell2vox),
                         vox2cell=dev(plan.vox2cell),
                         neighbors=dev(plan.neighbors))


def _fill_bricks(vox_feats: torch.Tensor, plan: BrickPlan) -> torch.Tensor:
    """(V, C) -> (B, S, S, S, C) dense bricks (empty cells zero)."""
    s = plan.size
    c = vox_feats.shape[-1]
    cell2vox = torch.as_tensor(plan.cell2vox, device=vox_feats.device)
    flat = _gather_rows(vox_feats, cell2vox.reshape(-1))
    return flat.reshape(-1, s, s, s, c)


def _halo_pad(bricks: torch.Tensor, neighbors: torch.Tensor) -> torch.Tensor:
    """(B, S, S, S, C) -> (B, S+2, S+2, S+2, C) with neighbour halos.

    For each of the 26 offsets, the needed slice of the neighbour brick
    is gathered (missing neighbour -> zero) and placed into the halo
    shell.  The halo writes touch only the shell and the gathers read
    only ``bricks``, so the order of the offsets does not matter.
    """
    b, s = bricks.shape[0], bricks.shape[1]
    c = bricks.shape[-1]
    padded = bricks.new_zeros((b, s + 2, s + 2, s + 2, c))
    padded[:, 1:s + 1, 1:s + 1, 1:s + 1] = bricks

    def src_slice(d):
        # offset +1 means the neighbour brick ABOVE us on that axis: we
        # need its LOW face; -1 its HIGH face; 0 keeps the whole axis.
        return {1: slice(0, 1), -1: slice(s - 1, s), 0: slice(0, s)}[int(d)]

    def dst_slice(d):
        return {1: slice(s + 1, s + 2), -1: slice(0, 1),
                0: slice(1, s + 1)}[int(d)]

    for j, (dx, dy, dz) in enumerate(_NEIGHBOR_OFFSETS):
        piece = bricks[:, src_slice(dx), src_slice(dy), src_slice(dz), :]
        padded[:, dst_slice(dx), dst_slice(dy), dst_slice(dz), :] = (
            _gather_rows(piece, neighbors[:, j]))
    return padded


def brick_subm_conv(vox_feats: torch.Tensor, plan: BrickPlan,
                    weight: torch.Tensor) -> torch.Tensor:
    """Submanifold 3^3 conv over bricks; (V, Cin) -> (V, Cout) in
    vox_feats' dtype.

    weight (27, Cin, Cout) in the x-slowest tap order of
    ``tdwss_torch.ops.host_plan.kernel_offsets``.  The plan's arrays may
    be numpy or tensors (``plan_to`` moves them to the device once).
    """
    k, cin, cout = weight.shape
    if k != 27:
        raise ValueError("brick conv supports 3^3 kernels")
    dev = vox_feats.device
    bricks = _fill_bricks(vox_feats, plan)
    padded = _halo_pad(bricks, torch.as_tensor(plan.neighbors, device=dev))
    # bricks are (B, x, y, z, C) and the taps (dx, dy, dz) with x slowest:
    # NDHWC -> NCDHW as a view (channels-last 3-D strides), and the
    # weight (dx, dy, dz, Cin, Cout) -> (Cout, Cin, dx, dy, dz)
    kernel = weight.reshape(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2)
    y = F.conv3d(padded.permute(0, 4, 1, 2, 3), kernel.to(bricks.dtype))
    flat = y.permute(0, 2, 3, 4, 1).reshape(-1, cout)       # (B*S^3, Cout)
    vox2cell = torch.as_tensor(plan.vox2cell, device=dev)
    return _gather_rows(flat, vox2cell).to(vox_feats.dtype)
