"""Host-side brick decomposition of a sparse voxel level.

Twin of ``tdwss/ops/experimental/brick_plan.py`` over the port's
``SparseGrid``: occupied 8^3 bricks hold the level's voxels as dense
blocks so that a submanifold convolution can run as a dense ``conv3d``
over (B, 8, 8, 8, C) tensors, with halos taken from adjacent bricks
instead of per-voxel gathers (``brick_conv``).

This module builds the static metadata on the host:
- which bricks are occupied, their grid coordinates and scene ids;
- the dense cell <-> voxel index maps (fill / readout);
- the 26-neighbourhood adjacency between occupied bricks (halo sources).

All outputs are padded to a brick capacity that only grows per (V, S)
(sticky, as the windowed plans' capacities are), so batch shapes stay
stable.  Every field is byte-identical to the reference's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from tdwss_torch.ops.plan import SparseGrid

_BRICK_REGISTRY: dict = {}


class BrickPlan(NamedTuple):
    """Static-shape brick metadata for one pyramid level.

    cell2vox:     (B, S^3) int32   voxel id per dense cell, V where empty
    vox2cell:     (V,) int32       flat cell index per voxel (B*S^3 when the
                                   voxel fell outside brick capacity)
    neighbors:    (B, 26) int32    adjacent occupied brick ids, B if absent
                                   (offset order: ``_NEIGHBOR_OFFSETS``)
    brick_coords: (B, 4) int32     [bx, by, bz, scene], zero at padding
    brick_valid:  (B,) bool
    num_bricks:   int              true occupied count (may exceed capacity)
    size:         int              brick side S
    """

    cell2vox: np.ndarray
    vox2cell: np.ndarray
    neighbors: np.ndarray
    brick_coords: np.ndarray
    brick_valid: np.ndarray
    num_bricks: int
    size: int


# 26-neighbourhood offsets (dx, dy, dz), x slowest and z fastest, without
# the centre; the order fixes the columns of ``neighbors``.
_NEIGHBOR_OFFSETS = np.array(
    [(dx, dy, dz)
     for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
     if (dx, dy, dz) != (0, 0, 0)], np.int64)


def reset_brick_caps() -> None:
    """Forget the sticky brick capacities (they only grow otherwise)."""
    _BRICK_REGISTRY.clear()


def _sticky_bcap(key, needed: int, floor: int) -> int:
    cap = floor
    while cap < needed:
        cap = int(cap * 1.25) + 64
    cap = ((cap + 255) // 256) * 256
    cap = max(cap, _BRICK_REGISTRY.get(key, 0))
    _BRICK_REGISTRY[key] = cap
    return cap


def build_brick_plan(grid: SparseGrid, size: int = 8,
                     brick_cap: Optional[int] = None) -> BrickPlan:
    """Decompose a key-sorted voxel level into occupied size^3 bricks."""
    coords = np.asarray(grid.coords)
    valid = np.asarray(grid.valid)
    v = coords.shape[0]
    s3 = size ** 3

    bcoords = coords[:, :3] // size                         # (V, 3)
    scene = coords[:, 3].astype(np.int64)
    # brick key: scene-major, then z, y, x of the brick grid, 12 bits each
    bits = 12
    key = (((scene << (3 * bits)) | (bcoords[:, 2].astype(np.int64) << (2 * bits))
            | (bcoords[:, 1].astype(np.int64) << bits)
            | bcoords[:, 0].astype(np.int64)))
    key = np.where(valid, key, np.iinfo(np.int64).max)

    uniq, inv = np.unique(key, return_inverse=True)
    has_invalid = bool(uniq.size) and uniq[-1] == np.iinfo(np.int64).max
    n_bricks = int(uniq.size) - int(has_invalid)

    cap = brick_cap if brick_cap is not None else _sticky_bcap(
        (v, size), n_bricks, max(256, v // (s3 // 4)))

    in_cap = (inv < n_bricks) & (inv < cap) & valid
    # cells are x-major within a brick: x * S^2 + y * S + z
    cell_off = ((coords[:, 0] % size) * size * size
                + (coords[:, 1] % size) * size
                + coords[:, 2] % size).astype(np.int64)

    vox2cell = np.full((v,), cap * s3, np.int32)
    vox2cell[in_cap] = (inv[in_cap] * s3 + cell_off[in_cap]).astype(np.int32)

    cell2vox = np.full((cap * s3,), v, np.int32)
    cell2vox[vox2cell[in_cap]] = np.nonzero(in_cap)[0].astype(np.int32)
    cell2vox = cell2vox.reshape(cap, s3)

    kept = min(n_bricks, cap)
    brick_coords = np.zeros((cap, 4), np.int32)
    brick_valid = np.zeros((cap,), bool)
    if kept:
        k = uniq[:kept]
        brick_coords[:kept, 0] = (k & ((1 << bits) - 1)).astype(np.int32)
        brick_coords[:kept, 1] = ((k >> bits) & ((1 << bits) - 1)).astype(np.int32)
        brick_coords[:kept, 2] = ((k >> (2 * bits)) & ((1 << bits) - 1)).astype(np.int32)
        brick_coords[:kept, 3] = (k >> (3 * bits)).astype(np.int32)
        brick_valid[:kept] = True

    # adjacency: searchsorted of the neighbour keys in the sorted keys
    neighbors = np.full((cap, 26), cap, np.int32)
    if kept:
        base = uniq[:kept]
        for j, (dx, dy, dz) in enumerate(_NEIGHBOR_OFFSETS):
            nb_x = brick_coords[:kept, 0].astype(np.int64) + dx
            nb_y = brick_coords[:kept, 1].astype(np.int64) + dy
            nb_z = brick_coords[:kept, 2].astype(np.int64) + dz
            ok = ((nb_x >= 0) & (nb_x < (1 << bits))
                  & (nb_y >= 0) & (nb_y < (1 << bits))
                  & (nb_z >= 0) & (nb_z < (1 << bits)))
            nb_key = ((brick_coords[:kept, 3].astype(np.int64) << (3 * bits))
                      | (nb_z << (2 * bits)) | (nb_y << bits) | nb_x)
            pos = np.searchsorted(base, nb_key)
            pos_c = np.minimum(pos, kept - 1)
            hit = ok & (pos < kept) & (base[pos_c] == nb_key)
            neighbors[:kept, j] = np.where(hit, pos, cap).astype(np.int32)

    return BrickPlan(cell2vox=cell2vox, vox2cell=vox2cell,
                     neighbors=neighbors, brick_coords=brick_coords,
                     brick_valid=brick_valid, num_bricks=n_bricks, size=size)
