"""Integer voxel-coordinate keys and sorted lookup (twin of
:mod:`tdwss.ops.coords`).

A voxel coordinate ``(x, y, z, b)`` with ``0 <= x, y, z < 4096`` packs
into two int32 keys ``(hi, lo) = ((b << 12) | z, (y << 12) | x)``, which
order voxels lexicographically (b, z, y, x).  Voxel sets are kept sorted
by ``(hi, lo)`` (:func:`tdwss_torch.ops.voxelize.voxelize` sorts them
so), and a neighbour query is a binary search in that order.

Here the pair is compared as one int64, ``(hi << 32) | (lo & 0xffffffff)``:
every ``lo`` that :func:`make_keys` gives is non-negative (a packed
coordinate or ``INVALID_KEY``), so the int64 order is the pair's order,
and the one negative query key, ``INVALID_QUERY`` in both halves, is -1,
below every key.  Sorting is ``torch.sort(stable=True)``, the reference's
``lax.sort(num_keys=2, is_stable=True)``; the search is
``torch.searchsorted`` (the reference's own binary search runs outside
any Pallas kernel too).

Coordinates are ``(V, 4) int32 = [x, y, z, b]``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

COORD_BITS = 12                    # full_scale <= 4096 per axis
COORD_MAX = 1 << COORD_BITS
INVALID_KEY = 2**31 - 1            # sorts after every valid key
INVALID_QUERY = -1                 # sorts before every valid key: no match


def make_keys(coords: torch.Tensor, valid: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) int32 keys of (x, y, z, b) coordinates; invalid rows get
    ``INVALID_KEY`` so that they sort to the end."""
    coords = coords.to(torch.int32)
    x, y, z, b = coords.unbind(1)
    hi = torch.where(valid, (b << COORD_BITS) | z,
                     torch.full_like(b, INVALID_KEY))
    lo = torch.where(valid, (y << COORD_BITS) | x,
                     torch.full_like(x, INVALID_KEY))
    return hi, lo


def make_query_keys(coords: torch.Tensor, valid: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keys of neighbour queries: an out-of-range or invalid query gets
    ``INVALID_QUERY`` and matches nothing."""
    coords = coords.to(torch.int32)
    x, y, z, b = coords.unbind(1)
    ok = (valid & (x >= 0) & (x < COORD_MAX) & (y >= 0) & (y < COORD_MAX)
          & (z >= 0) & (z < COORD_MAX))
    hi = torch.where(ok, (b << COORD_BITS) | z,
                     torch.full_like(b, INVALID_QUERY))
    lo = torch.where(ok, (y << COORD_BITS) | x,
                     torch.full_like(x, INVALID_QUERY))
    return hi, lo


def combine_keys(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The (hi, lo) pair as one int64 with the pair's order (``lo`` is
    taken as unsigned: see the module docstring)."""
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)


def lookup_sorted(key_hi: torch.Tensor, key_lo: torch.Tensor,
                  q_hi: torch.Tensor, q_lo: torch.Tensor) -> torch.Tensor:
    """Index of each query (q_hi, q_lo) in the ascending keys, or -1
    (int32).  The keys' invalid slots hold ``INVALID_KEY`` at the tail."""
    keys = combine_keys(key_hi, key_lo)
    q = combine_keys(q_hi, q_lo)
    n = keys.shape[0]
    pos = torch.searchsorted(keys, q)
    hit = (pos < n) & (keys[pos.clamp(max=n - 1)] == q)
    return torch.where(hit, pos, torch.full_like(pos, -1)).to(torch.int32)


def sort_by_keys(hi: torch.Tensor, lo: torch.Tensor, *operands: torch.Tensor):
    """Stable sort of ``(hi, lo) + operands`` by (hi, lo): equal keys keep
    their input order."""
    perm = torch.sort(combine_keys(hi, lo), stable=True).indices
    return (hi[perm], lo[perm]) + tuple(op[perm] for op in operands)


def kernel_offsets(size: int, dimension: int = 3) -> np.ndarray:
    """All filter offsets of a cubic kernel, (size**dim, dim) int32: odd
    sizes centred (3 -> [-1, 0, 1]^3), even sizes over [0, size); x
    varies slowest."""
    if size % 2 == 1:
        rng = np.arange(size) - size // 2
    else:
        rng = np.arange(size)
    grids = np.meshgrid(*([rng] * dimension), indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=-1).astype(np.int32)
