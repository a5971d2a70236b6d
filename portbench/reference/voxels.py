"""Voxels and rulebooks of a batch, in plain PyTorch.

The levels the sparse UNet and FCN bodies run on: level 0 voxelizes the
points (each voxel the mean of its points' features), level l+1 holds the
cells ``floor(x / 2)`` of level l.  A level holds at most its capacity
of voxels, those with the smallest keys in (scene, z, y, x) order, as
the program keeps them (a point or child whose voxel was dropped reads
nothing).  Rulebooks are lists of live (output, input) pairs per tap:

- submanifold 3x3x3: tap ``(dx + 1) * 9 + (dy + 1) * 3 + (dz + 1)``, the
  input the voxel at ``output + (dx, dy, dz)``;
- stride 2, filter 2: tap ``(x % 2) * 4 + (y % 2) * 2 + (z % 2)`` of the
  child; the strided conv sums children into parents, the deconv and
  the unpool read the parent.

Used by the reference and by the work counter alike; it imports nothing
of the program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

BITS = 12


def keys(coords: torch.Tensor) -> torch.Tensor:
    """int64 keys of (V, 4) [x, y, z, scene] coordinates, ordered by
    (scene, z, y, x)."""
    c = coords.long()
    return ((((c[:, 3] << BITS) | c[:, 2]) << 32)
            | ((c[:, 1] << BITS) | c[:, 0]))


@dataclass
class Level:
    """coords (V, 4) int64, key-sorted; keys (V,); counts (V,) points
    (level 0) or children per voxel."""

    coords: torch.Tensor
    keys: torch.Tensor
    counts: torch.Tensor

    @property
    def size(self) -> int:
        return int(self.coords.shape[0])


def dedup(coords: torch.Tensor, capacity: int) -> Tuple[Level, torch.Tensor]:
    """The level of ``coords`` (kept to ``capacity`` voxels) and each
    row's voxel (-1 where dropped)."""
    k = keys(coords)
    uniq, inv, counts = torch.unique(k, sorted=True, return_inverse=True,
                                     return_counts=True)
    kept = min(int(uniq.shape[0]), int(capacity))
    uniq, counts = uniq[:kept], counts[:kept]
    owner = torch.where(inv < kept, inv, torch.full_like(inv, -1))
    vc = torch.stack([uniq & 0xFFF, (uniq >> BITS) & 0xFFF,
                      (uniq >> 32) & 0xFFF, uniq >> (32 + BITS)], dim=1)
    return Level(coords=vc, keys=uniq, counts=counts), owner


def capacities(base: int, num_levels: int, shrink: int, min_capacity: int,
               schedule: Sequence[int] = ()) -> List[int]:
    """Each level's voxel capacity, as the configuration sets it."""
    caps, cap = [], base
    for lvl in range(num_levels):
        caps.append(max(int(cap), min(min_capacity, base)))
        div = schedule[min(lvl, len(schedule) - 1)] if schedule else shrink
        cap = cap // max(int(div), 1)
    return caps


def lookup(level: Level, query: torch.Tensor) -> torch.Tensor:
    """Index in ``level`` of each (Q, 4) query coordinate, -1 if absent
    or out of range."""
    ok = ((query[:, :3] >= 0) & (query[:, :3] < (1 << BITS))).all(dim=1)
    qk = keys(query.clamp(min=0))
    pos = torch.searchsorted(level.keys, qk).clamp(max=max(level.size - 1, 0))
    hit = ok & (level.keys[pos] == qk) if level.size else ok & False
    return torch.where(hit, pos, torch.full_like(pos, -1))


def subm_pairs(level: Level) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per tap of the 3x3x3 kernel, (output rows, input rows) of its
    live pairs."""
    out = []
    rows = torch.arange(level.size, device=level.coords.device)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                off = torch.tensor([dx, dy, dz, 0], device=rows.device)
                src = lookup(level, level.coords + off)
                live = src >= 0
                out.append((rows[live], src[live]))
    return out


@dataclass
class Down:
    """A level's map to the next: each child's parent (-1 if dropped) and
    tap."""

    parent: torch.Tensor
    tap: torch.Tensor


def build_levels(coords: torch.Tensor, caps: Sequence[int]
                 ) -> Tuple[List[Level], List[Down], torch.Tensor]:
    """The levels of the points ``coords`` (N, 4), the maps between them,
    and each point's voxel at level 0."""
    level, point_voxel = dedup(coords, caps[0])
    levels, downs = [level], []
    for cap in caps[1:]:
        c = level.coords
        coarse = torch.cat([c[:, :3] // 2, c[:, 3:]], dim=1)
        nxt, parent = dedup(coarse, cap)
        tap = (c[:, 0] % 2) * 4 + (c[:, 1] % 2) * 2 + (c[:, 2] % 2)
        downs.append(Down(parent=parent, tap=tap))
        levels.append(nxt)
        level = nxt
    return levels, downs, point_voxel
