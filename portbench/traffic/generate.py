"""The one generator of the benchmark's traffic mixes.

A mix is a JSON file beside this one (``<name>.json``) of parameters;
:func:`generate` turns it and a seed into the scenes a cell trains on.
Two kinds:

- ``scenes``: ``num_scenes`` synthetic ScanNet-like rooms of
  ``points_per_scene`` points each;
- ``subclouds``: such rooms cut into radius-``radius_m`` balls around
  jittered grid anchors (those with at least ``min_points`` points),
  room after room until ``num_subclouds`` are cut, so that every seed
  trains on as many subclouds (at most ``4 * num_scenes`` rooms).

Frozen copies of ``tdwss_torch.data.synthetic.make_scene`` and
``tdwss_torch.data.dataset.expand_subclouds``, so that a change to the
program cannot change the yardstick.  Each room draws from
``SeedSequence([seed, i])`` and the anchors' jitter from
``SeedSequence([seed, 2**20])``, so one seed gives the same scenes on
every run, and any whole number (also one over 32 bits) is a seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

@dataclass
class RawScene:
    """One room or subcloud in metre space: points (N, 3) f32,
    colors (N, 3) f32 in [-1, 1], labels (N,) int32 (-100 unlabelled)."""

    points: np.ndarray
    colors: np.ndarray
    labels: np.ndarray
    name: str


def _slab(rng, n, origin, extent, axis):
    """Uniform points on a thin axis-aligned slab."""
    p = origin + rng.random((n, 3)) * extent
    p[:, axis] = origin[axis] + rng.normal(scale=0.01, size=n)
    return p


def make_room(rng: np.random.Generator, num_points: int, room: float,
              num_objects: int, name: str) -> RawScene:
    """A floor, four walls and ``num_objects`` boxes of random classes,
    ~2% of points unlabelled, colours correlated with the class."""
    chunks, labels = [], []
    n_floor = num_points // 4
    chunks.append(_slab(rng, n_floor, np.zeros(3), np.array([room, room, 0]),
                        2))
    labels.append(np.full(n_floor, 1))
    n_wall = num_points // 8
    for axis, pos in [(0, 0.0), (0, room), (1, 0.0), (1, room)]:
        origin = np.zeros(3)
        origin[axis] = pos
        extent = np.array([room, room, 2.5])
        extent[axis] = 0
        chunks.append(_slab(rng, n_wall, origin, extent, axis))
        labels.append(np.full(n_wall, 0))
    remaining = num_points - sum(c.shape[0] for c in chunks)
    classes = rng.integers(2, 20, num_objects)
    per_obj = max(remaining // max(num_objects, 1), 1)
    for cls in classes:
        size = rng.uniform(0.3, 1.2, 3)
        origin = rng.uniform(0.2, room - 1.4, 3)
        origin[2] = 0
        n_face = max(per_obj // 6, 1)
        for axis in range(3):
            for side in (0.0, 1.0):
                o = origin.copy()
                o[axis] += side * size[axis]
                extent = size.copy()
                extent[axis] = 0
                chunks.append(_slab(rng, n_face, o, extent, axis))
                labels.append(np.full(n_face, cls))
    points = np.concatenate(chunks).astype(np.float32)
    lab = np.concatenate(labels).astype(np.int32)
    if points.shape[0] >= num_points:
        sel = rng.permutation(points.shape[0])[:num_points]
        points, lab = points[sel], lab[sel]
    lab = np.where(rng.random(points.shape[0]) < 0.02, -100, lab)
    palette = np.linspace(-1, 1, 20)
    base = palette[np.clip(lab, 0, 19)]
    colors = (np.stack([base, np.roll(base, 1), -base], axis=1)
              .astype(np.float32)
              + rng.normal(scale=0.1, size=(points.shape[0], 3))
              .astype(np.float32))
    points = points - points.mean(0, keepdims=True)
    return RawScene(points=points.astype(np.float32),
                    colors=np.clip(colors, -1, 1).astype(np.float32),
                    labels=lab.astype(np.int32), name=name)


def _anchors(points: np.ndarray, radius: float) -> np.ndarray:
    """A regular grid of anchors spanning the cloud, ``radius`` apart."""
    mins, maxs = points.min(0), points.max(0)
    axes = [np.linspace(mins[d], maxs[d],
                        max(int(np.floor((maxs[d] - mins[d]) / radius) + 1),
                            1)) for d in range(3)]
    grid = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.reshape(-1) for g in grid], axis=-1)


def cut_subclouds(rooms: List[RawScene], radius: float, min_points: int,
                  rng: np.random.Generator) -> List[RawScene]:
    """Radius balls around grid anchors jittered by normal(0, radius/10),
    room by room, those of at least ``min_points`` points."""
    from scipy.spatial import cKDTree

    out = []
    for room in rooms:
        tree = cKDTree(room.points)
        anchors = _anchors(room.points, radius)
        anchors = anchors + rng.normal(scale=radius / 10, size=anchors.shape)
        for k, idx in enumerate(tree.query_ball_point(anchors, radius)):
            idx = np.asarray(idx, np.int64)
            if idx.shape[0] < min_points:
                continue
            out.append(RawScene(points=room.points[idx],
                                colors=room.colors[idx],
                                labels=room.labels[idx],
                                name=f"{room.name}#sub{k}"))
    return out


def generate(mix: dict, seed: int) -> List[RawScene]:
    """The scenes of ``mix`` for ``seed``."""
    def rooms(lo, hi):
        return [make_room(np.random.default_rng(np.random.SeedSequence(
                    [seed, i])), mix["points_per_scene"], mix["room_m"],
                    mix["objects_per_room"], f"room{i:03d}")
                for i in range(lo, hi)]

    if mix["kind"] == "scenes":
        return rooms(0, mix["num_scenes"])
    if mix["kind"] == "subclouds":
        # rooms one after another until there are enough subclouds (a
        # room gives 15-20)
        jitter = np.random.default_rng(np.random.SeedSequence([seed, 2**20]))
        want, subs, i = mix["num_subclouds"], [], 0
        while len(subs) < want:
            if i >= 4 * mix["num_scenes"]:
                raise ValueError(f"seed {seed}: {len(subs)} subclouds from "
                                 f"{i} rooms, the mix asks for {want}")
            subs += cut_subclouds(rooms(i, i + 1), mix["radius_m"],
                                  mix["min_points"], jitter)
            i += 1
        return subs[:want]
    raise ValueError(f"unknown traffic kind {mix['kind']!r}")
