"""The train batches of an epoch, worked out again from the raw scenes.

A frozen plain copy of what the program's train loader draws (the
reference project's trainMerge, ``dataset/data.py:165-200``): the
epoch's order from ``SeedSequence([seed, epoch])``, each batch's
augmentation from ``SeedSequence([seed, epoch, start])`` in the same
order of draws (3x3 jitter, x-flip, scale, z-rotation, a random fit into
``[0, full_scale)^3``, a crop, colour jitter per scene), scene tags from
the kept points' labels, and a uniform subset where the batch exceeds
``max_points``.  The reference and the work counter both read batches
from here; neither reads the program's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

NUM_CLASSES = 20


@dataclass
class RefBatch:
    """coords (N, 4) int64 [x, y, z, scene]; feats (N, 3) f32; labels
    (B, 20) f32 scene tags."""

    coords: np.ndarray
    feats: np.ndarray
    scene_label: np.ndarray


def epoch_starts(num_scenes: int, batch_size: int) -> List[int]:
    """The start of every batch of an epoch (drop_last)."""
    return list(range(0, num_scenes - batch_size + 1, batch_size))


def _augment(points, scale, full_scale, rng):
    m = np.eye(3) + rng.normal(size=(3, 3)) * 0.1
    m[0][0] *= rng.integers(0, 2) * 2 - 1
    m *= scale
    theta = rng.random() * 2 * np.pi
    rot = np.matmul(m, [[np.cos(theta), np.sin(theta), 0],
                        [-np.sin(theta), np.cos(theta), 0], [0, 0, 1]])
    a = np.matmul(points.astype(np.float32), rot.astype(np.float32))
    mn, mx = a.min(0), a.max(0)
    length = mx - mn
    offset = (-mn
              + np.clip(full_scale - length - 0.001, 0, None) * rng.random(3)
              + np.clip(full_scale - length + 0.001, None, 0) * rng.random(3))
    a += offset.astype(np.float32)
    keep = (a.min(1) >= 0) & (a.max(1) < full_scale)
    return a, keep


def _tags(labels: np.ndarray) -> np.ndarray:
    inds = np.unique(labels).astype(np.int64)
    inds = inds[(inds >= 0) & (inds < NUM_CLASSES)]
    tag = np.zeros(NUM_CLASSES, np.float32)
    tag[inds] = 1.0
    return tag


def train_batch(scenes: Sequence, params: dict, seed: int, epoch: int,
                start: int) -> RefBatch:
    """The batch at ``start`` of ``epoch``.  ``params`` holds ``scale``,
    ``full_scale``, ``batch_size`` and ``max_points``."""
    if params.get("elastic_deformation"):
        raise ValueError("elastic deformation draws unseeded noise: no "
                         "seed gives its batches again")
    order = np.random.default_rng(
        np.random.SeedSequence([seed, epoch])).permutation(len(scenes))
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch, start]))
    coords, feats, tags = [], [], []
    for idx, i in enumerate(order[start:start + params["batch_size"]]):
        scene = scenes[i]
        a, keep = _augment(scene.points, params["scale"],
                           params["full_scale"], rng)
        c = a[keep].astype(np.int64)
        coords.append(np.concatenate(
            [c, np.full((c.shape[0], 1), idx, np.int64)], axis=1))
        feats.append(scene.colors[keep]
                     + rng.normal(size=3).astype(np.float32) * 0.1)
        tags.append(_tags(scene.labels[keep]))
    coords = np.concatenate(coords)
    feats = np.concatenate(feats).astype(np.float32)
    n, cap = coords.shape[0], params["max_points"]
    if n > cap:
        keep = np.sort(rng.permutation(n)[:cap])
        coords, feats = coords[keep], feats[keep]
    return RefBatch(coords=coords, feats=feats, scene_label=np.stack(tags))
