"""Mesh utilities (twin of :mod:`tdwss.utils.mesh`): rasterize a triangle
mesh to a point cloud, and a triangulated cylinder (reference
utils/mesh.py:37-150), host numpy.

Interior points come from a grid of spacing ``dl`` over each face, edge
points from 1D grids along each side, plus the vertices themselves.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _face_grid(face: np.ndarray, lengths: np.ndarray, sides: np.ndarray,
               dl: float) -> np.ndarray:
    """Interior + edge + vertex samples for one triangle (ref :74-117)."""
    pts = []
    if np.max(lengths) < dl:
        return np.mean(face, axis=0, keepdims=True)

    # Grid the two sides opposite the largest angle.
    a = int(np.argmax(lengths))
    b, c = (a + 1) % 3, (a + 2) % 3
    u = -sides[b] / lengths[b]
    v = sides[c] / lengths[c]
    s1 = (lengths[b] % dl) / 2
    s2 = (lengths[c] % dl) / 2
    x, y = np.meshgrid(np.arange(s1, lengths[b], dl),
                       np.arange(s2, lengths[c], dl))
    x, y = x.ravel(), y.ravel()
    inside = x / lengths[b] + y / lengths[c] <= 1
    pts.append(face[a] + x[inside, None] * u + y[inside, None] * v)

    # Sample the three edges.
    for e in range(3):
        direction = sides[e] / lengths[e]
        start = face[(e + 1) % 3]
        t = np.arange((lengths[e] % dl) / 2, lengths[e], dl)
        pts.append(start + t[:, None] * direction)

    pts.append(face)
    return np.vstack(pts)


def rasterize_mesh(vertices: np.ndarray, faces: np.ndarray, dl: float
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Point cloud from a triangle mesh with ~dl point spacing.

    Returns (points (N,3) float32, vert_inds (N,) int — index of the
    nearest source vertex per sample, as the reference uses for carrying
    per-vertex attributes onto the cloud).
    """
    vertices = np.asarray(vertices, np.float64)
    faces = np.asarray(faces, np.int64)

    faces3d = vertices[faces]                              # (F, 3, 3)
    sides = np.stack([faces3d[:, i] - faces3d[:, i - 1] for i in (2, 0, 1)],
                     axis=1)                               # (F, 3, 3)
    lengths = np.linalg.norm(sides, axis=-1)               # (F, 3)
    keep = np.min(lengths, axis=-1) > 1e-9                 # degenerate faces
    faces, faces3d = faces[keep], faces3d[keep]
    sides, lengths = sides[keep], lengths[keep]

    all_points, all_inds = [], []
    for fv, face, ln, sd in zip(faces, faces3d, lengths, sides):
        pts = _face_grid(face, ln, sd, dl)
        d = np.sum((pts[:, None, :] - face[None]) ** 2, axis=2)
        all_points.append(pts)
        all_inds.append(fv[np.argmin(d, axis=1)])
    if not all_points:
        return np.zeros((0, 3), np.float32), np.zeros((0,), np.int64)
    return (np.vstack(all_points).astype(np.float32),
            np.hstack(all_inds))


def cylinder_mesh(cylinder: np.ndarray, precision: int = 24
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Triangulated cylinder [cx, cy, cz, height, radius] (ref :123-150)."""
    cylinder = np.asarray(cylinder, np.float64)
    center, h, r = cylinder[:3], cylinder[3], cylinder[4]
    thetas = np.arange(precision) * (2.0 * np.pi / precision)
    cx, cy = r * np.cos(thetas), r * np.sin(thetas)
    top = np.stack([cx, cy, np.full(precision, h / 2)], axis=1)
    bottom = np.stack([cx, cy, np.full(precision, -h / 2)], axis=1)
    verts = np.vstack([[[0, 0, h / 2], [0, 0, -h / 2]], top, bottom]) + center

    nxt = lambda i: (i + 1) % precision  # noqa: E731
    top_f = [[0, 2 + i, 2 + nxt(i)] for i in range(precision)]
    bot_f = [[1, 2 + precision + i, 2 + precision + nxt(i)]
             for i in range(precision)]
    side1 = [[2 + i, 2 + precision + i, 2 + precision + nxt(i)]
             for i in range(precision)]
    side2 = [[2 + precision + nxt(i), 2 + i, 2 + nxt(i)]
             for i in range(precision)]
    faces = np.array(top_f + bot_f + side1 + side2, np.int32)
    return verts.astype(np.float32), faces
