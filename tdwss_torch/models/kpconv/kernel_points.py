"""Kernel-point dispositions (twin of
:mod:`tdwss.models.kpconv.kernel_points`; host-side numpy).

K points inside the unit ball at the equilibrium of a repulsion
(:func:`kernel_point_optimization`) or as Voronoi cell centres
(:func:`spherical_lloyd`), optionally with the first point fixed at the
origin ('center') or the first three on the vertical axis
('verticals'), rescaled so the mean point radius hits a target ratio and
scaled to the kernel radius.  Seeded generators and the same arithmetic
as the reference give the same points bit for bit; :func:`load_kernels`
caches each disposition in the process.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

_CACHE: Dict[Tuple[int, int, str], np.ndarray] = {}


def _apply_fixed(points: np.ndarray, fixed: str) -> np.ndarray:
    if fixed in ("center", "verticals"):
        points[0, :] = 0.0
    if fixed == "verticals":
        points[1, :] = 0.0
        points[2, :] = 0.0
        points[1, -1] = 2.0 / 3.0
        points[2, -1] = -2.0 / 3.0
    return points


def kernel_point_optimization(
    num_points: int,
    dimension: int = 3,
    fixed: str = "center",
    ratio: float = 0.66,
    num_iter: int = 300,
    seed: int = 42,
) -> np.ndarray:
    """Optimize K repelling points in the unit ball; returns (K, dim).

    Mirrors kernel_point_optimization_debug (reference
    models/KPConv/kernel_points.py:258-405): inverse-square repulsion
    between points, linear attraction to the center, fixed points held in
    place, moves clipped, then a rescale so the mean non-center radius is
    ``ratio``.
    """
    rng = np.random.default_rng(seed)
    # Rejection-sample initial points inside the ball of radius 1.
    points = np.zeros((0, dimension))
    while points.shape[0] < num_points:
        cand = rng.uniform(-1.0, 1.0, size=(4 * num_points, dimension))
        cand = cand[np.sum(cand**2, axis=1) < 0.5]
        points = np.concatenate([points, cand], axis=0)
    points = points[:num_points].copy()
    points = _apply_fixed(points, fixed)

    n_fixed = {"none": 0, "center": 1, "verticals": 3}[fixed]
    moving_factor = 1e-2
    continuous_moving_decay = 0.9995
    clip = 0.05

    for _ in range(num_iter):
        diff = points[:, None, :] - points[None, :, :]          # (K, K, d)
        sq = np.sum(diff**2, axis=-1)                            # (K, K)
        np.fill_diagonal(sq, 1.0)
        # Inverse-square repulsion (gradient of sum 1/r), capped near 0.
        inv = diff / np.maximum(sq, 1e-6)[:, :, None] ** 1.5
        np.einsum("iid->id", inv)[...] = 0.0
        grad = np.sum(inv, axis=1)
        # Attraction back toward the center keeps points in the ball.
        grad -= points * 4.0
        step = np.clip(moving_factor * grad, -clip, clip)
        if fixed == "verticals":
            step[:3, :-1] = 0.0  # verticals may slide along z only
            step[0] = 0.0
        points[n_fixed:] += step[n_fixed:]
        if fixed == "verticals":
            points[1:3, -1] += step[1:3, -1]
        moving_factor *= continuous_moving_decay

    # Rescale so mean radius of non-center points == ratio (ref :400-403).
    radii = np.sqrt(np.sum(points**2, axis=-1))
    start = 1 if fixed in ("center", "verticals") else 0
    mean_r = np.mean(radii[start:]) if radii[start:].size else 1.0
    points *= ratio / max(mean_r, 1e-9)
    return points.astype(np.float32)


def spherical_lloyd(num_cells: int, dimension: int = 3,
                    fixed: str = "center", approx_n: int = 5000,
                    max_iter: int = 500, momentum: float = 0.9,
                    seed: int = 42) -> np.ndarray:
    """Kernel points as Voronoi cell centers of the unit ball
    (reference kernel_points.py:78-257 spherical_Lloyd parity, Monte-Carlo
    approximation), deterministic via a seeded RNG.

    Each iteration samples ``approx_n`` uniform ball points, assigns them
    to the nearest kernel point (Voronoi cells), and moves every kernel
    point toward its cell's centroid through a momentum low-pass filter;
    the reference's 'fixed' pinning ('center' / 'verticals') is re-applied
    after every move.  Used by the KPConv deformable variant in the
    reference; selectable here via ``load_kernels(..., lloyd=True)``.
    """
    rng = np.random.default_rng(seed)
    pts = np.zeros((0, dimension))
    while pts.shape[0] < num_cells:
        cand = rng.random((num_cells, dimension)) * 2.0 - 1.0
        pts = np.vstack([pts, cand])
        d2 = np.sum(pts ** 2, axis=1)
        pts = pts[(d2 < 1.0) & (d2 > 0.81)]
    kp = pts[:num_cells].astype(np.float64)
    kp = _apply_fixed(kp, fixed)

    for _ in range(max_iter):
        # uniform ball sample (normalize gaussian, radius ~ U^(1/dim))
        g = rng.standard_normal((approx_n, dimension))
        g /= np.maximum(np.linalg.norm(g, axis=1, keepdims=True), 1e-9)
        x = g * rng.random((approx_n, 1)) ** (1.0 / dimension)
        d2 = np.sum((x[:, None, :] - kp[None, :, :]) ** 2, axis=2)
        cells = np.argmin(d2, axis=1)
        centers = kp.copy()
        for c in range(num_cells):
            sel = cells == c
            if sel.any():
                centers[c] = x[sel].mean(axis=0)
        moves = (1.0 - momentum) * (centers - kp)
        kp = kp + moves
        if fixed == "center":
            kp[0] *= 0
        if fixed == "verticals":
            kp[0] *= 0
            kp[:3, :-1] *= 0
        if np.max(np.linalg.norm(moves, axis=1)) < 1e-5:
            break
    return kp.astype(np.float32)


def load_kernels(radius: float, num_kpoints: int, dimension: int = 3,
                 fixed: str = "center", lloyd: bool = False) -> np.ndarray:
    """(K, dim) kernel point disposition scaled to ``radius``.

    Parity with load_kernels (reference kernel_points.py:408-489) minus the
    per-process random rotation — rotation invariance is supplied by data
    augmentation, and a deterministic disposition keeps checkpoints
    portable.  ``lloyd`` selects the spherical-Lloyd disposition the
    reference uses for deformable kernels (else the repulsion optimizer).
    """
    key = (num_kpoints, dimension, fixed, lloyd)
    if key not in _CACHE:
        if lloyd:
            _CACHE[key] = spherical_lloyd(
                num_kpoints, dimension=dimension, fixed=fixed)
        else:
            _CACHE[key] = kernel_point_optimization(
                num_kpoints, dimension=dimension, fixed=fixed
            )
    return _CACHE[key] * np.float32(radius)
