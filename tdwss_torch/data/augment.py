"""Host-side augmentation (twin of ``tdwss.data.augment``), numpy only.

Train recipe (reference dataset/data.py:165-181, 200): random 3x3 jitter
(sigma 0.1) + random x-flip + scale + random z-rotation, a random
translation fitting the cloud into [0, full_scale)^3, crop, colour
jitter +randn(3)*0.1; elastic deformation behind a flag.
Val recipe (reference dataset/data.py:266-281): random flip + z-rotation,
recentre at full_scale/2 +- U(-2, 2), fit offset, crop.  The draws from
``rng`` are the reference's, in its order, so one seed gives one view in
both packages.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def train_transform(
    points: np.ndarray,
    scale: float,
    full_scale: int,
    rng: np.random.Generator,
    elastic_deformation: bool = False,
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Augment metre-space points into grid coordinates.

    Returns (grid coords float32 (N, 3), keep mask (N,) bool, transform
    dict with the inverse pieces: rot_inv, offset).
    """
    m = np.eye(3) + rng.normal(size=(3, 3)) * 0.1
    m[0][0] *= rng.integers(0, 2) * 2 - 1
    m *= scale
    theta = rng.random() * 2 * np.pi
    rot = np.matmul(
        m,
        [
            [np.cos(theta), np.sin(theta), 0],
            [-np.sin(theta), np.cos(theta), 0],
            [0, 0, 1],
        ],
    )
    a = np.matmul(points.astype(np.float32, copy=False),
                  rot.astype(np.float32))
    if elastic_deformation:
        a = elastic(a, 6 * scale // 50, 40 * scale / 50)
        a = elastic(a, 20 * scale // 50, 160 * scale / 50)
    mn = a.min(0)
    mx = a.max(0)
    length = mx - mn
    offset = (
        -mn
        + np.clip(full_scale - length - 0.001, 0, None) * rng.random(3)
        + np.clip(full_scale - length + 0.001, None, 0) * rng.random(3)
    )
    a += offset.astype(np.float32)
    keep = (a.min(1) >= 0) & (a.max(1) < full_scale)
    transform = {"rot_inv": np.linalg.inv(rot), "offset": offset}
    return a, keep, transform


def color_jitter(colors: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Per-scene additive colour noise (reference data.py:200)."""
    return colors + rng.normal(size=3).astype(colors.dtype) * 0.1


def elastic(x: np.ndarray, granularity: float, magnitude: float,
            rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Elastic grid distortion (reference data_processing.py:8-21).

    Smooth random displacement fields sampled on a coarse grid (blurred
    three times per axis, twice), interpolated at the points and scaled by
    ``magnitude``.  Without ``rng`` the noise is unseeded, as in the
    reference's train recipe.
    """
    import scipy.interpolate
    import scipy.ndimage

    rng = rng or np.random.default_rng()
    blur = [np.ones((3, 1, 1)) / 3, np.ones((1, 3, 1)) / 3,
            np.ones((1, 1, 3)) / 3]
    bb = np.abs(x).max(0).astype(np.int32) // granularity + 3
    noise = [rng.normal(size=tuple(bb)).astype("float32") for _ in range(3)]
    for _ in range(2):
        for b in blur:
            noise = [scipy.ndimage.convolve(n, b, mode="constant", cval=0)
                     for n in noise]
    ax = [np.linspace(-(b - 1) * granularity, (b - 1) * granularity, b)
          for b in bb]
    interp = [scipy.interpolate.RegularGridInterpolator(
        ax, n, bounds_error=False, fill_value=0) for n in noise]
    return x + np.stack([i(x) for i in interp], axis=-1) * magnitude


def val_transform(
    points: np.ndarray,
    scale: float,
    full_scale: int,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Val-time random view; returns (grid_coords, keep_mask)."""
    m = np.eye(3)
    m[0][0] *= rng.integers(0, 2) * 2 - 1
    m *= scale
    theta = rng.random() * 2 * np.pi
    m = np.matmul(
        m,
        [
            [np.cos(theta), np.sin(theta), 0],
            [-np.sin(theta), np.cos(theta), 0],
            [0, 0, 1],
        ],
    )
    a = (np.matmul(points.astype(np.float32, copy=False),
                   m.astype(np.float32))
         + np.float32(full_scale / 2)
         + rng.uniform(-2, 2, 3).astype(np.float32))
    mn = a.min(0)
    mx = a.max(0)
    offset = (
        -mn
        + np.clip(full_scale - mx + mn - 0.001, 0, None) * rng.random(3)
        + np.clip(full_scale - mx + mn + 0.001, None, 0) * rng.random(3)
    )
    a += offset.astype(np.float32)
    keep = (a.min(1) >= 0) & (a.max(1) < full_scale)
    return a, keep


def scene_label_from_points(point_labels: np.ndarray,
                            num_classes: int = 20) -> np.ndarray:
    """Scene-level multi-label tag derived from point labels."""
    inds = np.unique(point_labels).astype(np.int64)
    inds = inds[(inds >= 0) & (inds < num_classes)]
    tag = np.zeros(num_classes, np.float32)
    tag[inds] = 1.0
    return tag
