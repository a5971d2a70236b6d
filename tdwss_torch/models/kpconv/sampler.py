"""Potential-based spherical sampling for KPConv training (twin of
:mod:`tdwss.models.kpconv.sampler`; host-side).

Every sample is an ``in_radius`` sphere of points; sphere centres are
chosen as the global minimum of per-cloud *potentials* kept over a
coarse potential grid, and each draw bumps the potentials of the visited
region with Tukey weights ``(1 - d^2/R^2)^2``, so successive samples
spread over all clouds.  One ``threading.Lock`` guards the selection and
the update; KD-trees are scipy ``cKDTree``; the random stream is the
reference's (``numpy.random.default_rng(seed)``, drawn in the same
order), so the same seed gives the same draws.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy.spatial import cKDTree

from tdwss_torch import native


class PotentialSampler:
    """Draws in_radius spheres, least-visited regions first."""

    def __init__(self, clouds: Sequence[Dict], in_radius: float = 2.0,
                 potential_dl: float = 0.1, seed: int = 0):
        """clouds: dicts with 'points' (Ni,3); potential_dl: grid step of the
        coarse potential point set (ref uses pot_dl = in_radius / 10)."""
        self.in_radius = float(in_radius)
        self.rng = np.random.default_rng(seed)
        self.lock = threading.Lock()
        self.trees: List[cKDTree] = []
        self.pot_trees: List[cKDTree] = []
        self.potentials: List[np.ndarray] = []
        for cloud in clouds:
            pts = np.asarray(cloud["points"], np.float32)
            sub, _, _ = native.grid_subsample(pts, cell_size=potential_dl)
            self.trees.append(cKDTree(pts))
            self.pot_trees.append(cKDTree(sub))
            # Small random init so ties break randomly (ref :158-165).
            self.potentials.append(
                self.rng.random(sub.shape[0]).astype(np.float64) * 1e-3)

    def sample(self) -> Tuple[int, np.ndarray, np.ndarray]:
        """Returns (cloud_index, center (3,), point_indices into the cloud).

        Thread-safe: potential selection + Tukey update run under the lock
        (reference worker_lock, KPConv_Scannet.py:263-305).
        """
        with self.lock:
            mins = np.array([p.min() for p in self.potentials])
            ci = int(np.argmin(mins))
            pot = self.potentials[ci]
            pi = int(np.argmin(pot))
            pot_pts = np.asarray(self.pot_trees[ci].data)
            center = pot_pts[pi] + self.rng.normal(
                scale=self.in_radius / 10, size=3)
            # Tukey-weight the potentials of the visited region (ref :300-306)
            pot_inds = self.pot_trees[ci].query_ball_point(
                center, self.in_radius)
            pot_inds = np.asarray(pot_inds, np.int64)
            if pot_inds.size:
                d2 = np.sum((pot_pts[pot_inds] - center) ** 2, axis=1)
                tukey = np.square(1 - d2 / self.in_radius**2)
                tukey[d2 > self.in_radius**2] = 0
                pot[pot_inds] += tukey
        idx = np.asarray(
            self.trees[ci].query_ball_point(center, self.in_radius), np.int64)
        return ci, center.astype(np.float32), idx

    def sample_batch(self, num_spheres: int, min_points: int = 1
                     ) -> List[Tuple[int, np.ndarray, np.ndarray]]:
        """Draw spheres until ``num_spheres`` have >= min_points points
        (reference's failed_attempts loop, :316-330)."""
        out, attempts = [], 0
        while len(out) < num_spheres and attempts < 100 * num_spheres:
            attempts += 1
            ci, center, idx = self.sample()
            if idx.size >= min_points:
                out.append((ci, center, idx))
        return out
