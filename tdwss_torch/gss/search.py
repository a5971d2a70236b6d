"""Geometric Selective Search: 3D box proposals from plane regions (twin
of :mod:`tdwss.gss.search`; offline, host numpy).

- plane regions come from region growing
  (:func:`tdwss_torch.native.region_grow`, the native library's, or its
  numpy version inside :func:`tdwss_torch.native.disabled`);
- unassigned points join their nearest assigned neighbour's region
  (reference shape_det/preprocess.py:26-58);
- regions are merged greedily by a weighted similarity of size, fill,
  volume and segmentation histograms (gss/features3d.py:14-203) over an
  adjacency graph of intersecting bounding boxes (preprocess.py:71-110);
- every region, original or merged, gives an axis-aligned box; the boxes
  go through 3D NMS at IoU 0.75 and the largest is dropped
  (gss/selective_search_3d_run.py:39-79, gss/utils.py:99-160);
- the output, (K, 7) float32 [centre xyz, extent xyz, score], is written
  as ``<scene>_prop.npy`` for the data layer.

:func:`generate_proposals` records each stage's seconds in ``timings``
when the caller passes a dict.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class SimilarityMask:
    """Which similarity terms participate (reference features3d.py:14)."""

    size: bool = True
    seg: bool = True
    fill: bool = True
    volume: bool = True


@dataclass
class Region:
    indices: np.ndarray          # point indices
    bbox_min: np.ndarray
    bbox_max: np.ndarray
    size: int
    seg_hist: np.ndarray         # normalized class histogram
    hull_volume: float

    @property
    def bbox_volume(self) -> float:
        return float(np.prod(np.maximum(self.bbox_max - self.bbox_min, 1e-9)))


def _hull_volume(points: np.ndarray) -> float:
    """Convex-hull volume with jittered degenerate handling
    (reference features3d.py adds tau=0.02 noise for flat regions)."""
    if points.shape[0] < 5:
        return 0.0
    try:
        from scipy.spatial import ConvexHull

        pts = points + np.random.default_rng(0).normal(
            scale=0.02, size=points.shape
        )
        return float(ConvexHull(pts).volume)
    except Exception:
        mn, mx = points.min(0), points.max(0)
        return float(np.prod(np.maximum(mx - mn, 1e-9)))


def _make_region(points: np.ndarray, indices: np.ndarray,
                 seg_labels: Optional[np.ndarray], num_classes: int) -> Region:
    pts = points[indices]
    hist = np.zeros(num_classes, np.float64)
    if seg_labels is not None:
        lab = seg_labels[indices]
        lab = lab[(lab >= 0) & (lab < num_classes)]
        if lab.size:
            hist = np.bincount(lab, minlength=num_classes).astype(np.float64)
            hist /= hist.sum()
    return Region(
        indices=indices,
        bbox_min=pts.min(0),
        bbox_max=pts.max(0),
        size=int(indices.shape[0]),
        seg_hist=hist,
        hull_volume=_hull_volume(pts),
    )


def _merge_region(a: Region, b: Region, points: np.ndarray) -> Region:
    indices = np.concatenate([a.indices, b.indices])
    hist = (a.seg_hist * a.size + b.seg_hist * b.size) / max(a.size + b.size, 1)
    return Region(
        indices=indices,
        bbox_min=np.minimum(a.bbox_min, b.bbox_min),
        bbox_max=np.maximum(a.bbox_max, b.bbox_max),
        size=a.size + b.size,
        seg_hist=hist,
        hull_volume=_hull_volume(points[indices]),
    )


def _boxes_intersect(a: Region, b: Region, slack: float = 0.05) -> bool:
    return bool(
        np.all(a.bbox_min <= b.bbox_max + slack)
        and np.all(b.bbox_min <= a.bbox_max + slack)
    )


def _similarity(a: Region, b: Region, total_points: int, total_volume: float,
                mask: SimilarityMask) -> float:
    s = 0.0
    if mask.size:
        s += max(0.0, 1.0 - (a.size + b.size) / max(total_points, 1))
    if mask.seg:
        s += float(np.minimum(a.seg_hist, b.seg_hist).sum())
    if mask.fill:
        merged_vol = float(
            np.prod(
                np.maximum(
                    np.maximum(a.bbox_max, b.bbox_max)
                    - np.minimum(a.bbox_min, b.bbox_min),
                    1e-9,
                )
            )
        )
        s += max(
            0.0,
            1.0 - (merged_vol - a.hull_volume - b.hull_volume) / max(total_volume, 1e-9),
        )
    if mask.volume:
        s += max(
            0.0, 1.0 - (a.hull_volume + b.hull_volume) / max(total_volume, 1e-9)
        )
    return s


def attach_unassigned(points: np.ndarray, region_ids: np.ndarray) -> np.ndarray:
    """Assign region -1 points to the nearest assigned point's region
    (reference shape_det/preprocess.py fix_unassigned_points)."""
    unassigned = np.nonzero(region_ids < 0)[0]
    assigned = np.nonzero(region_ids >= 0)[0]
    if unassigned.size == 0 or assigned.size == 0:
        return region_ids
    from scipy.spatial import cKDTree

    tree = cKDTree(points[assigned])
    _, nn = tree.query(points[unassigned])
    out = region_ids.copy()
    out[unassigned] = region_ids[assigned[nn]]
    return out


def hierarchical_segmentation(
    points: np.ndarray,
    region_ids: np.ndarray,
    seg_labels: Optional[np.ndarray] = None,
    mask: SimilarityMask = SimilarityMask(),
    num_classes: int = 20,
    merge_rounds: int = 1,
    rng: Optional[np.random.Generator] = None,
) -> List[Region]:
    """Greedy similarity merging; returns originals + merged regions.

    The reference's merge loop runs a single pass (gss/utils.py:78); each
    pass merges the best-similarity adjacent pair until none remain above
    the running mean similarity.
    """
    rng = rng or np.random.default_rng(0)
    ids = np.unique(region_ids[region_ids >= 0])
    regions: List[Region] = [
        _make_region(points, np.nonzero(region_ids == rid)[0], seg_labels, num_classes)
        for rid in ids
    ]
    all_regions = list(regions)
    total_points = points.shape[0]
    mn, mx = points.min(0), points.max(0)
    total_volume = float(np.prod(np.maximum(mx - mn, 1e-9)))

    for _ in range(merge_rounds):
        active = list(regions)
        # adjacency = bbox intersection (preprocess.py adjacency matrix)
        sims: Dict[Tuple[int, int], float] = {}
        for i in range(len(active)):
            for j in range(i + 1, len(active)):
                if _boxes_intersect(active[i], active[j]):
                    sims[(i, j)] = _similarity(
                        active[i], active[j], total_points, total_volume, mask
                    )
        alive = {i: r for i, r in enumerate(active)}
        next_id = len(active)
        while sims:
            (i, j), s = max(sims.items(), key=lambda kv: kv[1])
            merged = _merge_region(alive[i], alive[j], points)
            all_regions.append(merged)
            for key in list(sims):
                if i in key or j in key:
                    del sims[key]
            del alive[i], alive[j]
            for k, r in alive.items():
                if _boxes_intersect(merged, r):
                    sims[(min(k, next_id), max(k, next_id))] = _similarity(
                        merged, r, total_points, total_volume, mask
                    )
            alive[next_id] = merged
            next_id += 1
        regions = list(alive.values())

    return all_regions


def region_boxes(regions: Sequence[Region],
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """(K, 7) [centre xyz, extent xyz, score].

    Scores are size-weighted random (the reference scores proposals with
    ``np.random.rand() * label_count`` — intentionally cheap/noisy,
    gss/utils.py:98; SURVEY.md §3.5)."""
    rng = rng or np.random.default_rng(0)
    out = np.zeros((len(regions), 7), np.float32)
    for k, r in enumerate(regions):
        out[k, :3] = (r.bbox_min + r.bbox_max) / 2
        out[k, 3:6] = r.bbox_max - r.bbox_min
        out[k, 6] = rng.random() * r.size
    return out


def _box_iou_3d(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU between (K, 6) and (M, 6) centre/extent boxes."""
    a_min = a[:, :3] - a[:, 3:6] / 2
    a_max = a[:, :3] + a[:, 3:6] / 2
    b_min = b[:, :3] - b[:, 3:6] / 2
    b_max = b[:, :3] + b[:, 3:6] / 2
    lo = np.maximum(a_min[:, None], b_min[None])
    hi = np.minimum(a_max[:, None], b_max[None])
    inter = np.prod(np.clip(hi - lo, 0, None), axis=-1)
    va = np.prod(np.clip(a_max - a_min, 0, None), axis=-1)
    vb = np.prod(np.clip(b_max - b_min, 0, None), axis=-1)
    return inter / np.maximum(va[:, None] + vb[None] - inter, 1e-9)


def nms_3d(boxes: np.ndarray, iou_threshold: float = 0.75) -> np.ndarray:
    """Greedy 3D NMS by score (reference nms_3d_faster parity); returns kept idx."""
    if boxes.shape[0] == 0:
        return np.zeros(0, np.int64)
    order = np.argsort(-boxes[:, 6])
    keep: List[int] = []
    suppressed = np.zeros(boxes.shape[0], bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        ious = _box_iou_3d(boxes[i: i + 1], boxes)[0]
        suppressed |= ious > iou_threshold
        suppressed[i] = True
    return np.asarray(keep, np.int64)


def generate_proposals(
    points: np.ndarray,
    normals: Optional[np.ndarray] = None,
    seg_labels: Optional[np.ndarray] = None,
    mask: SimilarityMask = SimilarityMask(),
    iou_threshold: float = 0.75,
    min_region: int = 50,
    rng: Optional[np.random.Generator] = None,
    timings: Optional[Dict[str, float]] = None,
) -> np.ndarray:
    """Full per-scene GSS: region growing -> merge -> boxes -> NMS.

    Drops the single largest box (the whole-scene region,
    gss/selective_search_3d_run.py drop-largest step).  With ``timings``,
    records the seconds of ``normals``, ``region_grow``, ``merge`` (the
    unassigned points and the hierarchical merging) and ``nms`` (boxes
    and NMS), and the counts ``regions`` and ``merged``.
    """
    from tdwss_torch import native

    timings = {} if timings is None else timings
    rng = rng or np.random.default_rng(0)
    t = time.perf_counter()
    if normals is None:
        normals = estimate_normals(points)
    timings["normals"] = time.perf_counter() - t
    t = time.perf_counter()
    region_ids, num = native.region_grow(
        points, normals, k=12, max_dist=0.05, max_angle_deg=20,
        min_region=min_region,
    )
    timings["region_grow"] = time.perf_counter() - t
    timings["regions"] = int(num)
    if num == 0:
        return np.zeros((0, 7), np.float32)
    t = time.perf_counter()
    region_ids = attach_unassigned(points, region_ids)
    regions = hierarchical_segmentation(points, region_ids, seg_labels, mask,
                                        rng=rng)
    timings["merge"] = time.perf_counter() - t
    timings["merged"] = len(regions) - int(num)
    t = time.perf_counter()
    boxes = region_boxes(regions, rng)
    keep = nms_3d(boxes, iou_threshold)
    boxes = boxes[keep]
    if boxes.shape[0] > 1:
        volumes = np.prod(np.maximum(boxes[:, 3:6], 1e-9), axis=1)
        boxes = np.delete(boxes, int(np.argmax(volumes)), axis=0)
    timings["nms"] = time.perf_counter() - t
    return boxes


def estimate_normals(points: np.ndarray, k: int = 12) -> np.ndarray:
    """PCA normals from k-NN neighborhoods (replaces open3d estimation in
    shape_det/generate_scripts.py)."""
    from tdwss_torch import native

    n = points.shape[0]
    extent = float(points.max(0).min() - points.min(0).min() + 1e-6)
    radius = max(extent / max(np.cbrt(n), 1.0) * 3.0, 1e-3)
    idx = native.radius_neighbors(points, points, radius, max_neighbors=k)
    normals = np.zeros_like(points)
    for i in range(n):
        nb = idx[i][idx[i] >= 0]
        if nb.shape[0] < 3:
            normals[i] = [0, 0, 1]
            continue
        nbr = points[nb] - points[nb].mean(0)
        cov = nbr.T @ nbr
        w, v = np.linalg.eigh(cov)
        normals[i] = v[:, 0]
    return normals


def run_scene(points: np.ndarray, out_path: str, **kwargs) -> np.ndarray:
    boxes = generate_proposals(points, **kwargs)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.save(out_path, boxes)
    return boxes
