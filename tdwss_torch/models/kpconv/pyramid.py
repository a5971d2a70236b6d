"""Host-side multi-layer input pyramid for KPFCNN (twin of
:mod:`tdwss.models.kpconv.pyramid`; numpy).

Per pooling boundary of the architecture it computes conv neighbours
(radius ``r_normal``, widened by ``deform_radius / conv_radius`` for
deformable layers), grid-subsampled pool points and pool neighbours, and
upsample neighbours at ``2 * r``; plus the neighbour-count calibration.
Every layer is padded to a static row capacity (rounded up to 256 unless
the caller gives the capacities), padding rows sit at SHADOW_COORD, and
missing neighbours hold the capacity index.  The queries run in the
port's build of the native library (:mod:`tdwss_torch.native`), which
raises when it cannot be built; the outputs are byte-equal to the
reference's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tdwss_torch import native
from tdwss_torch.models.kpconv.blocks import KPBatch
from tdwss_torch.models.kpconv.config import KPConvConfig
from tdwss_torch.models.kpconv.ops import SHADOW_COORD


def _round_up(n: int, m: int = 256) -> int:
    return max(m, ((n + m - 1) // m) * m)


def _sort_by_distance(neigh: np.ndarray, queries: np.ndarray,
                      supports: np.ndarray) -> np.ndarray:
    """Order each padded neighbor row closest-first (-1 padding last).

    closest_pool (NearestUpsampleBlock) assumes column 0 is the nearest
    support (reference blocks.py:81-92 'WARNING: assumes ordered').
    """
    if neigh.shape[0] == 0:
        return neigh
    ns = supports.shape[0]
    safe = np.where(neigh >= 0, neigh, 0)
    d = np.linalg.norm(supports[safe] - queries[:, None, :], axis=-1)
    d[neigh < 0] = np.inf
    order = np.argsort(d, axis=1, kind="stable")
    return np.take_along_axis(neigh, order, axis=1)


def plan_layer_radii(cfg: KPConvConfig) -> List[Dict]:
    """Static per-layer query plan from the architecture list.

    Each entry: {conv_r: float|None, pool: bool, pool_r: float, dl: float}.
    Mirrors the control flow of segmentation_inputs (ref :427-505).
    """
    r_normal = cfg.first_subsampling_dl * cfg.conv_radius
    widen = cfg.deform_radius / cfg.conv_radius
    layer_blocks: List[str] = []
    plan: List[Dict] = []
    for block in cfg.architecture:
        if not any(t in block for t in ("pool", "strided", "global", "upsample")):
            layer_blocks.append(block)
            continue
        entry: Dict = {"conv_r": None, "pool": False, "pool_r": None, "dl": None}
        if layer_blocks:
            deform = any("deformable" in b for b in layer_blocks)
            entry["conv_r"] = r_normal * widen if deform else r_normal
        if "pool" in block or "strided" in block:
            entry["pool"] = True
            entry["dl"] = 2 * r_normal / cfg.conv_radius
            entry["pool_r"] = r_normal * widen if "deformable" in block else r_normal
        plan.append(entry)
        layer_blocks = []
        r_normal *= 2
        if "global" in block or "upsample" in block:
            break
    return plan


def calibrate_neighbors(clouds: Sequence[Dict], cfg: KPConvConfig,
                        keep_ratio: float = 0.8,
                        samples: int = 8) -> Tuple[int, ...]:
    """Per-layer neighbor caps: the ``keep_ratio`` quantile of observed
    neighborhood sizes (reference calibration, KPConv_Scannet.py:984)."""
    plan = plan_layer_radii(cfg)
    counts: List[List[int]] = [[] for _ in plan]
    probe = max(int(4.0 / 3.0 * np.pi * (cfg.deform_radius + 1) ** 3), 64)
    for cloud in list(clouds)[:samples]:
        pts = np.asarray(cloud["points"], np.float32)
        for li, entry in enumerate(plan):
            r = entry["conv_r"] or entry["pool_r"]
            if r is not None:
                neigh = native.radius_neighbors(pts, pts, r, probe)
                counts[li].extend((neigh >= 0).sum(axis=1).tolist())
            if entry["pool"]:
                pts, _, _ = native.grid_subsample(pts, cell_size=entry["dl"])
    return tuple(
        int(np.quantile(c, keep_ratio)) if c else cfg.default_neighbor_limit
        for c in counts
    )


def segmentation_inputs(
    clouds: Sequence[Dict],
    cfg: KPConvConfig,
    capacities: Optional[Sequence[int]] = None,
    neighbor_limits: Optional[Sequence[int]] = None,
) -> KPBatch:
    """Build the padded static-shape KPBatch for a list of clouds.

    clouds: dicts with 'points' (Ni,3) float32, 'features' (Ni,F) float32,
    'labels' (Ni,) int32 (-100 ignore).  capacities: per-layer row caps
    (auto: round up to 256).  neighbor_limits: per-layer neighbor cap.
    """
    plan = plan_layer_radii(cfg)
    num_layers = len(plan)
    limits = list(neighbor_limits or cfg.neighborhood_limits
                  or [cfg.default_neighbor_limit] * num_layers)

    # Per-cloud, per-layer raw arrays.
    per_cloud: List[Dict] = []
    for cloud in clouds:
        pts = np.asarray(cloud["points"], np.float32)
        layers = {"points": [], "neighbors": [], "pools": [], "upsamples": []}
        for li, entry in enumerate(plan):
            nmax = limits[li]
            if entry["conv_r"] is not None:
                conv_i = native.radius_neighbors(pts, pts, entry["conv_r"], nmax)
                conv_i = _sort_by_distance(conv_i, pts, pts)
            else:
                conv_i = np.full((pts.shape[0], 1), -1, np.int32)
            if entry["pool"]:
                pool_p, _, _ = native.grid_subsample(pts, cell_size=entry["dl"])
                pool_i = native.radius_neighbors(
                    pool_p, pts, entry["pool_r"], nmax)
                pool_i = _sort_by_distance(pool_i, pool_p, pts)
                up_i = native.radius_neighbors(
                    pts, pool_p, 2 * entry["pool_r"],
                    limits[min(li + 1, num_layers - 1)])
                up_i = _sort_by_distance(up_i, pts, pool_p)
            else:
                pool_p = np.zeros((0, 3), np.float32)
                pool_i = np.zeros((0, 1), np.int32)
                up_i = np.zeros((pts.shape[0], 1), np.int32) - 1
            layers["points"].append(pts)
            layers["neighbors"].append(conv_i)
            layers["pools"].append(pool_i)
            layers["upsamples"].append(up_i)
            pts = pool_p
        per_cloud.append(layers)

    # Static capacities per layer.
    if capacities is None:
        capacities = [
            _round_up(sum(c["points"][li].shape[0] for c in per_cloud))
            for li in range(num_layers)
        ]
    capacities = list(capacities)

    def _stack(li: int, key: str, idx_layer: Optional[int]):
        """Concatenate per-cloud arrays with index offsetting + padding."""
        cap = capacities[li] if key != "pools" else capacities[min(li + 1, num_layers - 1)]
        rows = []
        offset = 0
        tgt_cap = None if idx_layer is None else capacities[idx_layer]
        for c in per_cloud:
            arr = c[key][li]
            if idx_layer is not None:
                shifted = np.where(arr >= 0, arr + offset, tgt_cap)
                rows.append(shifted.astype(np.int32))
                offset += c["points"][idx_layer].shape[0]
            else:
                rows.append(arr)
        width = max(r.shape[1] for r in rows) if idx_layer is not None else 3
        out_rows = sum(r.shape[0] for r in rows)
        if idx_layer is not None:
            out = np.full((cap, width), tgt_cap, np.int32)
        else:
            out = np.full((cap, 3), SHADOW_COORD, np.float32)
        at = 0
        for r in rows:
            out[at: at + r.shape[0], : r.shape[1]] = r
            at += r.shape[0]
        assert at == out_rows <= cap, f"layer {li} overflows capacity {cap}"
        return out

    points, neighbors, pools, upsamples, batch_ids, valids = [], [], [], [], [], []
    for li in range(num_layers):
        points.append(_stack(li, "points", None))
        neighbors.append(_stack(li, "neighbors", li))
        pools.append(_stack(li, "pools", li))
        up_target = min(li + 1, num_layers - 1)
        upsamples.append(_stack(li, "upsamples", up_target))
        bid = np.full((capacities[li],), len(per_cloud), np.int32)
        val = np.zeros((capacities[li],), bool)
        at = 0
        for ci, c in enumerate(per_cloud):
            n = c["points"][li].shape[0]
            bid[at: at + n] = ci
            val[at: at + n] = True
            at += n
        batch_ids.append(bid)
        valids.append(val)

    feats = np.zeros((capacities[0], clouds[0]["features"].shape[1]), np.float32)
    labels = np.full((capacities[0],), -100, np.int32)
    at = 0
    for cloud in clouds:
        n = np.asarray(cloud["points"]).shape[0]
        feats[at: at + n] = np.asarray(cloud["features"], np.float32)
        if "labels" in cloud and cloud["labels"] is not None:
            labels[at: at + n] = np.asarray(cloud["labels"], np.int32)
        at += n

    return KPBatch(
        points=tuple(points), neighbors=tuple(neighbors),
        pools=tuple(pools), upsamples=tuple(upsamples),
        batch_ids=tuple(batch_ids), valids=tuple(valids),
        features=feats, labels=labels, num_scenes=len(per_cloud),
    )
