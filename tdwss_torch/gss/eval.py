"""GSS proposal evaluation and ensembling (twin of :mod:`tdwss.gss.eval`;
offline, host numpy).

- :class:`ARCalculator` / :func:`evaluate_proposals`: average recall and
  MABO (reference selective_search_3d_eval.py, the ``wypr``
  ARCalculator written out);
- :func:`ensemble_proposals`: multi-policy NMS ensembling
  (selective_search_3d_ensemble.py:20-47);
- per-point colour space conversions without skimage
  (color_space_3d.py:11-51).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from tdwss_torch.gss.search import nms_3d


# ---------------------------------------------------------------------------
# AR / MABO (reference eval via wypr.evaluation.ARCalculator)
# ---------------------------------------------------------------------------

def box_iou_3d_corners(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU matrix for (N,6)/(M,6) [xmin..zmin, xmax..zmax] corner boxes."""
    a = np.asarray(a, np.float64).reshape(-1, 6)
    b = np.asarray(b, np.float64).reshape(-1, 6)
    lo = np.maximum(a[:, None, :3], b[None, :, :3])
    hi = np.minimum(a[:, None, 3:], b[None, :, 3:])
    inter = np.prod(np.clip(hi - lo, 0, None), axis=-1)
    va = np.prod(np.clip(a[:, 3:] - a[:, :3], 0, None), axis=-1)
    vb = np.prod(np.clip(b[:, 3:] - b[:, :3], 0, None), axis=-1)
    union = va[:, None] + vb[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def center_extent_to_corners(boxes: np.ndarray) -> np.ndarray:
    """(K,>=6) [cx,cy,cz,dx,dy,dz,...] -> (K,6) corner boxes (the *_prop.npy
    layout, reference gss/utils.py:152-160)."""
    boxes = np.asarray(boxes, np.float64)
    half = boxes[:, 3:6] / 2
    return np.concatenate([boxes[:, :3] - half, boxes[:, :3] + half], axis=1)


class ARCalculator:
    """Streaming Average Recall / MABO over scenes.

    Parity with the wypr ARCalculator the reference drives
    (selective_search_3d_eval.py:33-46): per scene, each ground-truth box is
    matched to its best-IoU proposal; AR@t = fraction of GT with best IoU
    >= t, MABO = class-averaged mean best overlap.
    """

    def __init__(self, iou_thresh: float = 0.25):
        self.iou_thresh = iou_thresh
        self._best: Dict[int, List[float]] = {}
        self._num_props: List[int] = []

    def step(self, proposals: np.ndarray, gt_boxes: np.ndarray,
             gt_classes: Optional[np.ndarray] = None) -> None:
        """proposals (P,6) corners; gt_boxes (G,6) corners; gt_classes (G,)."""
        gt_boxes = np.asarray(gt_boxes).reshape(-1, 6)
        if gt_classes is None:
            gt_classes = np.zeros((gt_boxes.shape[0],), np.int64)
        self._num_props.append(int(np.asarray(proposals).reshape(-1, 6).shape[0]))
        if gt_boxes.shape[0] == 0:
            return
        if self._num_props[-1] == 0:
            best = np.zeros((gt_boxes.shape[0],))
        else:
            best = box_iou_3d_corners(gt_boxes, proposals).max(axis=1)
        for c, o in zip(np.asarray(gt_classes, np.int64), best):
            self._best.setdefault(int(c), []).append(float(o))

    def compute(self) -> Dict[str, float]:
        if not self._best:
            return {"AR": 0.0, "MABO": 0.0, "avg_num_prop": 0.0}
        recalls, abos = [], []
        for _, overlaps in sorted(self._best.items()):
            ov = np.asarray(overlaps)
            recalls.append(float((ov >= self.iou_thresh).mean()))
            abos.append(float(ov.mean()))
        return {
            "AR": float(np.mean(recalls)),
            "MABO": float(np.mean(abos)),
            "avg_num_prop": float(np.mean(self._num_props)),
        }


def evaluate_proposals(
    scene_proposals: Sequence[np.ndarray],
    scene_gt: Sequence[np.ndarray],
    scene_gt_classes: Optional[Sequence[np.ndarray]] = None,
    iou_thresh: float = 0.25,
    center_extent: bool = True,
) -> Dict[str, float]:
    """One-shot AR/MABO over a list of scenes (proposal arrays may be the
    (K,7) center/extent/score *_prop.npy layout)."""
    calc = ARCalculator(iou_thresh)
    for i, (props, gt) in enumerate(zip(scene_proposals, scene_gt)):
        p = center_extent_to_corners(props) if center_extent and np.asarray(
            props).shape[-1] >= 6 else np.asarray(props)[:, :6]
        g = center_extent_to_corners(gt) if center_extent else np.asarray(gt)[:, :6]
        cls = None if scene_gt_classes is None else scene_gt_classes[i]
        calc.step(p, g, cls)
    return calc.compute()


# ---------------------------------------------------------------------------
# Multi-policy ensembling (reference selective_search_3d_ensemble.py)
# ---------------------------------------------------------------------------

def ensemble_proposals(
    policy_proposals: Sequence[np.ndarray],
    iou_thresh: float = 0.7,
    max_num_prop: int = 1000,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Stack per-policy (K,7) proposals, re-randomize scores, NMS, cap.

    Mirrors the ensemble loop (reference :32-47): scores are replaced with
    uniform noise so NMS keeps a random representative per cluster.
    """
    rng = rng or np.random.default_rng(0)
    stacks = [np.asarray(p, np.float64).reshape(-1, 7)
              for p in policy_proposals if np.asarray(p).size]
    if not stacks:
        return np.zeros((0, 7), np.float32)
    all_props = np.vstack(stacks)
    all_props[:, 6] = rng.random(all_props.shape[0])
    pick = nms_3d(all_props.astype(np.float32), iou_thresh)
    kept = all_props[pick]
    if kept.shape[0] > max_num_prop:
        kept = kept[rng.choice(kept.shape[0], max_num_prop, replace=False)]
    return kept.astype(np.float32)


# ---------------------------------------------------------------------------
# Color spaces (reference color_space_3d.py, skimage-free)
# ---------------------------------------------------------------------------

def to_grey(colors: np.ndarray) -> np.ndarray:
    """(N,3) uint8 RGB -> (N,3) replicated luma."""
    c = np.asarray(colors, np.float64) / 255.0
    grey = (255 * (0.2125 * c[:, 0] + 0.7154 * c[:, 1] + 0.0721 * c[:, 2]))
    grey = grey.astype(np.uint8)
    return np.stack([grey, grey, grey], axis=1)


def _srgb_to_linear(c: np.ndarray) -> np.ndarray:
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def to_lab(colors: np.ndarray) -> np.ndarray:
    """CIELAB, packed to uint8 like the reference (L*255/100, a+127, b+127)."""
    rgb = _srgb_to_linear(np.asarray(colors, np.float64) / 255.0)
    m = np.array([
        [0.4124564, 0.3575761, 0.1804375],
        [0.2126729, 0.7151522, 0.0721750],
        [0.0193339, 0.1191920, 0.9503041],
    ])
    xyz = rgb @ m.T
    xyz /= np.array([0.95047, 1.0, 1.08883])
    f = np.where(xyz > (6 / 29) ** 3, np.cbrt(xyz),
                 xyz / (3 * (6 / 29) ** 2) + 4 / 29)
    L = 116 * f[:, 1] - 16
    a = 500 * (f[:, 0] - f[:, 1])
    b = 200 * (f[:, 1] - f[:, 2])
    out = np.stack([255 * L / 100, 127 + a, 127 + b], axis=1)
    return np.clip(out, 0, 255).astype(np.uint8)


def to_hsv(colors: np.ndarray) -> np.ndarray:
    c = np.asarray(colors, np.float64) / 255.0
    mx, mn = c.max(axis=1), c.min(axis=1)
    delta = mx - mn
    h = np.zeros_like(mx)
    nz = delta > 1e-12
    r, g, b = c[:, 0], c[:, 1], c[:, 2]
    idx = nz & (mx == r)
    h[idx] = ((g[idx] - b[idx]) / delta[idx]) % 6
    idx = nz & (mx == g) & (mx != r)
    h[idx] = (b[idx] - r[idx]) / delta[idx] + 2
    idx = nz & (mx == b) & (mx != r) & (mx != g)
    h[idx] = (r[idx] - g[idx]) / delta[idx] + 4
    h /= 6.0
    s = np.where(mx > 0, delta / np.maximum(mx, 1e-12), 0.0)
    return np.clip(255 * np.stack([h, s, mx], axis=1), 0, 255).astype(np.uint8)


def to_rgi(colors: np.ndarray) -> np.ndarray:
    out = np.asarray(colors).copy()
    out[:, 2] = to_grey(colors)[:, 0]
    return out


def to_nrgb(colors: np.ndarray) -> np.ndarray:
    c = np.asarray(colors, np.float64) / 255.0
    norm = np.sqrt(np.sum(c**2, axis=1))
    norm = np.maximum(norm, 1e-12)
    return np.clip(255 * c / norm[:, None], 0, 255).astype(np.uint8)


def to_hue(colors: np.ndarray) -> np.ndarray:
    h = to_hsv(colors)[:, 0]
    return np.stack([h, h, h], axis=1)


def convert_color(colors: np.ndarray, name: str) -> np.ndarray:
    """Dispatch table parity (reference color_space_3d.py:11-19)."""
    converters = {
        "rgb": lambda c: np.asarray(c),
        "lab": to_lab,
        "rgi": to_rgi,
        "hsv": to_hsv,
        "nrgb": to_nrgb,
        "hue": to_hue,
    }
    return converters[name](colors)
