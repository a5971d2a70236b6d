"""In-memory scene datasets (twin of ``tdwss.data.dataset``).

- :func:`load_processed_dir` reads ``<scene>.npz`` artifacts (``points``,
  ``colors``, ``labels``, optionally ``center`` and ``align``), with
  optional ``_text.json`` descriptions, pseudo labels and GSS proposal
  boxes;
- :func:`expand_subclouds` is the subcloud mode: jittered grid anchors,
  radius queries (scipy ``cKDTree``), subclouds with at least
  ``min_points`` points become training samples;
- :func:`load_train_val` loads both splits per config, with a synthetic
  fallback when ``<data_root>/train_processed`` holds no scene;
- :func:`val_offsets` is valOffsets / valLabels.
"""

from __future__ import annotations

import glob
import json
import os
from typing import List, Sequence, Tuple

import numpy as np

from tdwss_torch.config import Config
from tdwss_torch.data.synthetic import Scene, make_dataset


def load_processed_dir(directory: str, has_text: bool = False,
                       pseudo_label_path: str = "",
                       pseudo_label_suffix: str = "_pseudo_label.npy",
                       box_path: str = "") -> List[Scene]:
    """Every ``<scene>.npz`` of ``directory``, in name order; a scene's
    pseudo labels (``<pseudo_label_path>/<scene><suffix>``) and boxes
    (``<box_path>/<scene>_prop.npy``, first 6 columns) where those files
    exist."""
    scenes = []
    for path in sorted(glob.glob(os.path.join(directory, "*.npz"))):
        data = np.load(path, allow_pickle=False)
        name = os.path.basename(path)[: -len(".npz")]
        texts: List[str] = []
        text_path = os.path.join(directory, name + "_text.json")
        if has_text and os.path.exists(text_path):
            with open(text_path) as f:
                texts = json.load(f)
        pseudo = None
        if pseudo_label_path:
            ppath = os.path.join(pseudo_label_path, name + pseudo_label_suffix)
            if os.path.exists(ppath):
                pseudo = np.load(ppath).astype(np.int32)
        boxes = None
        if box_path:
            bpath = os.path.join(box_path, name + "_prop.npy")
            if os.path.exists(bpath):
                boxes = np.load(bpath).astype(np.float32)[:, :6]
        scenes.append(Scene(
            points=data["points"].astype(np.float32),
            colors=data["colors"].astype(np.float32),
            labels=data["labels"].astype(np.int32),
            name=name, texts=texts, pseudo_labels=pseudo, boxes=boxes,
            center=(data["center"].astype(np.float32)
                    if "center" in data else None),
            align=(data["align"].astype(np.float32)
                   if "align" in data else None)))
    return scenes


def get_anchors(points: np.ndarray, in_radius: float) -> np.ndarray:
    """Regular grid anchors spanning the cloud, ``in_radius`` apart."""
    mins = points.min(0)
    maxs = points.max(0)
    axes = []
    for d in range(3):
        steps = int(np.floor((maxs[d] - mins[d]) / in_radius) + 1)
        axes.append(np.linspace(mins[d], maxs[d], max(steps, 1)))
    grid = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.reshape(-1) for g in grid], axis=-1)


def expand_subclouds(scenes: Sequence[Scene], in_radius: float,
                     min_points: int = 1000, seed: int = 0) -> List[Scene]:
    """Slice scenes into radius-``in_radius`` subclouds around anchors
    jittered by normal(0, in_radius / 10) noise from ``seed``."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    out: List[Scene] = []
    for scene in scenes:
        tree = cKDTree(scene.points)
        anchors = get_anchors(scene.points, in_radius)
        anchors = anchors + rng.normal(scale=in_radius / 10,
                                       size=anchors.shape)
        for k, idx in enumerate(tree.query_ball_point(anchors, in_radius)):
            idx = np.asarray(idx, np.int64)
            if idx.shape[0] < min_points:
                continue
            out.append(Scene(
                points=scene.points[idx], colors=scene.colors[idx],
                labels=scene.labels[idx], name=f"{scene.name}#sub{k}",
                texts=[],
                pseudo_labels=(scene.pseudo_labels[idx]
                               if scene.pseudo_labels is not None
                               else None)))
    return out


def val_offsets(scenes: Sequence[Scene]) -> Tuple[np.ndarray, np.ndarray]:
    """(offsets (S+1,), labels (TotalPts,)) — valOffsets/valLabels parity."""
    offsets = [0]
    labels = []
    for scene in scenes:
        offsets.append(offsets[-1] + scene.points.shape[0])
        labels.append(scene.labels.astype(np.int32))
    return np.asarray(offsets, np.int64), np.concatenate(labels)


def load_train_val(cfg: Config) -> Tuple[List[Scene], List[Scene]]:
    """(train, val) scenes of ``cfg``: ``<data_root>/train_processed`` and
    ``val_processed`` when the former holds scenes, else 8 + 2 synthetic
    scenes of 20,000 points (seeds 1 and 101).  Under label ``pseudo``
    the train scenes carry the labels under ``pseudo_label_path`` (the
    synthetic scenes repeat from their seeds, so labels written by an
    earlier generation run line up); under label ``subcloud`` they are
    expanded into subclouds."""
    train_dir = os.path.join(cfg.data_root, "train_processed")
    val_dir = os.path.join(cfg.data_root, "val_processed")
    pseudo = cfg.label == "pseudo"
    if os.path.isdir(train_dir) and glob.glob(
            os.path.join(train_dir, "*.npz")):
        train = load_processed_dir(
            train_dir, has_text=cfg.has_text,
            pseudo_label_path=cfg.pseudo_label_path if pseudo else "",
            pseudo_label_suffix=cfg.pseudo_label_suffix,
            box_path=cfg.box_path if cfg.pointcloud_data.with_boxes else "")
        val = load_processed_dir(val_dir, has_text=False)
    else:
        train = make_dataset(8, num_points=20000, seed=1,
                             with_text=cfg.has_text)
        val = make_dataset(2, num_points=20000, seed=101, with_text=False)
        if pseudo and cfg.pseudo_label_path:
            for scene in train:
                path = os.path.join(cfg.pseudo_label_path,
                                    scene.name + cfg.pseudo_label_suffix)
                if os.path.exists(path):
                    scene.pseudo_labels = np.load(path)
    if cfg.label == "subcloud":
        train = expand_subclouds(train, cfg.in_radius)
    return train, val
