"""Offline ScanNet preparation (twin of :mod:`tdwss.data.prep`; reference
dataset/ScanNet/prepare_data.py, prepare_text_data.py, prepare_KDTree.py).

Writes under ``<out>/{train,val}_processed/``:

- ``<scene>.npz``: points (axis-aligned by the scan's axisAlignment
  matrix, mean-centred, float32), colors in [-1, 1], labels remapped to
  {-100, 0..19} through the NYU40 -> 20-class table (reference
  NYU_CLASS_IDS, data.py:39), and the ``center`` and ``align`` that the
  box collate inverts;
- ``<scene>_text.json``: the scene's ScanRefer descriptions.

No KD-tree is written (the reference pickled sklearn KDTrees): subcloud
queries build a ``cKDTree`` at load (:mod:`tdwss_torch.data.dataset`).
PLY files are read with :mod:`tdwss_torch.utils.ply`.

Run: ``python -m tdwss_torch.data.prep --scans <scans_dir> --out dataset/ScanNet``.
"""

from __future__ import annotations

import argparse
import glob
import json
import multiprocessing as mp
import os
from typing import Dict, List, Optional

import numpy as np

from tdwss_torch.utils.ply import read_ply

# NYU40 ids of the 20 ScanNet benchmark classes (reference dataset/data.py:39)
NYU_CLASS_IDS = np.array(
    [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39]
)


def remap_labels(raw: np.ndarray) -> np.ndarray:
    """NYU40 label ids -> {-100, 0..19}."""
    out = np.full(raw.shape, -100, np.int32)
    for new, nyu in enumerate(NYU_CLASS_IDS):
        out[raw == nyu] = new
    return out


def read_axis_align_matrix(meta_path: str) -> np.ndarray:
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            for line in f:
                if line.startswith("axisAlignment"):
                    vals = [float(x) for x in line.split("=")[1].split()]
                    return np.asarray(vals, np.float64).reshape(4, 4)
    return np.eye(4)


def process_scene(scene_dir: str, out_dir: str) -> Optional[str]:
    """One scene: <scene>_vh_clean_2.ply (+.labels.ply, .txt) -> npz."""
    name = os.path.basename(scene_dir.rstrip("/"))
    ply_path = os.path.join(scene_dir, f"{name}_vh_clean_2.ply")
    label_path = os.path.join(scene_dir, f"{name}_vh_clean_2.labels.ply")
    meta_path = os.path.join(scene_dir, f"{name}.txt")
    if not os.path.exists(ply_path):
        return None

    data = read_ply(ply_path)
    pts = np.stack([data["x"], data["y"], data["z"]], axis=1).astype(np.float64)
    colors = np.stack([data["red"], data["green"], data["blue"]], axis=1)
    colors = colors.astype(np.float32) / 127.5 - 1.0

    align = read_axis_align_matrix(meta_path)
    hom = np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=1)
    pts = (hom @ align.T)[:, :3]
    center = pts.mean(0)
    pts = (pts - center).astype(np.float32)

    if os.path.exists(label_path):
        labels = remap_labels(np.asarray(read_ply(label_path)["label"]))
    else:
        labels = np.full(pts.shape[0], -100, np.int32)

    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(
        os.path.join(out_dir, f"{name}.npz"),
        points=pts, colors=colors, labels=labels,
        center=center.astype(np.float32), align=align.astype(np.float32),
    )
    return name


def prepare_text(scanrefer_json: str, out_dir: str) -> int:
    """ScanRefer descriptions -> per-scene ``<scene>_text.json`` lists."""
    with open(scanrefer_json) as f:
        records = json.load(f)
    per_scene: Dict[str, List[str]] = {}
    for rec in records:
        per_scene.setdefault(rec["scene_id"], []).append(rec["description"])
    os.makedirs(out_dir, exist_ok=True)
    for scene, texts in per_scene.items():
        with open(os.path.join(out_dir, f"{scene}_text.json"), "w") as f:
            json.dump(texts, f)
    return len(per_scene)


def main() -> None:
    parser = argparse.ArgumentParser(description="ScanNet offline preparation")
    parser.add_argument("--scans", required=True, help="dir of scene folders")
    parser.add_argument("--out", default="dataset/ScanNet")
    parser.add_argument("--split", default="train", choices=["train", "val"])
    parser.add_argument("--scanrefer", default="", help="ScanRefer json path")
    parser.add_argument("--workers", type=int, default=max(mp.cpu_count() // 4, 1))
    args = parser.parse_args()

    out_dir = os.path.join(args.out, f"{args.split}_processed")
    scene_dirs = sorted(glob.glob(os.path.join(args.scans, "scene*")))
    with mp.Pool(args.workers) as pool:
        names = pool.starmap(process_scene, [(d, out_dir) for d in scene_dirs])
    done = [n for n in names if n]
    print(f"processed {len(done)} scenes -> {out_dir}")
    if args.scanrefer:
        n = prepare_text(args.scanrefer, out_dir)
        print(f"wrote text for {n} scenes")


if __name__ == "__main__":
    main()
