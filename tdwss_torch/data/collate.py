"""Fixed-shape batch assembly (twin of ``tdwss.data.collate``):
``train_collate`` (trainMerge) and ``val_collate`` (valMerge).

Every batch is padded to the static ``max_points`` capacity and carries
masks; if the scenes exceed it, a uniform random subset is kept, and
:class:`CollateStats` counts the points seen and dropped.  Train batches
of text configs carry the scenes' descriptions as token ids
(:class:`TextBatch`); proposal boxes are not collated (no ported model
reads them).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from tdwss_torch import NUM_CLASSES
from tdwss_torch.config import Config
from tdwss_torch.data.augment import (color_jitter, scene_label_from_points,
                                      train_transform, val_transform)
from tdwss_torch.data.batch import PointBatch, TextBatch
from tdwss_torch.data.synthetic import Scene
from tdwss_torch.data.tokenizer import get_tokenizer, tokenize


@dataclass
class CollateStats:
    """Points collated and points dropped over a loader epoch.

    Collates run on concurrent worker threads
    (:mod:`tdwss_torch.data.loader`), so :meth:`add` takes a lock: a bare
    ``+=`` could lose a batch's count.
    """

    total_points: int = 0
    dropped_points: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def add(self, total: int, dropped: int = 0) -> None:
        with self._lock:
            self.total_points += total
            self.dropped_points += dropped


def _pad_points(arrays: dict, n_actual: int, capacity: int,
                rng: np.random.Generator,
                stats: Optional[CollateStats] = None):
    """Pad (or uniformly subsample) the concatenated point arrays."""
    if stats is not None:
        stats.add(n_actual, max(n_actual - capacity, 0))
    if n_actual > capacity:
        keep = rng.permutation(n_actual)[:capacity]
        keep.sort()
        arrays = {k: v[keep] for k, v in arrays.items()}
        n_actual = capacity
    out = {}
    for key, value in arrays.items():
        pad_value = -100 if key == "point_label" else 0
        full = np.full((capacity,) + value.shape[1:], pad_value, value.dtype)
        full[:n_actual] = value
        out[key] = full
    valid = np.zeros(capacity, bool)
    valid[:n_actual] = True
    return out, valid


def train_collate(scenes: Sequence[Scene], cfg: Config,
                  rng: np.random.Generator,
                  stats: Optional[CollateStats] = None) -> PointBatch:
    """trainMerge parity over a list of scenes (subclouds, under label
    ``subcloud``, are scenes too): one augmented view per scene, colour
    jitter, scene tags from the kept points' labels, and under label
    ``pseudo`` the scenes' pseudo labels as the point labels.  The draws
    from ``rng`` are the reference's, in its order.

    Under ``has_text`` each scene's first ``cropped_texts`` descriptions
    become a (cropped_texts, max_seq_len) row of token ids (zeros for a
    scene without texts); tokenizing draws nothing from ``rng``."""
    pcd = cfg.pointcloud_data
    full_scale = cfg.pointcloud_model.full_scale
    use_pseudo = cfg.label == "pseudo"

    coords_l, feats_l, label_l, batch_l = [], [], [], []
    scene_labels = []
    for idx, scene in enumerate(scenes):
        a, keep, _ = train_transform(
            scene.points, pcd.scale, full_scale, rng,
            elastic_deformation=pcd.elastic_deformation)
        a = a[keep]
        labels = scene.labels[keep]
        if use_pseudo:
            if scene.pseudo_labels is None:
                raise ValueError(f"scene {scene.name} lacks pseudo labels")
            labels = scene.pseudo_labels[keep]
        coords_l.append(a.astype(np.int32))      # a >= 0: floor == trunc
        feats_l.append(color_jitter(scene.colors[keep], rng))
        label_l.append(labels.astype(np.int32))
        batch_l.append(np.full(a.shape[0], idx, np.int32))
        scene_labels.append(
            scene_label_from_points(scene.labels[keep], NUM_CLASSES))

    coords3 = np.concatenate(coords_l)
    arrays = {
        "coords": np.concatenate(
            [coords3, np.concatenate(batch_l)[:, None]], axis=1),
        "feats": np.concatenate(feats_l).astype(np.float32),
        "point_label": np.concatenate(label_l),
    }
    arrays, valid = _pad_points(arrays, coords3.shape[0],
                                cfg.engine.max_points, rng, stats)
    return PointBatch(
        coords=arrays["coords"],
        feats=arrays["feats"],
        valid=valid,
        scene_label=np.stack(scene_labels),
        scene_mask=np.ones(len(scenes), bool),
        point_label=arrays["point_label"],
        point_ids=np.full(cfg.engine.max_points, -1, np.int32),
        text=collate_text(scenes, cfg) if cfg.has_text else None,
    )


def collate_text(scenes: Sequence[Scene], cfg: Config) -> TextBatch:
    """Token rows of the scenes' first ``cropped_texts`` descriptions;
    ``has_text`` = the scene index, ``valid`` = the scene has texts."""
    td = cfg.text_data
    tokenizer = get_tokenizer(td.bpe_vocab_path or None)
    tokens = np.zeros((len(scenes), td.cropped_texts, td.max_seq_len),
                      np.int32)
    for i, scene in enumerate(scenes):
        texts = scene.texts[: td.cropped_texts]
        if texts:
            rows = tokenize(texts, td.max_seq_len, tokenizer=tokenizer,
                            vocab_size=cfg.text_model.vocab_size)
            tokens[i, : rows.shape[0]] = rows
    return TextBatch(
        tokens=tokens,
        has_text=np.arange(len(scenes), dtype=np.int32),
        valid=np.asarray([bool(s.texts[: td.cropped_texts])
                          for s in scenes], bool))


def val_collate(scenes: Sequence[Scene], cfg: Config,
                rng: np.random.Generator,
                scene_offsets: Sequence[int],
                scene_indices: Sequence[int],
                stats: Optional[CollateStats] = None,
                num_scenes: Optional[int] = None) -> PointBatch:
    """valMerge parity: one random view per scene + global point_ids.

    ``scene_offsets[i]`` is the global offset of dataset scene ``i``'s
    points; ``scene_indices`` are the dataset indices of ``scenes``;
    ``num_scenes`` pads the scene axis to a static size.
    """
    pcd = cfg.pointcloud_data
    full_scale = cfg.pointcloud_model.full_scale

    coords_l, feats_l, label_l, batch_l, pid_l = [], [], [], [], []
    scene_labels = []
    for idx, (scene, ds_idx) in enumerate(zip(scenes, scene_indices)):
        a, keep = val_transform(scene.points, pcd.scale, full_scale, rng)
        a = a[keep]
        coords_l.append(a.astype(np.int32))      # a >= 0: floor == trunc
        feats_l.append(scene.colors[keep].astype(np.float32))
        label_l.append(scene.labels[keep].astype(np.int32))
        batch_l.append(np.full(a.shape[0], idx, np.int32))
        pid_l.append(np.nonzero(keep)[0].astype(np.int32)
                     + scene_offsets[ds_idx])
        scene_labels.append(
            scene_label_from_points(scene.labels[keep], NUM_CLASSES))

    coords3 = np.concatenate(coords_l)
    arrays = {
        "coords": np.concatenate(
            [coords3, np.concatenate(batch_l)[:, None]], axis=1),
        "feats": np.concatenate(feats_l),
        "point_label": np.concatenate(label_l),
        "point_ids": np.concatenate(pid_l),
    }
    arrays, valid = _pad_points(arrays, coords3.shape[0],
                                cfg.engine.max_points, rng, stats)
    arrays["point_ids"] = np.where(valid, arrays["point_ids"], -1)

    b = num_scenes or len(scenes)
    scene_label = np.zeros((b, NUM_CLASSES), np.float32)
    scene_label[: len(scenes)] = np.stack(scene_labels)
    scene_mask = np.zeros(b, bool)
    scene_mask[: len(scenes)] = True

    return PointBatch(
        coords=arrays["coords"],
        feats=arrays["feats"],
        valid=valid,
        scene_label=scene_label,
        scene_mask=scene_mask,
        point_label=arrays["point_label"],
        point_ids=arrays["point_ids"],
    )
