"""Fixed-shape batch assembly (twin of ``tdwss.data.collate``):
``train_collate`` (trainMerge) and ``val_collate`` (valMerge).

Every batch is padded to the static ``max_points`` capacity and carries
masks; if the scenes exceed it, a uniform random subset is kept, and
:class:`CollateStats` counts the points seen and dropped.  Train batches
of text configs carry the scenes' descriptions as token ids
(:class:`TextBatch`), and under ``pointcloud_data.with_boxes`` the
scenes' GSS proposals with the inverse of each scene's augmentation
(:class:`BoxBatch`).
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
from tdwss_torch.data.batch import BoxBatch, PointBatch, TextBatch
from tdwss_torch.data.synthetic import Scene
from tdwss_torch.data.tokenizer import get_tokenizer, tokenize
from tdwss_torch.utils import profiling


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
                  stats: Optional[CollateStats] = None,
                  key: Optional[tuple] = None) -> PointBatch:
    """trainMerge parity over a list of scenes (subclouds, under label
    ``subcloud``, are scenes too): one augmented view per scene, colour
    jitter, scene tags from the kept points' labels, and under label
    ``pseudo`` the scenes' pseudo labels as the point labels.  The draws
    from ``rng`` are the reference's, in its order.

    Under ``has_text`` each scene's first ``cropped_texts`` descriptions
    become a (cropped_texts, max_seq_len) row of token ids (zeros for a
    scene without texts); tokenizing draws nothing from ``rng``, and is
    the span ``tdwss.loader.tokenize`` of batch ``key`` (see
    :func:`collate_text`).  Under
    ``with_boxes`` the batch carries :func:`_collate_boxes` of the
    scenes and the transforms their augmentation returned."""
    pcd = cfg.pointcloud_data
    full_scale = cfg.pointcloud_model.full_scale
    use_pseudo = cfg.label == "pseudo"

    coords_l, feats_l, label_l, batch_l = [], [], [], []
    scene_labels = []
    transforms = []
    for idx, scene in enumerate(scenes):
        a, keep, transform = train_transform(
            scene.points, pcd.scale, full_scale, rng,
            elastic_deformation=pcd.elastic_deformation)
        transforms.append(transform)
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
        text=collate_text(scenes, cfg, key) if cfg.has_text else None,
        box=(_collate_boxes(scenes, transforms, pcd.max_boxes)
             if pcd.with_boxes else None),
    )


def _collate_boxes(scenes: Sequence[Scene], transforms: Sequence[dict],
                   max_boxes: int) -> BoxBatch:
    """Each scene's first ``max_boxes`` proposals, padded, with a
    validity mask, and the inverse augmentation [align, center, rot_inv,
    offset] (reference trainMerge, dataset/data.py:199,223-238); a scene
    without ``align`` keeps the identity, without ``center`` zeros."""
    b = len(scenes)
    boxes = np.zeros((b, max_boxes, 6), np.float32)
    valid = np.zeros((b, max_boxes), bool)
    align = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    center = np.zeros((b, 3), np.float32)
    rot_inv = np.zeros((b, 3, 3), np.float32)
    offset = np.zeros((b, 3), np.float32)
    for i, (scene, tf) in enumerate(zip(scenes, transforms)):
        if scene.boxes is not None and scene.boxes.shape[0]:
            k = min(scene.boxes.shape[0], max_boxes)
            boxes[i, :k] = scene.boxes[:k, :6]
            valid[i, :k] = True
        if scene.align is not None:
            align[i] = scene.align
        if scene.center is not None:
            center[i] = scene.center
        rot_inv[i] = tf["rot_inv"]
        offset[i] = tf["offset"]
    return BoxBatch(boxes=boxes, valid=valid, align=align, center=center,
                    rot_inv=rot_inv, offset=offset)


def live_tokens(tokens: np.ndarray) -> int:
    """The positions up to and including each non-empty row's EOT (the
    largest id of the row, where the text tower reads its feature)."""
    tokens = tokens.reshape(-1, tokens.shape[-1])
    return int((tokens.argmax(-1) + 1)[(tokens != 0).any(-1)].sum())


def collate_text(scenes: Sequence[Scene], cfg: Config,
                 key: Optional[tuple] = None) -> TextBatch:
    """Token rows of the scenes' first ``cropped_texts`` descriptions;
    ``has_text`` = the scene index, ``valid`` = the scene has texts.
    While a torch profiler records, tokenizing is the span
    ``tdwss.loader.tokenize`` of batch ``key``, and the counter
    ``tdwss.text.live_tokens`` adds :func:`live_tokens` of the rows."""
    td = cfg.text_data
    tokens = np.zeros((len(scenes), td.cropped_texts, td.max_seq_len),
                      np.int32)
    with profiling.span("tdwss.loader.tokenize", key):
        tokenizer = get_tokenizer(td.bpe_vocab_path or None)
        for i, scene in enumerate(scenes):
            texts = scene.texts[: td.cropped_texts]
            if texts:
                rows = tokenize(texts, td.max_seq_len, tokenizer=tokenizer,
                                vocab_size=cfg.text_model.vocab_size)
                tokens[i, : rows.shape[0]] = rows
    if profiling.recording():
        profiling.count("tdwss.text.live_tokens", live_tokens(tokens))
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
