"""Pseudo-image dataset generation (twin of
:mod:`tdwss.ops.pseudo_images`; offline).

Text -> image generation of object crops on white backgrounds,
background filtering, binary-mask extraction, and mask blurring through
the point-cloud renderer (reference ``ops/pseudo_dataset_generator/``):

- utils/camera_sampler.py:16-105 -> :func:`sample_camera_positions` /
  :func:`sample_camera_pose` / :func:`create_cam2world_matrix`
- utils/text_util.py:18-37 -> :func:`read_attr` / :func:`compose_text`
- Image_generator.py:20-32 -> :func:`shard_range` and an injected
  generator (the reference's GLIDE stack is not in the repository:
  pass any callable ``texts -> (B, H, W, 3) uint8``)
- Image_filter.py:16-33 -> :func:`is_white_background` /
  :func:`filter_images`
- extract_mask.py:19-27 -> :func:`extract_mask`
- preprocess_mask.py:30-32 -> :func:`blur_masks`, through
  :class:`tdwss_torch.ops.point2mask.Pixel2Mask` on the device

Everything but :func:`blur_masks` is host numpy, deterministic given an
``rng``; :func:`blur_masks` and :func:`run_mask_pipeline` render on
``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class PseudoImageConfig:
    """Reference configs.py:1-17 as a typed value."""

    cls: str = "chairs"
    text_format: str = "a chair with white background"
    blur_radius: float = 1.0
    blur_samples: int = 20
    resolution: int = 256
    white_threshold: int = 240
    white_ratio: float = 0.6


# ---------------------------------------------------------------------------
# Camera sampling (pi-GAN heritage, reference utils/camera_sampler.py)
# ---------------------------------------------------------------------------

def normalize_vecs(vectors: np.ndarray) -> np.ndarray:
    return vectors / np.linalg.norm(vectors, axis=-1, keepdims=True)


def sample_camera_positions(
    rng: np.random.Generator, n: int = 1, r: float = 1.0,
    horizontal_stddev: float = 1.0, vertical_stddev: float = 1.0,
    horizontal_mean: float = math.pi * 0.5,
    vertical_mean: float = math.pi * 0.5, mode: str = "normal",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """n camera origins on a radius-r sphere (ref camera_sampler.py:35-80).

    Returns (origins (n,3), pitch phi (n,1), yaw theta (n,1)).
    """
    if mode == "uniform":
        theta = (rng.random((n, 1)) - 0.5) * 2 * horizontal_stddev + horizontal_mean
        phi = (rng.random((n, 1)) - 0.5) * 2 * vertical_stddev + vertical_mean
    elif mode in ("normal", "gaussian"):
        theta = rng.standard_normal((n, 1)) * horizontal_stddev + horizontal_mean
        phi = rng.standard_normal((n, 1)) * vertical_stddev + vertical_mean
    elif mode == "hybrid":
        if rng.random() < 0.5:
            theta = (rng.random((n, 1)) - 0.5) * 4 * horizontal_stddev + horizontal_mean
            phi = (rng.random((n, 1)) - 0.5) * 4 * vertical_stddev + vertical_mean
        else:
            theta = rng.standard_normal((n, 1)) * horizontal_stddev + horizontal_mean
            phi = rng.standard_normal((n, 1)) * vertical_stddev + vertical_mean
    elif mode == "spherical_uniform":
        theta = (rng.random((n, 1)) - 0.5) * 2 * horizontal_stddev + horizontal_mean
        v_stddev, v_mean = vertical_stddev / math.pi, vertical_mean / math.pi
        v = np.clip((rng.random((n, 1)) - 0.5) * 2 * v_stddev + v_mean,
                    1e-5, 1 - 1e-5)
        phi = np.arccos(1 - 2 * v)
    else:  # mean only
        theta = np.full((n, 1), horizontal_mean)
        phi = np.full((n, 1), vertical_mean)

    phi = np.clip(phi, 1e-5, math.pi - 1e-5)
    origins = np.concatenate(
        [r * np.sin(phi) * np.cos(theta),
         r * np.sin(phi) * np.sin(theta),
         r * np.cos(phi)], axis=1)
    return origins, phi, theta


def create_cam2world_matrix(forward_vector: np.ndarray,
                            origin: np.ndarray) -> np.ndarray:
    """cam2world from viewing direction + origin (ref :83-101)."""
    forward_vector = normalize_vecs(forward_vector)
    up = np.broadcast_to(np.array([[0.0, 1.0, 0.0]], np.float32),
                         forward_vector.shape)
    left = normalize_vecs(np.cross(up, forward_vector, axis=-1))
    up = normalize_vecs(np.cross(forward_vector, left, axis=-1))
    rot = np.tile(np.eye(4)[None], (forward_vector.shape[0], 1, 1))
    rot[:, :3, :3] = np.stack((-left, up, -forward_vector), axis=-1)
    trans = np.tile(np.eye(4)[None], (forward_vector.shape[0], 1, 1))
    trans[:, :3, 3] = origin
    return trans @ rot


def sample_camera_pose(
    rng: np.random.Generator, batch_size: int, radius: float = 2.7,
    h_stddev: float = 1.0, v_stddev: float = 1.0,
    h_mean: float = math.pi * 0.5, v_mean: float = math.pi * 0.5,
    mode: str = "normal", intrinsics: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(B, 25) flattened [cam2world(16), K(9)] poses (ref :16-33)."""
    origins, pitch, yaw = sample_camera_positions(
        rng, n=batch_size, r=radius, horizontal_stddev=h_stddev,
        vertical_stddev=v_stddev, horizontal_mean=h_mean,
        vertical_mean=v_mean, mode=mode)
    cam2world = create_cam2world_matrix(normalize_vecs(-origins), origins)
    if intrinsics is None:
        intrinsics = np.array(
            [525.0, 0, 256.0, 0, 525.0, 256.0, 0, 0, 100.0],
            np.float32) / 100.0
    intrinsics = np.repeat(intrinsics[None, :], batch_size, 0)
    pose = np.concatenate(
        [cam2world.reshape(batch_size, 16), intrinsics], axis=1
    ).astype(np.float32)
    return pose, pitch, yaw


# ---------------------------------------------------------------------------
# Attribute → text composition (reference utils/text_util.py)
# ---------------------------------------------------------------------------

def read_attr(path: str) -> List[Dict]:
    """Attribute json → [{'name', 'attr': {'size','shape','color'}}]."""
    with open(path) as f:
        data = json.load(f)
    return [
        {
            "name": ent["object_name"].replace(" ", "").replace("_", " "),
            "attr": ent["object_attrbution"],
        }
        for ent in data
    ]


def compose_text(entities: Sequence[Dict], mode: str = "compose") -> List[str]:
    """'a <size> <shape> <color> <name>' per entity (ref text_util.py:18-31)."""
    if mode != "compose":
        raise ValueError(f"unknown compose mode {mode!r}")
    texts = []
    for e in entities:
        attr = e["attr"]
        words = ["a"]
        words.extend(attr.get("size", []))
        words.extend(attr.get("shape", []))
        words.extend(attr.get("color", []))
        words.append(e["name"])
        texts.append(" ".join(words))
    return texts


def generate_text(path: str, mode: str = "compose") -> List[str]:
    return compose_text(read_attr(path), mode=mode)


# ---------------------------------------------------------------------------
# Generation sharding + pluggable text→image backend
# ---------------------------------------------------------------------------

def shard_range(device_num: int, total_devices: int, n: int) -> range:
    """Manual argv work sharding (reference Image_generator.py:20-32)."""
    per = (n + total_devices - 1) // total_devices
    return range(device_num * per, min((device_num + 1) * per, n))


ImageGenerator = Callable[[Sequence[str]], np.ndarray]
"""texts -> (B, H, W, 3) uint8.  The reference binds this to GLIDE
(base + upsampler diffusion, glide_util.py:25-51); glide-text2im is not in
this image, so inject any callable (or a diffusion model served elsewhere).
"""


def generate_images(texts: Sequence[str], generator: Optional[ImageGenerator],
                    *, device_num: int = 0, total_devices: int = 1
                    ) -> Tuple[np.ndarray, List[int]]:
    """Run the (injected) text→image backend over this shard's texts."""
    if generator is None:
        raise RuntimeError(
            "no text->image backend available: glide-text2im is not bundled; "
            "pass generator=... (any texts -> (B,H,W,3) uint8 callable)")
    idx = list(shard_range(device_num, total_devices, len(texts)))
    imgs = generator([texts[i] for i in idx])
    return np.asarray(imgs, np.uint8), idx


# ---------------------------------------------------------------------------
# Filtering, mask extraction, blurring
# ---------------------------------------------------------------------------

def is_white_background(img: np.ndarray, p: float = 0.6,
                        threshold: int = 240) -> bool:
    """True if the 5px border is >p white (reference Image_filter.py:16-21)."""
    top, bottom = img[:5].reshape(-1, 3), img[-5:].reshape(-1, 3)
    left = img[5:-5, :5].reshape(-1, 3)
    right = img[5:-5, -5:].reshape(-1, 3)
    side = np.concatenate([top, bottom, left, right], axis=0)
    white = np.sum(np.prod(side >= threshold, axis=-1))
    return white / side.shape[0] > p


def filter_images(images: np.ndarray, cfg: PseudoImageConfig = PseudoImageConfig()
                  ) -> np.ndarray:
    """Indices of images that pass the white-background check."""
    return np.array([
        i for i, img in enumerate(images)
        if is_white_background(img, cfg.white_ratio, cfg.white_threshold)
    ], np.int64)


def extract_mask(img: np.ndarray, threshold: int = 240) -> np.ndarray:
    """255 where the object is (any channel > threshold fails white test),
    0 on background (reference extract_mask.py:19-27)."""
    mask = np.full_like(img, 255)
    bg = np.nonzero(1 - np.prod(img <= threshold, axis=-1))
    mask[bg] = 0
    return mask


def blur_masks(masks: np.ndarray, cfg: PseudoImageConfig = PseudoImageConfig(),
               device=None) -> np.ndarray:
    """Binarize then blur through Pixel2Mask (ref preprocess_mask.py:25-32).

    masks: (B, H, W, 3) uint8.  Returns (B, res, res, 3) float32 arrays.
    """
    from tdwss_torch.ops.point2mask import Pixel2Mask

    masks = np.asarray(masks).copy()
    masks[masks < 127] = 0
    masks[masks >= 128] = 255
    out = Pixel2Mask(radius=cfg.blur_radius, nsample=cfg.blur_samples,
                     device=device)(masks, cfg.resolution)
    return out.cpu().numpy()


def run_mask_pipeline(images: np.ndarray,
                      cfg: PseudoImageConfig = PseudoImageConfig(),
                      device=None) -> Tuple[np.ndarray, np.ndarray]:
    """filter → extract → blur; returns (kept_indices, blurred_masks).

    Mirrors the create_dataset.sh stage chain minus the GLIDE generation
    step (which needs an injected backend, see :func:`generate_images`).
    Masks that blur to all-zero are dropped (preprocess_mask.py:37-41).
    """
    keep = filter_images(images, cfg)
    if keep.size == 0:
        return keep, np.zeros((0, cfg.resolution, cfg.resolution, 3))
    raw = np.stack([extract_mask(images[i], cfg.white_threshold)
                    for i in keep])
    blurred = blur_masks(raw, cfg, device)
    nonzero = np.array([m.any() for m in blurred], bool)
    return keep[nonzero], blurred[nonzero]
