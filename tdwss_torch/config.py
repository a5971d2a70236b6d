"""Typed experiment configuration (twin of :mod:`tdwss.config`).

The dataclasses the ported slice reads, with the reference's defaults and
only the fields the slice reads; :func:`load_config` skips the others.
``yaml`` is imported only inside :func:`load_config`, so building a
config in code needs no YAML package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class PointcloudDataConfig:
    scale: int = 20                  # voxel size = 1/scale metres
    val_reps: int = 1                # multi-view voting repetitions
    batch_size: int = 16
    elastic_deformation: bool = False


@dataclass
class PointcloudModelConfig:
    name: str = "SparseConvUNet"
    m: int = 16
    full_scale: int = 4096           # input field size (grid extent per axis)
    block_reps: int = 1
    residual_blocks: bool = False
    downsample: List[int] = field(default_factory=lambda: [2, 2])


@dataclass
class LossConfig:
    Classification: bool = True
    TextContrastive: bool = False


@dataclass
class EngineConfig:
    """Static capacities and execution knobs (names as in the reference)."""

    max_points: int = 262144         # static per-batch point budget
    max_voxels: int = 0              # 0 => same as max_points
    level_capacity_shrink: int = 2   # per-level voxel capacity divisor
    level_capacity_schedule: Optional[List[int]] = None
    min_level_capacity: int = 2048
    compute_dtype: str = "float32"   # "bfloat16" for the bench config
    host_plans: bool = True          # rulebooks are built on the host
    slim_device_plans: bool = True   # narrow rb_local dtypes, drop dead leaves


@dataclass
class Config:
    training_name: str = "default"
    model_name: str = "MultiLabelContrastive"
    pointcloud_data: PointcloudDataConfig = field(
        default_factory=PointcloudDataConfig)
    label: str = "scene_level"       # scene_level | pseudo (not ported)
    has_text: bool = False
    pointcloud_model: PointcloudModelConfig = field(
        default_factory=PointcloudModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    lr: float = 1e-3
    lr_decay_epochs: int = 100       # StepLR(step_size=100, gamma=0.1)
    lr_decay_gamma: float = 0.1
    seed: int = 0
    engine: EngineConfig = field(default_factory=EngineConfig)


_DATACLASS_FIELDS = {
    (Config, "pointcloud_data"): PointcloudDataConfig,
    (Config, "pointcloud_model"): PointcloudModelConfig,
    (Config, "loss"): LossConfig,
    (Config, "engine"): EngineConfig,
}


def _build(dc_type, raw: Dict[str, Any]):
    """Construct ``dc_type`` from a dict, recursing into nested sections
    and skipping keys this slice does not read."""
    kwargs = {}
    names = {f.name for f in dataclasses.fields(dc_type)}
    for key, value in raw.items():
        if key not in names:
            continue
        target = _DATACLASS_FIELDS.get((dc_type, key))
        if target is not None and isinstance(value, dict):
            kwargs[key] = _build(target, value)
        else:
            kwargs[key] = value
    return dc_type(**kwargs)


def load_config(path: str, **overrides: Any) -> Config:
    """Load a YAML config in the reference's flat or sectioned layout."""
    import yaml

    with open(path, "r") as f:
        raw = yaml.safe_load(f) or {}
    flat: Dict[str, Any] = {}
    for key, value in raw.items():
        if isinstance(value, dict) and key.upper() in (
                "GENERAL", "DATA", "STRUCTURE", "TRAINING", "ENGINE",
                "PSEUDO_LABEL"):
            flat.update(value)
        else:
            flat[key] = value
    flat.update(overrides)
    return _build(Config, flat)
