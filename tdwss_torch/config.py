"""Typed experiment configuration (twin of :mod:`tdwss.config`).

The dataclasses the port reads, with the reference's names and defaults
and only the fields the port reads; :func:`load_config` skips the others.
:func:`load_config` reads the YAML files with :func:`parse_yaml_subset`,
a reader of the part of YAML the repository's config files use, so the
port needs no PyYAML (the card machine has none).
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class PointcloudDataConfig:
    scale: int = 20                  # voxel size = 1/scale metres
    val_reps: int = 1                # multi-view voting repetitions
    batch_size: int = 16
    elastic_deformation: bool = False
    # GSS proposals and the inverse augmentation in the train batch,
    # ``max_boxes`` per scene with a validity mask
    with_boxes: bool = False
    max_boxes: int = 64


@dataclass
class TextDataConfig:
    max_seq_len: int = 120
    cropped_texts: int = 10
    # CLIP-format BPE merges file ("" = the shipped ScanNet-trained asset,
    # falling back to HashTokenizer if that is missing)
    bpe_vocab_path: str = ""


@dataclass
class PointcloudModelConfig:
    name: str = "SparseConvUNet"
    m: int = 16
    dimension: int = 3
    full_scale: int = 4096           # input field size (grid extent per axis)
    block_reps: int = 1
    residual_blocks: bool = False
    depth: int = 7                   # SparseConvFCNet's levels
    n_planes: Optional[List[int]] = None   # FCN variants' planes after m
    downsample: List[int] = field(default_factory=lambda: [2, 2])


@dataclass
class TextModelConfig:
    name: str = "TextTransformer"
    context_length: int = 120
    width: int = 256
    layers: int = 12
    vocab_size: int = 49408
    # CLIPTransformer: a local .npz of converted weights (read by nothing,
    # as in the reference; see tdwss_torch.models.transformer)
    clip_weights_path: Optional[str] = None


@dataclass
class LossConfig:
    Classification: bool = True
    TextContrastive: bool = False


@dataclass
class MeshConfig:
    data: int = 1                    # devices on the data-parallel axis


@dataclass
class EngineConfig:
    """Static capacities and execution knobs (names as in the reference)."""

    max_points: int = 262144         # static per-batch point budget
    max_voxels: int = 0              # 0 => same as max_points
    level_capacity_shrink: int = 2   # per-level voxel capacity divisor
    level_capacity_schedule: Optional[List[int]] = None
    min_level_capacity: int = 2048
    compute_dtype: str = "float32"   # "bfloat16" for the bench config
    # Recompute the encoder body in the backward, one segment as the
    # reference's nn.remat.  It saves no memory: the bench UNet's step
    # peaked at 8.583-8.585 GiB with it, 8.586-8.588 without (NVIDIA H100
    # 80GB HBM3, 700 W; chip_smoke.py's remat phase), at 14-83% more time
    # per step.
    remat: bool = False
    host_plans: bool = True          # rulebooks are built on the host
    slim_device_plans: bool = True   # narrow rb_local dtypes, drop dead leaves
    collate_workers: int = 4         # host collate/plan threads
    prewarm_shapes: bool = True      # converge the sticky plan shapes first
    prewarm_epochs: List[int] = field(default_factory=lambda: [1, 2])
    slim_train_batch: bool = True    # drop train-dead point leaves
    # Read by the reference's plan cache only; the port has no plan cache
    # (see tdwss_torch.data.loader).
    plan_cache_batches: int = 64


@dataclass
class Config:
    training_name: str = "default"
    model_name: str = "MultiLabelContrastive"
    pointcloud_data: PointcloudDataConfig = field(
        default_factory=PointcloudDataConfig)
    label: str = "scene_level"       # scene_level | pseudo | subcloud
    has_text: bool = False
    text_data: TextDataConfig = field(default_factory=TextDataConfig)
    in_radius: float = 2.0           # subcloud sampling radius (metres)
    pseudo_label_path: str = ""
    pseudo_label_suffix: str = "_pseudo_label.npy"
    data_root: str = "dataset/ScanNet"
    box_path: str = ""               # GSS proposals <scene>_prop.npy
    pointcloud_model: PointcloudModelConfig = field(
        default_factory=PointcloudModelConfig)
    text_model: TextModelConfig = field(default_factory=TextModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    pretrain: str = ""               # checkpoint directory seeding a fresh run
    epochs: int = 512
    lr: float = 1e-3
    lr_decay_epochs: int = 100       # StepLR(step_size=100, gamma=0.1)
    lr_decay_gamma: float = 0.1
    seed: int = 0
    # pseudo-label generation (statistics / pseudo_label_generation)
    threshold: float = 0.71
    path: str = "dataset/ScanNet/pseudo_label"
    suffix: str = "_pseudo_label.npy"
    engine: EngineConfig = field(default_factory=EngineConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


_DATACLASS_FIELDS = {
    (Config, "pointcloud_data"): PointcloudDataConfig,
    (Config, "pointcloud_model"): PointcloudModelConfig,
    (Config, "text_data"): TextDataConfig,
    (Config, "text_model"): TextModelConfig,
    (Config, "loss"): LossConfig,
    (Config, "engine"): EngineConfig,
    (Config, "mesh"): MeshConfig,
}


def _build(dc_type, raw: Dict[str, Any]):
    """Construct ``dc_type`` from a dict, recursing into nested sections
    and skipping keys this slice does not read."""
    kwargs = {}
    names = {f.name for f in dataclasses.fields(dc_type)}
    for key, value in raw.items():
        key = {"nPlanes": "n_planes"}.get(key, key)   # the reference's alias
        if key not in names:
            continue
        target = _DATACLASS_FIELDS.get((dc_type, key))
        if target is not None and isinstance(value, dict):
            kwargs[key] = _build(target, value)
        else:
            kwargs[key] = value
    return dc_type(**kwargs)


def _scalar(text: str) -> Any:
    """A plain or quoted YAML scalar: null, bool, int, float or string."""
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] == "'":
        return t[1:-1].replace("''", "'")
    if len(t) >= 2 and t[0] == t[-1] == '"':
        if "\\" in t:
            raise ValueError(f"unsupported YAML escape: {t!r}")
        return t[1:-1]
    low = t.lower()
    if low in ("", "~", "null"):
        return None
    if low in ("true", "false"):
        return low == "true"
    # YAML 1.1's resolvers, as PyYAML reads them: "1e-3" is a string
    if re.fullmatch(r"[-+]?(0|[1-9][0-9_]*)", t):
        return int(t.replace("_", ""))
    if re.fullmatch(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?", t) \
            and any(c.isdigit() for c in t):
        return float(t.replace("_", ""))
    return t


def _flow(text: str, i: int = 0):
    """(value, next index) of the flow collection or scalar at ``i``."""
    while text[i] == " ":
        i += 1
    if text[i] in "[{":
        close = "]" if text[i] == "[" else "}"
        items, i = [], i + 1
        while True:
            while text[i] == " ":
                i += 1
            if text[i] == close:
                i += 1
                break
            if close == "}":
                colon = text.index(":", i)
                key = _scalar(text[i:colon])
                value, i = _flow(text, colon + 1)
                items.append((key, value))
            else:
                value, i = _flow(text, i)
                items.append(value)
            while text[i] == " ":
                i += 1
            if text[i] == ",":
                i += 1
        return (dict(items) if close == "}" else items), i
    j = i
    while j < len(text) and text[j] not in ",]}":
        j += 1
    return _scalar(text[i:j]), j


def _strip_comment(line: str) -> str:
    """``line`` without its comment: a ``#`` at the start or after a
    blank, outside a quoted scalar (one whose quote opens a value)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and line[:i].rstrip()[-1:] in ("", ":", ",", "[",
                                                       "{", "-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def parse_yaml_subset(text: str) -> Dict[str, Any]:
    """The YAML the config files use: nested block mappings by
    indentation, ``key: value`` with plain, quoted or flow (``{...}``,
    ``[...]``) values, and ``#`` comments.  Anything else raises."""
    root: Dict[str, Any] = {}
    # (indent of the key line, its mapping; or, for a key whose value is
    # still empty, (parent mapping, key), made a mapping by a child line)
    stack: List[Any] = [(-1, root)]
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw)
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        if ":" not in body or body.startswith(("-", "&", "*", "|", ">")):
            raise ValueError(f"line {lineno}: unsupported YAML: {raw!r}")
        key, _, rest = body.partition(":")
        while indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        if isinstance(parent, tuple):
            owner, name = parent
            owner[name] = parent = {}
            stack[-1] = (stack[-1][0], parent)
        rest = rest.strip()
        if not rest:
            parent[key.strip()] = None
            stack.append((indent, (parent, key.strip())))
            continue
        value, end = _flow(rest)
        if rest[end:].strip():
            raise ValueError(f"line {lineno}: unsupported YAML: {raw!r}")
        parent[key.strip()] = value
    return root


def load_config(path: str, **overrides: Any) -> Config:
    """Load a YAML config in the reference's flat or sectioned layout."""
    with open(path, "r") as f:
        text = f.read()
    raw = parse_yaml_subset(text)
    flat: Dict[str, Any] = {}
    for key, value in raw.items():
        if isinstance(value, dict) and key.upper() in (
                "GENERAL", "DATA", "STRUCTURE", "TRAINING", "ENGINE",
                "PSEUDO_LABEL"):
            flat.update(value)
        else:
            flat[key] = value
    flat.update(overrides)
    return config_from_dict(flat)


def config_from_dict(raw: Dict[str, Any]) -> Config:
    """A :class:`Config` from a flat dict (nested dicts for its
    sections), skipping keys the port does not read."""
    return _build(Config, raw)
