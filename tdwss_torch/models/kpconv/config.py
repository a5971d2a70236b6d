"""KPConv configuration (twin of :mod:`tdwss.models.kpconv.config`).

A frozen dataclass in place of the original text-file Config class;
defaults mirror its ScannetConfig.  :func:`save_config` and
:func:`load_config` write and read the same ``parameters.txt`` dump as
the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

SCANNET_ARCHITECTURE: Tuple[str, ...] = (
    "simple",
    "resnetb",
    "resnetb_strided",
    "resnetb",
    "resnetb_strided",
    "resnetb_deformable",
    "resnetb_deformable_strided",
    "resnetb_deformable",
    "resnetb_deformable_strided",
    "resnetb_deformable",
    "nearest_upsample",
    "unary",
    "nearest_upsample",
    "unary",
    "nearest_upsample",
    "unary",
    "nearest_upsample",
    "unary",
)


@dataclass(frozen=True)
class KPConvConfig:
    architecture: Tuple[str, ...] = SCANNET_ARCHITECTURE
    num_classes: int = 20
    in_features_dim: int = 4           # 1 (ones) + rgb (ref config.py:445)
    first_features_dim: int = 64
    num_kernel_points: int = 15
    first_subsampling_dl: float = 0.04
    in_radius: float = 2.0
    conv_radius: float = 2.5
    deform_radius: float = 5.0
    KP_extent: float = 1.0
    KP_influence: str = "linear"
    aggregation_mode: str = "sum"
    fixed_kernel_points: str = "center"
    modulated: bool = False
    use_batch_norm: bool = True
    batch_norm_momentum: float = 0.98  # torch convention
    # Deformable-offset regularization (ref config.py:160-168).
    deform_fitting_mode: str = "point2point"
    deform_fitting_power: float = 1.0
    deform_lr_factor: float = 0.1
    repulse_extent: float = 1.2
    class_w: Tuple[float, ...] = ()
    # Host-pyramid static capacities: per-layer neighbor caps (calibrated
    # offline like the reference's batch/neighbor-limit calibration,
    # KPConv_Scannet.py:984); 0 = use the global default.
    neighborhood_limits: Tuple[int, ...] = ()
    default_neighbor_limit: int = 26

    @property
    def num_layers(self) -> int:
        n = 1
        for block in self.architecture:
            if "pool" in block or "strided" in block:
                n += 1
            if "upsample" in block or "global" in block:
                break
        return n


def save_config(cfg: KPConvConfig, path: str) -> None:
    """Write a parameters.txt-style dump (reference config.py:267-382)."""
    import dataclasses

    with open(path, "w") as f:
        for fld in dataclasses.fields(cfg):
            val = getattr(cfg, fld.name)
            if isinstance(val, tuple):
                val = " ".join(str(v) for v in val)
            f.write(f"{fld.name} = {val}\n")


def load_config(path: str) -> KPConvConfig:
    """Read a parameters.txt-style dump back into a KPConvConfig."""
    import dataclasses

    fields = {f.name: f for f in dataclasses.fields(KPConvConfig)}
    kwargs = {}
    with open(path) as f:
        for line in f:
            if "=" not in line:
                continue
            name, _, raw = line.partition("=")
            name, raw = name.strip(), raw.strip()
            if name not in fields:
                continue
            ftype = fields[name].type
            if "Tuple[str" in str(ftype):
                kwargs[name] = tuple(raw.split())
            elif "Tuple[float" in str(ftype):
                kwargs[name] = tuple(float(v) for v in raw.split()) if raw else ()
            elif "Tuple[int" in str(ftype):
                kwargs[name] = tuple(int(v) for v in raw.split()) if raw else ()
            elif "bool" in str(ftype):
                kwargs[name] = raw == "True"
            elif "int" in str(ftype):
                kwargs[name] = int(raw)
            elif "float" in str(ftype):
                kwargs[name] = float(raw)
            else:
                kwargs[name] = raw
    return KPConvConfig(**kwargs)
