"""Meta-architectures (twin of :mod:`tdwss.models.meta_arch`).

``MultiLabel`` (reference models/MultiLabelContrastive.py:50-70): a
point-cloud encoder and a ``linear(embed -> 20)`` head.  Its eval path
gives per-point logits; its training path (``istrain=True``) gives scene
logits over the encoder's pooled scene features.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tdwss_torch import NUM_CLASSES
from tdwss_torch.config import EngineConfig, PointcloudModelConfig
from tdwss_torch.data.batch import PointBatch
from tdwss_torch.device import resolve_device
from tdwss_torch.models.sparse_encoders import SparseConvUNet


def build_encoder(pc_config: PointcloudModelConfig,
                  engine: Optional[EngineConfig] = None,
                  generator: Optional[torch.Generator] = None):
    """Encoder module and its embedding width."""
    if pc_config.name != "SparseConvUNet":
        raise NotImplementedError(
            f"encoder {pc_config.name!r} is not ported yet")
    engine = engine or EngineConfig()
    enc = SparseConvUNet(m=pc_config.m, block_reps=pc_config.block_reps,
                         residual_blocks=pc_config.residual_blocks,
                         downsample=tuple(pc_config.downsample),
                         compute_dtype=engine.compute_dtype,
                         generator=generator)
    return enc, pc_config.m


class MultiLabel(nn.Module):
    """No-text scene-tag classifier.

    Parameters are drawn from ``torch.Generator().manual_seed(seed)`` on
    the CPU (He-normal convs, normal(0, 1/fan_in) head, zero bias) and
    then moved to ``device`` (``cuda`` unless the caller asks otherwise).
    """

    # What its training step reads of the point domain (see model_reads):
    # the encoder pools voxels, so neither point coordinates nor the
    # per-point leaves.
    reads_point_coords = False
    reads_point_leaves = False

    def __init__(self, pc_config: PointcloudModelConfig,
                 engine: Optional[EngineConfig] = None, seed: int = 0,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.pc_encoder, embed = build_encoder(pc_config, engine, gen)
        self.linear = nn.Linear(embed, NUM_CLASSES)
        with torch.no_grad():
            self.linear.weight.copy_(
                torch.randn((NUM_CLASSES, embed), generator=gen)
                * (1.0 / embed) ** 0.5)
            self.linear.bias.zero_()
        self.to(dev)

    def forward(self, batch: PointBatch, istrain: bool = False,
                train: Optional[bool] = None):
        """Per-point logits (N, 20) float32 from a batch on this device;
        with ``istrain``, ``(scene logits (B, 20), None)`` with batch norm
        in train mode, as the reference returns them."""
        train = istrain if train is None else train
        feats = self.pc_encoder(
            batch.coords, batch.feats, batch.valid, istrain=istrain,
            train=train, num_scenes=batch.num_scenes, plans=batch.plans,
            vox_feats=batch.vox_feats, point2voxel=batch.point2voxel,
            point_perm=batch.point_perm)
        logits = self.linear(feats)
        return (logits, None) if istrain else logits


MODELS = {"MultiLabel": MultiLabel}

# Meta-architectures not ported yet, with what the reference registers
# for their training steps (``tdwss/models/meta_arch.py:75``, ``:139``):
# FullySupervised pools point logits by ``coords[:, 3]`` and trains on
# the point labels.
_UNPORTED_READS = {"MultiLabelContrastive": (False, False),
                   "FullySupervised": (True, True)}


def model_reads(name: str) -> Tuple[bool, bool]:
    """``(reads_point_coords, reads_point_leaves)`` of the training step
    of the meta-architecture ``name``.  The point leaves are
    ``point2voxel``, ``point_perm``, ``point_label`` and ``valid``.  An
    unknown name reads everything."""
    cls = MODELS.get(name)
    if cls is not None:
        return cls.reads_point_coords, cls.reads_point_leaves
    return _UNPORTED_READS.get(name, (True, True))


def build_model(cfg, seed: int = 0, device=None) -> nn.Module:
    """Model named by ``cfg.model_name`` (only MultiLabel is ported)."""
    cls = MODELS.get(cfg.model_name)
    if cls is None:
        raise NotImplementedError(f"model {cfg.model_name!r} is not ported")
    return cls(cfg.pointcloud_model, cfg.engine, seed=seed, device=device)
