"""Meta-architectures (twin of :mod:`tdwss.models.meta_arch`).

``MultiLabel`` (reference models/MultiLabelContrastive.py:50-70): a
point-cloud encoder and a ``linear(embed -> 20)`` head.  Its eval path
gives per-point logits; its training path (``istrain=True``) gives scene
logits over the encoder's pooled scene features.

``FullySupervised`` (reference models/MultiLabelContrastive.py:72-101):
the same encoder and head, trained on per-point (pseudo) labels; its
training path gives ``(scene logits, per-point logits)``, the scene
logits being the per-scene mean of the point logits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tdwss_torch import NUM_CLASSES
from tdwss_torch.config import EngineConfig, PointcloudModelConfig
from tdwss_torch.data.batch import PointBatch
from tdwss_torch.device import resolve_device
from tdwss_torch.models.sparse_encoders import build_sparse_encoder
from tdwss_torch.ops.segment import segment_mean_by_batch
from tdwss_torch.ops.windowed import KMAX


def build_encoder(pc_config: PointcloudModelConfig,
                  engine: Optional[EngineConfig] = None,
                  generator: Optional[torch.Generator] = None):
    """Encoder module and its output width (the head's input width).

    The config's ``downsample`` is passed to every encoder, over the
    Light class's own (4, 4), as the reference's ``_build_encoder`` does
    (tdwss/models/meta_arch.py:42).  A filter whose cross-level maps have
    more taps than the windowed kernels take (``KMAX``) is refused here.
    """
    f = int(pc_config.downsample[0])
    if f ** 3 > KMAX:
        raise ValueError(
            f"downsample {list(pc_config.downsample)} gives {f ** 3}-tap "
            f"cross-level maps; the windowed kernels take at most {KMAX} "
            f"taps (KMAX in tdwss_torch/csrc/windowed_common.cuh)")
    engine = engine or EngineConfig()
    enc = build_sparse_encoder(pc_config, engine.compute_dtype, generator)
    return enc, enc.out_width


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


class FullySupervised(MultiLabel):
    """Pseudo-label retraining round: per-point logits through the
    differentiable readback (``devoxelize_seg``), batch norm in train
    mode with ``istrain``; parameters drawn as :class:`MultiLabel`'s."""

    # The scene mean pools point logits by coords[:, 3] over the valid
    # points, and the point loss reads the point leaves.
    reads_point_coords = True
    reads_point_leaves = True

    def forward(self, batch: PointBatch, istrain: bool = False,
                train: Optional[bool] = None):
        """Per-point logits (N, 20) float32; with ``istrain``,
        ``(scene logits (B, 20), point logits (N, 20))``."""
        train = istrain if train is None else train
        feats = self.pc_encoder(
            batch.coords, batch.feats, batch.valid, istrain=False,
            train=train, plans=batch.plans, vox_feats=batch.vox_feats,
            point2voxel=batch.point2voxel, point_perm=batch.point_perm)
        logits = self.linear(feats)
        if not istrain:
            return logits
        scene = segment_mean_by_batch(logits, batch.coords[:, 3],
                                      batch.num_scenes, batch.valid)
        return scene, logits


MODELS = {"MultiLabel": MultiLabel, "FullySupervised": FullySupervised}

# Meta-architectures not ported yet, with what the reference registers
# for their training steps (``tdwss/models/meta_arch.py:75``).
_UNPORTED_READS = {"MultiLabelContrastive": (False, False)}


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
    """Model named by ``cfg.model_name`` (MultiLabel or FullySupervised)."""
    cls = MODELS.get(cfg.model_name)
    if cls is None:
        raise NotImplementedError(f"model {cfg.model_name!r} is not ported")
    return cls(cfg.pointcloud_model, cfg.engine, seed=seed, device=device)
