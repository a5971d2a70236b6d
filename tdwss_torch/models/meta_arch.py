"""Meta-architectures (twin of :mod:`tdwss.models.meta_arch`).

``MultiLabel`` (reference models/MultiLabelContrastive.py:50-70): a
point-cloud encoder and a ``linear(embed -> 20)`` head.  Its eval path
gives per-point logits; its training path (``istrain=True``) gives scene
logits over the encoder's pooled scene features.

``FullySupervised`` (reference models/MultiLabelContrastive.py:72-101):
the same encoder and head, trained on per-point (pseudo) labels; its
training path gives ``(scene logits, per-point logits)``, the scene
logits being the per-scene mean of the point logits.

``MultiLabelContrastive`` (reference models/MultiLabelContrastive.py:7-47):
``MultiLabel`` plus a text tower (:mod:`tdwss_torch.models.transformer`)
and ``text_linear(width -> embed)``; its training path gives
``(scene logits, (scene features, text features (B', T, embed),
has_text))`` for the ``TextContrastive`` loss, its eval path per-point
logits as ``MultiLabel``'s.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tdwss_torch import NUM_CLASSES
from tdwss_torch.config import (EngineConfig, PointcloudModelConfig,
                                TextModelConfig)
from tdwss_torch.data.batch import PointBatch
from tdwss_torch.device import resolve_device
from tdwss_torch.models.sparse_encoders import (build_sparse_encoder,
                                                embed_length_of)
from tdwss_torch.models.transformer import (build_text_encoder,
                                            normal_linear)
from tdwss_torch.ops.segment import segment_mean_by_batch
from tdwss_torch.ops.windowed import KMAX
from tdwss_torch.registry import MODEL_REGISTRY
from tdwss_torch.utils import profiling


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
    enc = build_sparse_encoder(pc_config, engine.compute_dtype, generator,
                               engine)
    return enc, enc.out_width


def _head(fan_in: int, fan_out: int, gen: torch.Generator) -> nn.Linear:
    """``nn.Linear`` with a normal(0, 1/fan_in) weight and a zero bias."""
    return normal_linear(fan_in, fan_out, (1.0 / fan_in) ** 0.5, gen)


@MODEL_REGISTRY.register()
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
        self.linear = _head(embed, NUM_CLASSES, gen)
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


@MODEL_REGISTRY.register(reads_point_coords=True)
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


@MODEL_REGISTRY.register()
class MultiLabelContrastive(MultiLabel):
    """Scene-tag classification + text-scene contrastive alignment.

    The text tower runs in float32 on every (scene, slot) row of the
    batch's tokens, the empty slots included, as in the reference.
    ``text_linear`` maps its width to the encoder registry's
    ``embed_length``, which the contrastive loss multiplies with the
    pooled scene features: a config where that differs from the
    encoder's output width is refused here (the reference fails in the
    loss).  Parameters are drawn as :class:`MultiLabel`'s, then the text
    tower's and ``text_linear``'s (normal(0, 1/width), zero bias).

    While a torch profiler records, the tower with ``text_linear`` is the
    span ``tdwss.text.tower`` and the counter ``tdwss.text.rows`` adds
    the token rows it computes (:mod:`tdwss_torch.utils.profiling`)."""

    def __init__(self, pc_config: PointcloudModelConfig,
                 text_config: TextModelConfig,
                 engine: Optional[EngineConfig] = None, seed: int = 0,
                 device=None):
        nn.Module.__init__(self)
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.pc_encoder, width = build_encoder(pc_config, engine, gen)
        embed = embed_length_of(pc_config.name, pc_config.m)
        if embed != width:
            raise ValueError(
                f"{pc_config.name} at m={pc_config.m}: text_linear maps to "
                f"the registry's embed_length {embed}, but the encoder's "
                f"output width is {width}; the text-scene similarity needs "
                f"them equal")
        self.linear = _head(width, NUM_CLASSES, gen)
        self.text_encoder = build_text_encoder(text_config, gen)
        self.text_linear = _head(self.text_encoder.width, embed, gen)
        self.to(dev)

    def forward(self, batch: PointBatch, istrain: bool = False,
                train: Optional[bool] = None):
        """Per-point logits (N, 20) float32; with ``istrain``, ``(scene
        logits (B, 20), (scene features (B, embed), text features
        (B', T, embed) or None, has_text (B',) or None))``."""
        if not istrain:
            return super().forward(batch, istrain=False, train=train)
        text = batch.text
        tfeats = None
        if text is not None and text.tokens.shape[0] > 0:
            bt, nt, length = text.tokens.shape
            with profiling.span("tdwss.text.tower"):
                profiling.count("tdwss.text.rows", bt * nt)
                tfeats = self.text_encoder(text.tokens.reshape(-1, length))
                tfeats = self.text_linear(tfeats.reshape(bt, nt, -1))
        gfeats = self.pc_encoder(
            batch.coords, batch.feats, batch.valid, istrain=True,
            train=True if train is None else train,
            num_scenes=batch.num_scenes, plans=batch.plans,
            vox_feats=batch.vox_feats, point2voxel=batch.point2voxel,
            point_perm=batch.point_perm)
        return self.linear(gfeats), (
            gfeats, tfeats, None if text is None else text.has_text)


def model_reads(name: str) -> Tuple[bool, bool]:
    """``(reads_point_coords, reads_point_leaves)`` of the training step
    of the meta-architecture ``name``.  The point leaves are
    ``point2voxel``, ``point_perm``, ``point_label`` and ``valid``.  A
    name that is not a registered meta-architecture reads everything."""
    try:
        cls, _ = MODEL_REGISTRY.get(name)
    except KeyError:
        return True, True
    if not (isinstance(cls, type) and issubclass(cls, MultiLabel)):
        return True, True
    return cls.reads_point_coords, cls.reads_point_leaves


def build_model(cfg, seed: int = 0, device=None) -> nn.Module:
    """Model named by ``cfg.model_name`` in ``MODEL_REGISTRY`` (reference
    train.py:31-32); a name it does not hold raises its ``KeyError``."""
    cls, _ = MODEL_REGISTRY.get(cfg.model_name)
    if not (isinstance(cls, type) and issubclass(cls, MultiLabel)):
        raise KeyError(f"'{cfg.model_name}' in '{MODEL_REGISTRY.name}' "
                       f"registry is not a meta-architecture")
    if (cfg.has_text and cfg.text_model.name == "CLIPTransformer"
            and not cfg.text_data.bpe_vocab_path):
        # The frozen CLIP tower's embedding was trained on clip.tokenize
        # ids (reference dataset/data.py:13,195); the fallback tokenizers'
        # ids would silently destroy the text signal.
        raise ValueError(
            "text_model.name=CLIPTransformer requires text_data."
            "bpe_vocab_path to point at the real CLIP "
            "bpe_simple_vocab_16e6.txt.gz (the repository does not ship "
            "it); the fallback tokenizers emit ids the frozen embedding "
            "was never trained on.")
    if cls is MultiLabelContrastive:
        return cls(cfg.pointcloud_model, cfg.text_model, cfg.engine,
                   seed=seed, device=device)
    return cls(cfg.pointcloud_model, cfg.engine, seed=seed, device=device)
