"""KPFCNN: encoder/decoder kernel-point FCN for semantic segmentation
(twin of :mod:`tdwss.models.kpconv.architectures`).

The encoder is built from the config's architecture list with a skip at
every downsampling, the decoder from nearest-upsample + unary blocks with
skip concatenation, then a two-unary head; the loss is the masked
cross-entropy plus the point2point deformable fitting regularizer.  The
whole network is static-shape over the padded :class:`KPBatch` pyramid.
The reference's module docstring speaks of ``jax.checkpoint`` around each
block, but its code has none; neither has this module.

Blocks are named as flax names them (a counter per block class, in the
order they are built: ``SimpleBlock_0``, ``ResnetBottleneckBlock_3``,
``_UnaryAdapter_1``, ...), so the reference's variables convert one to
one (:func:`tdwss_torch.convert.flax_to_state_dict`).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tdwss_torch.device import resolve_device
from tdwss_torch.models.kpconv.blocks import (KPBatch, UnaryBlock,
                                              block_decider, block_out_dim)
from tdwss_torch.models.kpconv.config import KPConvConfig
from tdwss_torch.models.kpconv.ops import p2p_fitting_regularizer
from tdwss_torch.models.layers import acc_dtype
from tdwss_torch.registry import MODEL_REGISTRY


def _plan_blocks(cfg: KPConvConfig):
    """The construction loops of the original KPFCNN.

    Returns (encoder_specs, decoder_specs, encoder_skips, decoder_concats,
    head_in_dim); each spec is (block_name, radius, in_dim, out_dim,
    layer_ind).
    """
    layer = 0
    r = cfg.first_subsampling_dl * cfg.conv_radius
    in_dim = cfg.in_features_dim
    out_dim = cfg.first_features_dim

    encoder_specs, encoder_skips, encoder_skip_dims = [], [], []
    for block_i, block in enumerate(cfg.architecture):
        if any(t in block for t in ("pool", "strided", "upsample", "global")):
            encoder_skips.append(block_i)
            encoder_skip_dims.append(in_dim)
        if "upsample" in block:
            break
        encoder_specs.append((block, r, in_dim, out_dim, layer))
        in_dim = out_dim // 2 if "simple" in block else out_dim
        if "pool" in block or "strided" in block:
            layer += 1
            r *= 2
            out_dim *= 2

    start_i = next(
        (i for i, b in enumerate(cfg.architecture) if "upsample" in b),
        len(cfg.architecture),
    )
    decoder_specs, decoder_concats = [], []
    for block_i, block in enumerate(cfg.architecture[start_i:]):
        prev = cfg.architecture[start_i + block_i - 1]
        if block_i > 0 and "upsample" in prev:
            in_dim += encoder_skip_dims[layer]
            decoder_concats.append(block_i)
        decoder_specs.append((block, r, in_dim, out_dim, layer))
        in_dim = out_dim
        if "upsample" in block:
            layer -= 1
            r *= 0.5
            out_dim = out_dim // 2

    return (encoder_specs, decoder_specs, encoder_skips, decoder_concats,
            out_dim)


@MODEL_REGISTRY.register()
class KPFCNN(nn.Module):
    """Kernel Point Fully Convolutional Network.

    ``forward(batch, train)`` -> (logits (N0, num_classes), auxes), the
    batch a :class:`KPBatch` of tensors on the model's device.
    Parameters are drawn from ``torch.Generator().manual_seed(seed)`` on
    the CPU and moved to ``device`` (``cuda`` unless the caller asks
    otherwise).
    """

    def __init__(self, config: KPConvConfig = KPConvConfig(), seed: int = 0,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.config = cfg = config
        (enc_specs, dec_specs, self.enc_skips, self.dec_concats, _
         ) = _plan_blocks(cfg)
        counters: Dict[str, int] = collections.Counter()

        def build(spec) -> Tuple[str, int]:
            name, r, in_dim, out_dim, layer = spec
            mod = block_decider(name, r, in_dim, out_dim, layer, cfg, gen)
            cls = type(mod).__name__
            key = f"{cls}_{counters[cls]}"
            counters[cls] += 1
            self.add_module(key, mod)
            return key, block_out_dim(name, in_dim, out_dim)

        self.enc_names: List[str] = []
        self.dec_names: List[str] = []
        width = cfg.in_features_dim
        for spec in enc_specs:
            key, width = build(spec)
            self.enc_names.append(key)
        for spec in dec_specs:
            key, width = build(spec)
            self.dec_names.append(key)
        self.head_mlp = UnaryBlock(width, cfg.first_features_dim,
                                   use_bn=False, generator=gen)
        self.head_softmax = UnaryBlock(cfg.first_features_dim,
                                       cfg.num_classes, use_bn=False,
                                       no_relu=True, generator=gen)
        self.to(dev)

    def forward(self, batch: KPBatch, train: bool = False
                ) -> Tuple[torch.Tensor, List]:
        x = batch.features
        auxes: List = []
        skip_x = []
        for block_i, key in enumerate(self.enc_names):
            if block_i in self.enc_skips:
                skip_x.append(x)
            x, aux = getattr(self, key)(x, batch, train)
            auxes.extend(aux)
        for block_i, key in enumerate(self.dec_names):
            if block_i in self.dec_concats:
                x = torch.cat([x, skip_x.pop()], dim=1)
            x, aux = getattr(self, key)(x, batch, train)
            auxes.extend(aux)
        x = self.head_mlp(x, batch.valids[0], train)
        logits = self.head_softmax(x, batch.valids[0], train)
        return logits, auxes


def kpfcnn_loss(logits: torch.Tensor, labels: torch.Tensor, auxes: List,
                cfg: KPConvConfig) -> torch.Tensor:
    """Masked cross-entropy (with class weights when set) + the p2p
    fitting regularizer."""
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = F.log_softmax(logits.to(acc_dtype(logits.dtype)), dim=-1)
    nll = -torch.take_along_dim(logp, safe[:, None], dim=1)[:, 0]
    if cfg.class_w:
        w = torch.tensor(cfg.class_w, dtype=logp.dtype,
                         device=logits.device)[safe]
        nll = nll * w
        denom = torch.sum(torch.where(valid, w, torch.zeros_like(w)))
    else:
        denom = torch.clamp(valid.sum(), min=1)
    ce = torch.sum(torch.where(valid, nll, torch.zeros_like(nll))) / denom

    reg = 0.0
    if auxes and cfg.deform_fitting_mode == "point2point":
        reg = p2p_fitting_regularizer(
            [a.min_d2 for a, _ in auxes], [a.deformed_kp for a, _ in auxes],
            [e for _, e in auxes], repulse_extent=cfg.repulse_extent,
            deform_fitting_power=cfg.deform_fitting_power)
    return ce + reg


def deform_param_labels(model: nn.Module) -> Dict[str, str]:
    """'deform' or 'main' per parameter name: 'deform' for the offset
    convs and offset biases (every name with a part holding "offset"),
    as the reference's label tree for ``optax.multi_transform``."""
    return {name: "deform" if any("offset" in part
                                  for part in name.split(".")) else "main"
            for name, _ in model.named_parameters()}


def param_groups(model: nn.Module, lr: float) -> List[Dict]:
    """The two Adam parameter groups of the labels: 'main' at ``lr``,
    'deform' at ``lr * model.config.deform_lr_factor``.  An empty group
    is left out."""
    labels = deform_param_labels(model)
    groups = []
    for label, group_lr in (("main", lr),
                            ("deform", lr * model.config.deform_lr_factor)):
        params = [p for n, p in model.named_parameters()
                  if labels[n] == label]
        if params:
            groups.append({"params": params, "lr": group_lr, "name": label})
    return groups
