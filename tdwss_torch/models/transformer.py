"""CLIP-architecture text towers (twin of :mod:`tdwss.models.transformer`).

``TextTransformer`` (reference models/Transformer.py:64-120): token
embedding + learned positional embedding, pre-LN residual blocks with
causal self-attention and a 4x QuickGELU MLP, a final LayerNorm, and the
hidden state at the EOT position (the argmax of the token ids; an
all-zero row pools at position 0) as the sequence feature.
``CLIPTransformer`` (reference :123-140): the same tower at CLIP's fixed
sizes, frozen, its output detached.

Everything runs in float32, as in the reference, whatever the point-cloud
encoder's compute dtype.  The attention is plain tensor ops in the order
of flax's ``MultiHeadDotProductAttention``: per-head q/k/v projections,
q divided by sqrt(head_dim), the causal mask as ``finfo(f32).min``,
softmax, ``@ v``, the ``out`` projection.  The reference computes it
outside any Pallas kernel, so no hand-written kernel backs it here.

Module and parameter names follow the reference's flax tree
(``resblock_<i>/attn/query``, ``c_fc``, ``ln_final``, ...), so
:mod:`tdwss_torch.convert` maps one onto the other.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

LN_EPS = 1e-5


def heads_of(width: int) -> int:
    """Attention heads of a tower of ``width`` (reference :84)."""
    return max(1, width // 64)


def _normal_(param: torch.Tensor, std: float,
             generator: Optional[torch.Generator]) -> None:
    with torch.no_grad():
        param.copy_(torch.randn(param.shape, generator=generator) * std)


def normal_linear(fan_in: int, fan_out: int, std: float,
           generator: Optional[torch.Generator]) -> nn.Linear:
    """``nn.Linear`` with a normal(0, std) weight and a zero bias (flax
    Dense's ``kernel_init`` / zero ``bias_init``)."""
    lin = nn.Linear(fan_in, fan_out)
    _normal_(lin.weight, std, generator)
    with torch.no_grad():
        lin.bias.zero_()
    return lin


class QuickGELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(1.702 * x)


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (``qkv_features = width``)
    over one sequence batch, causal self-attention; ``query`` /
    ``key`` / ``value`` / ``out`` hold flax's (in, heads, head_dim) and
    (heads, head_dim, out) kernels as ``nn.Linear`` weights."""

    def __init__(self, width: int, heads: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if width % heads:
            raise ValueError(f"width {width} is not a multiple of "
                             f"{heads} heads")
        self.heads = heads
        std = width ** -0.5
        self.query = normal_linear(width, width, std, generator)
        self.key = normal_linear(width, width, std, generator)
        self.value = normal_linear(width, width, std, generator)
        self.out = normal_linear(width, width, std, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, length, width = x.shape
        h, d = self.heads, width // self.heads
        q = self.query(x).view(b, length, h, d) / math.sqrt(d)
        k = self.key(x).view(b, length, h, d)
        v = self.value(x).view(b, length, h, d)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        mask = torch.ones((length, length), dtype=torch.bool,
                          device=x.device).tril()
        w = w.masked_fill(~mask, torch.finfo(w.dtype).min)
        w = torch.softmax(w, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, length, width)
        return self.out(o)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN attention + QuickGELU MLP block (reference
    models/utils.py:33-50), initialised as the reference's."""

    def __init__(self, width: int, heads: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = Attention(width, heads, generator)
        self.ln_2 = nn.LayerNorm(width, eps=LN_EPS)
        self.c_fc = normal_linear(width, 4 * width, (2 * width) ** -0.5,
                                  generator)
        self.gelu = QuickGELU()
        self.c_proj = normal_linear(4 * width, width, width ** -0.5,
                                    generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.c_proj(self.gelu(self.c_fc(self.ln_2(x))))


class TextTransformer(nn.Module):
    """Trainable CLIP-architecture text encoder (reference
    Transformer.py:64-120): (B, L) int token ids -> (B, width) float32
    EOT features.  Parameters are drawn from ``generator`` on the CPU."""

    def __init__(self, context_length: int = 120, width: int = 256,
                 layers: int = 12, vocab_size: int = 49408,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.width = width
        self.token_embedding = nn.Embedding(vocab_size, width)
        _normal_(self.token_embedding.weight, 0.02, generator)
        self.positional_embedding = nn.Parameter(
            torch.empty(context_length, width))
        _normal_(self.positional_embedding, 0.01, generator)
        heads = heads_of(width)
        for i in range(layers):
            self.add_module(f"resblock_{i}", ResidualAttentionBlock(
                width, heads, generator=generator))
        self.layers = layers
        self.ln_final = nn.LayerNorm(width, eps=LN_EPS)

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        length = text.shape[1]
        x = (self.token_embedding(text.long())
             + self.positional_embedding[:length][None])
        for i in range(self.layers):
            x = getattr(self, f"resblock_{i}")(x)
        x = self.ln_final(x)
        eot = text.argmax(dim=-1)
        return x[torch.arange(x.shape[0], device=x.device), eot]


class CLIPTransformer(nn.Module):
    """Frozen CLIP text tower (reference Transformer.py:123-140) at CLIP's
    fixed sizes (77 tokens, width 512, 12 layers, vocab 49,408): its
    parameters take no gradient and its output is detached.

    ``clip_weights_path`` is kept and read by nothing, as in the
    reference, whose model never calls :meth:`load_pretrained_params`;
    the tower runs with its initial weights unless the caller loads
    converted ones (``flax_to_state_dict(load_pretrained_params(p))``)."""

    def __init__(self, context_length: int = 77, width: int = 512,
                 layers: int = 12, vocab_size: int = 49408,
                 clip_weights_path: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.width = width
        self.clip_weights_path = clip_weights_path
        self.clip_text = TextTransformer(context_length, width, layers,
                                         vocab_size, generator)
        self.clip_text.requires_grad_(False)

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        return self.clip_text(text).detach()

    @staticmethod
    def load_pretrained_params(path: str) -> Dict:
        """A converted CLIP text-tower ``.npz`` (flat, ``'/'``-joined keys,
        see :mod:`tdwss_torch.models.clip_import`) as a nested dict of
        numpy arrays, the reference's parameter tree."""
        tree: Dict = {}
        with np.load(path) as flat:
            for key in flat.files:
                parts = key.split("/")
                node = tree
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = np.asarray(flat[key])
        return tree


TEXT_MODELS = {"TextTransformer": TextTransformer,
               "CLIPTransformer": CLIPTransformer}


def build_text_encoder(text_config,
                       generator: Optional[torch.Generator] = None
                       ) -> nn.Module:
    """The configured text tower; ``CLIPTransformer`` keeps its fixed
    sizes whatever the config's (reference meta_arch.py:59-72)."""
    cls = TEXT_MODELS.get(text_config.name)
    if cls is None:
        raise KeyError(f"unknown text model {text_config.name!r}")
    if cls is CLIPTransformer:
        return cls(clip_weights_path=text_config.clip_weights_path,
                   generator=generator)
    return cls(context_length=text_config.context_length,
               width=text_config.width, layers=text_config.layers,
               vocab_size=text_config.vocab_size, generator=generator)
