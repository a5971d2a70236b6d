"""The plain reference of the text-supervised model: MultiLabelContrastive
over SparseConvFCNet with a CLIP-architecture text tower, in PyTorch with
autograd and no kernel or module of the program.

- The 3D tower is :class:`portbench.reference.model.Net` (its stem,
  blocks, batch norm, strided convs, unpool and scene pooling) with the
  FCN body of the reference project's ``FullyConvolutionalNet`` (SCN's
  ``scn.FullyConvolutionalNet``): planes ``m, 2m, ..., depth * m``, each
  level's output concatenated with the unpooled output of the level
  below, so that level 0 ends ``sum(planes)`` wide.
- The text tower follows CLIP's text transformer (Radford et al., 2021;
  the reference project's ``models/Transformer.py``): token embedding
  plus a learned positional embedding, pre-LN residual blocks of causal
  multi-head self-attention (``width / 64`` heads; q, k, v and output
  projections with biases; scores over ``sqrt(head_dim)``) and a
  ``4 * width`` MLP with QuickGELU (``x * sigmoid(1.702 x)``), a final
  LayerNorm (eps 1e-5), and the hidden state at each row's EOT token,
  the largest id of the row.  ``text_linear`` maps ``width`` to the 3D
  tower's width.
- The loss: the multi-label soft margin over the scene logits plus
  ``TextContrastive`` (the reference project's ``utils/loss.py:6-18``):
  per description slot, the cross-entropy of the softmax over the
  batch's scenes of ``<text feature, scene feature>`` against its own
  scene, averaged over the slots that count.

Departures from the published description: the causal mask fills with
``finfo(float32).min`` where CLIP fills with ``-inf`` (both leave the
masked keys with a weight of exactly 0); the tower runs on every (scene,
slot) row of the batch, the empty slots included, and reads the feature
of an all-zero row at position 0 (an empty slot counts in no loss, so
its feature reaches nothing), as the reference project does; the
weights are drawn from the run's seed, not loaded.

:class:`FCNet`'s ``precision`` is ``float32`` (the reference) or
``fp8`` (the 3D tower's control, :mod:`portbench.reference.model`);
:class:`TextTower`'s is ``float32`` or ``bf16`` (the text tower's
control: every weight and every activation of the tower and of
``text_linear`` rounded to bfloat16, each activation's gradient too, as
a bf16 training recipe computes; sums still in f32).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.model import NUM_CLASSES, Geometry, Leaf, Net

LN_EPS = 1e-5


def fcn_planes(pc: dict) -> Tuple[int, ...]:
    """The FCN's planes, one per level."""
    return tuple((i + 1) * pc["m"] for i in range(pc.get("depth", 7)))


def param_spec(cfg: dict) -> Dict[str, Leaf]:
    """Every parameter of the configured model (``pointcloud_model``,
    ``text_model``), by the dotted path that names it in the program's
    module tree, drawn as the program draws it."""
    pc, tm = cfg["pointcloud_model"], cfg["text_model"]
    if pc["name"] != "SparseConvFCNet" or tm["name"] != "TextTransformer":
        raise KeyError(f"the text reference knows SparseConvFCNet with a "
                       f"TextTransformer, not {pc['name']} with "
                       f"{tm['name']}")
    planes = fcn_planes(pc)
    reps, residual = pc["block_reps"], pc["residual_blocks"]
    spec: Dict[str, Leaf] = {}

    def bn(p, c):
        spec[p + "bn.weight"] = Leaf((c,), "ones")
        spec[p + "bn.bias"] = Leaf((c,), "zeros")

    def conv(p, k, a, b):
        spec[p + "kernel"] = Leaf((k, a, b), "he", k * a)

    def block(p, c):
        if residual:
            bn(p + "bnrelu1.", c)
            conv(p + "conv1.", 27, c, c)
            bn(p + "bnrelu2.", c)
            conv(p + "conv2.", 27, c, c)
        else:
            bn(p + "bnrelu.", c)
            conv(p + "conv.", 27, c, c)

    def body(p, pl):
        for i in range(reps):
            block(f"{p}enc{i}.", pl[0])
        if len(pl) > 1:
            bn(p + "down_bnrelu.", pl[0])
            conv(p + "down_conv.", 8, pl[0], pl[1])
            body(p + "inner.", pl[1:])

    conv("pc_encoder.stem.", 27, 3, planes[0])
    body("pc_encoder.body.", planes)
    width = sum(planes)
    bn("pc_encoder.final_bnrelu.", width)
    spec["linear.weight"] = Leaf((NUM_CLASSES, width), "head", width)
    spec["linear.bias"] = Leaf((NUM_CLASSES,), "zeros")

    # normal(0, std) as a "head" leaf of fan_in 1 / std^2
    d, t = tm["width"], "text_encoder."

    def dense(p, a, b, fan):
        spec[p + "weight"] = Leaf((b, a), "head", fan)
        spec[p + "bias"] = Leaf((b,), "zeros")

    def ln(p):
        spec[p + "weight"] = Leaf((d,), "ones")
        spec[p + "bias"] = Leaf((d,), "zeros")

    spec[t + "token_embedding.weight"] = Leaf((tm["vocab_size"], d), "head",
                                              2500)
    spec[t + "positional_embedding"] = Leaf((tm["context_length"], d),
                                            "head", 10000)
    for i in range(tm["layers"]):
        p = f"{t}resblock_{i}."
        ln(p + "ln_1.")
        for proj in ("query", "key", "value", "out"):
            dense(f"{p}attn.{proj}.", d, d, d)
        ln(p + "ln_2.")
        dense(p + "c_fc.", d, 4 * d, 2 * d)
        dense(p + "c_proj.", 4 * d, d, d)
    ln(t + "ln_final.")
    dense("text_linear.", d, width, d)
    return spec


# --- the 3D tower ---------------------------------------------------------

class FCNet(Net):
    """:class:`Net` with the FCN body and its pooled scene features."""

    def __init__(self, pc: dict, params: Dict[str, torch.Tensor],
                 precision: str = "float32"):
        self.planes, self.kind = fcn_planes(pc), "fcn"
        self.reps, self.residual = pc["block_reps"], pc["residual_blocks"]
        self.p = params
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def body(self, name, x, g: Geometry, lvl: int):
        for i in range(self.reps):
            x = self.block(f"{name}enc{i}.", x, g.subm[lvl])
        if lvl + 1 == len(self.planes):
            return x
        d = g.downs[lvl]
        h = self.bnrelu(name + "down_bnrelu.", x)
        h = self.down(name + "down_conv.", h, d, g.levels[lvl + 1].size)
        h = self.body(name + "inner.", h, g, lvl + 1)
        return torch.cat([x, self.unpool(h, d)], dim=1)

    def scene_features(self, g: Geometry, feats: torch.Tensor,
                       num_scenes: int) -> torch.Tensor:
        """(B, sum(planes)) pooled scene features of the batch whose
        points carry ``feats``: each scene's mean over its points of the
        final batch norm's output at the point's voxel."""
        lv0 = g.levels[0]
        keep = g.point_voxel >= 0
        pv = g.point_voxel[keep]
        vox = feats.new_zeros(lv0.size, feats.shape[1]).index_add(
            0, pv, feats[keep]) / lv0.counts[:, None].to(feats.dtype)
        h = self.subm("pc_encoder.stem.", self._a(vox), g.subm[0])
        h = self.body("pc_encoder.body.", h, g, 0)
        h = self.bnrelu("pc_encoder.final_bnrelu.", h)
        scene = g.point_scene[keep]
        pooled = h.new_zeros(num_scenes, h.shape[1]).index_add(0, scene,
                                                               h[pv])
        n = torch.bincount(scene, minlength=num_scenes).clamp(min=1)
        return pooled / n[:, None].to(h.dtype)

    def head(self, pooled: torch.Tensor) -> torch.Tensor:
        return pooled @ self.p["linear.weight"].t() + self.p["linear.bias"]


# --- the text tower -------------------------------------------------------

class _Bf16Weight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


class _Bf16Activation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


class TextTower:
    """The text tower and ``text_linear`` over a dict of leaves."""

    def __init__(self, tm: dict, params: Dict[str, torch.Tensor],
                 precision: str = "float32"):
        if precision not in ("float32", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.bf16 = precision == "bf16"
        self.layers, self.width = tm["layers"], tm["width"]
        self.heads = max(1, self.width // 64)
        self.p = params

    def _w(self, name):
        w = self.p[name]
        return _Bf16Weight.apply(w) if self.bf16 else w

    def _a(self, t):
        return _Bf16Activation.apply(t) if self.bf16 else t

    def _dense(self, name, x):
        return self._a(x @ self._w(name + "weight").t()
                       + self._w(name + "bias"))

    def _ln(self, name, x):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + LN_EPS)
        return self._a(y * self._w(name + "weight") + self._w(name + "bias"))

    def _attention(self, name, x):
        r, length, width = x.shape
        h, d = self.heads, width // self.heads
        q = self._dense(name + "query.", x).view(r, length, h, d) / d ** 0.5
        k = self._dense(name + "key.", x).view(r, length, h, d)
        v = self._dense(name + "value.", x).view(r, length, h, d)
        s = torch.einsum("rqhd,rkhd->rhqk", q, k)
        causal = torch.ones(length, length, dtype=torch.bool,
                            device=x.device).tril()
        s = s.masked_fill(~causal, torch.finfo(s.dtype).min)
        w = self._a(torch.softmax(s, dim=-1))
        o = self._a(torch.einsum("rhqk,rkhd->rqhd", w, v))
        return self._dense(name + "out.", o.reshape(r, length, width))

    def features(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, T, L) token ids -> (B, T, out width) text features."""
        b, t, length = tokens.shape
        rows = tokens.reshape(-1, length).long()
        pre = "text_encoder."
        x = self._a(self._w(pre + "token_embedding.weight")[rows]
                    + self._w(pre + "positional_embedding")[:length])
        for i in range(self.layers):
            p = f"{pre}resblock_{i}."
            x = self._a(x + self._attention(p + "attn.",
                                            self._ln(p + "ln_1.", x)))
            h = self._dense(p + "c_fc.", self._ln(p + "ln_2.", x))
            h = self._a(h * torch.sigmoid(1.702 * h))
            x = self._a(x + self._dense(p + "c_proj.", h))
        x = self._ln(pre + "ln_final.", x)
        eot = rows.argmax(dim=-1)
        x = x[torch.arange(x.shape[0], device=x.device), eot]
        return self._dense("text_linear.", x).view(b, t, -1)


def text_contrastive(scene: torch.Tensor, text: torch.Tensor,
                     mask: torch.Tensor, keep_scenes: int = None
                     ) -> torch.Tensor:
    """Mean over the counted slots of ``-log softmax_c <text[b, t],
    scene[c]>`` at ``c = b`` (slot ``t`` of scene ``b`` describes scene
    ``b``).  ``keep_scenes`` counts only the first scenes' slots (the
    half-batch fault); every scene stays in the softmax."""
    logp = F.log_softmax(torch.einsum("btm,cm->btc", text, scene), dim=-1)
    own = torch.arange(text.shape[0], device=text.device)
    nll = -logp[own, :, own]
    keep = mask.to(nll.dtype)
    if keep_scenes is not None:
        keep = keep.clone()
        keep[keep_scenes:] = 0
    return (nll * keep).sum() / keep.sum().clamp(min=1.0)

