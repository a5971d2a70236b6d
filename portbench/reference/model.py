"""The plain reference of the benchmark's models and of their training
step, in PyTorch with autograd and no kernel of the program.

It follows the reference project's networks (SparseConvNet blocks, as
the program names them): a 3x3x3 submanifold stem, then per level
``block_reps`` residual blocks (BN-ReLU, conv, BN-ReLU, conv, plus the
input or its 1x1 projection), a BN-ReLU and a stride-2 conv down to the
next level, and on the way back up either

- the UNet's BN-ReLU, deconv, concatenation with the level's own
  features and ``block_reps`` more blocks, or
- the direct up-pool's copy of each parent's features to its children,
  which replaces the level's own;

then a BN-ReLU, each scene's mean over its points (a point reads its
voxel), a linear head to 20 tags and the multi-label soft-margin loss.
Batch norm normalises with the batch's statistics over the live voxels
(eps 1e-4).  The step is Adam (betas 0.9, 0.999, eps 1e-8).

Parameters are a dict keyed by the dotted paths that name the same
leaves in the program's module tree, so that the benchmark can hand both
sides one set of weights; they are drawn here from the seed.

``precision`` is ``float32`` (the reference: f32 throughout, TF32 off) or
``fp8`` (the control: float8 wherever the program computes in bf16, each
under a per-tensor scale, as fp8 training recipes do: the weights of the
convolutions and projections in e4m3, and every activation the program
keeps in bf16, the stem's input and the output of each convolution,
projection, batch norm with its ReLU and residual sum, in e4m3 with its
gradient in e5m2; batch norm's statistics, its weight and bias, the
scene pooling and the head stay f32, as in the program).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.voxels import (Down, Level, build_levels,
                                        capacities, subm_pairs)

NUM_CLASSES = 20

# the encoders the reference knows: their plane schedules and whether the
# way up is the UNet's (deconv + skip) or the direct up-pool
_ENCODERS = {
    "SparseConvUNet": (lambda pc: tuple((i + 1) * pc["m"] for i in range(7)),
                       "unet"),
    "SparseConvFCNetDirectUpPool": (
        lambda pc: (pc["m"],) + tuple(pc.get("n_planes") or (64, 128, 192,
                                                             256)),
        "uppool"),
    "SparseConvFCNetDirectUpPoolLight": (
        lambda pc: (pc["m"],) + tuple(pc.get("n_planes") or (32, 64, 96,
                                                             128)),
        "uppool"),
}


def encoder(pc: dict) -> Tuple[Tuple[int, ...], str]:
    """(planes, kind) of the configured encoder."""
    name = pc["name"]
    if name not in _ENCODERS:
        raise KeyError(f"the reference has no encoder {name!r}")
    planes, kind = _ENCODERS[name]
    return planes(pc), kind


# --- parameters -----------------------------------------------------------

@dataclass
class Leaf:
    """One parameter: its shape and how it is drawn (``he``: normal with
    std sqrt(2 / fan_in); ``head``: normal with std sqrt(1 / fan_in);
    ``ones``; ``zeros``)."""

    shape: Tuple[int, ...]
    init: str
    fan_in: int = 0


def param_spec(pc: dict) -> Dict[str, Leaf]:
    """Every parameter of the configured model, by its dotted path."""
    planes, kind = encoder(pc)
    reps, residual = pc["block_reps"], pc["residual_blocks"]
    spec: Dict[str, Leaf] = {}

    def bn(p, c):
        spec[p + "bn.weight"] = Leaf((c,), "ones")
        spec[p + "bn.bias"] = Leaf((c,), "zeros")

    def conv(p, k, a, b):
        spec[p + "kernel"] = Leaf((k, a, b), "he", k * a)

    def block(p, a, b):
        if not residual:
            bn(p + "bnrelu.", a)
            conv(p + "conv.", 27, a, b)
            return
        if a != b:
            spec[p + "nin.kernel"] = Leaf((a, b), "he", a)
        bn(p + "bnrelu1.", a)
        conv(p + "conv1.", 27, a, b)
        bn(p + "bnrelu2.", b)
        conv(p + "conv2.", 27, b, b)

    def body(p, pl):
        for i in range(reps):
            block(f"{p}enc{i}.", pl[0], pl[0])
        if len(pl) == 1:
            return
        bn(p + "down_bnrelu.", pl[0])
        conv(p + "down_conv.", 8, pl[0], pl[1])
        body(p + "inner.", pl[1:])
        if kind == "unet":
            bn(p + "up_bnrelu.", pl[1])
            conv(p + "up_deconv.", 8, pl[1], pl[0])
            for i in range(reps):
                block(f"{p}dec{i}.", 2 * pl[0] if i == 0 else pl[0], pl[0])

    conv("pc_encoder.stem.", 27, 3, planes[0])
    body("pc_encoder.body.", planes)
    width = planes[0] if kind == "unet" else planes[-1]
    bn("pc_encoder.final_bnrelu.", width)
    spec["linear.weight"] = Leaf((NUM_CLASSES, width), "head", width)
    spec["linear.bias"] = Leaf((NUM_CLASSES,), "zeros")
    return spec


def draw_weights(spec: Dict[str, Leaf], seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """The model's f32 weights from ``seed``, made on ``device`` in one
    draw (a ``torch.Generator`` there), in the order of ``spec``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    normal = [n for n, leaf in spec.items() if leaf.init in ("he", "head")]
    sizes = [int(torch.Size(spec[n].shape).numel()) for n in normal]
    draw = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for n, size in zip(normal, sizes):
        leaf = spec[n]
        gain = 2.0 if leaf.init == "he" else 1.0
        std = (gain / leaf.fan_in) ** 0.5
        out[n] = draw[at:at + size].view(leaf.shape) * std
        at += size
    for n, leaf in spec.items():
        if leaf.init == "ones":
            out[n] = torch.ones(leaf.shape, device=device)
        elif leaf.init == "zeros":
            out[n] = torch.zeros(leaf.shape, device=device)
    return {n: out[n] for n in spec}


# --- the forward pass -----------------------------------------------------

def _fp8(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` (a float8) under a per-tensor scale that
    puts its largest magnitude on the format's largest value."""
    top = torch.finfo(dtype).max
    scale = t.abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8Weight(torch.autograd.Function):
    """Forward: round to e4m3.  Backward: the gradient passes to the f32
    weight."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Activation(torch.autograd.Function):
    """Forward: round to e4m3.  Backward: round the gradient to e5m2."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


def fp8_weight(t: torch.Tensor) -> torch.Tensor:
    return _Fp8Weight.apply(t)


def fp8_activation(t: torch.Tensor) -> torch.Tensor:
    return _Fp8Activation.apply(t)


@dataclass
class Geometry:
    """The levels of one batch: voxels, rulebooks and maps."""

    levels: List[Level]
    subm: List[List[Tuple[torch.Tensor, torch.Tensor]]]
    downs: List[Down]
    point_voxel: torch.Tensor
    point_scene: torch.Tensor


def geometry(coords: torch.Tensor, caps: Sequence[int]) -> Geometry:
    levels, downs, pv = build_levels(coords, caps)
    return Geometry(levels=levels, subm=[subm_pairs(lv) for lv in levels],
                    downs=downs, point_voxel=pv, point_scene=coords[:, 3])


def plan_capacities(cfg: dict) -> List[int]:
    """The levels' capacities of a configuration (its ``engine`` and
    ``pointcloud_model`` sections)."""
    eng, pc = cfg["engine"], cfg["pointcloud_model"]
    planes, _ = encoder(pc)
    base = eng.get("max_voxels") or eng["max_points"]
    return capacities(base, len(planes), eng.get("level_capacity_shrink", 2),
                      eng.get("min_level_capacity", 2048),
                      eng.get("level_capacity_schedule") or ())


class Net:
    """The forward pass over one batch's :class:`Geometry`."""

    def __init__(self, pc: dict, params: Dict[str, torch.Tensor],
                 precision: str = "float32"):
        self.planes, self.kind = encoder(pc)
        self.reps = pc["block_reps"]
        self.residual = pc["residual_blocks"]
        self.p = params
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def _w(self, t):
        return fp8_weight(t) if self.fp8 else t

    def _a(self, t):
        return fp8_activation(t) if self.fp8 else t

    def bnrelu(self, name, x):
        mean = x.mean(0)
        var = ((x - mean) ** 2).mean(0)
        y = (x - mean) * torch.rsqrt(var + 1e-4) * self.p[name + "bn.weight"]
        return self._a(torch.relu(y + self.p[name + "bn.bias"]))

    def subm(self, name, x, pairs):
        w = self._w(self.p[name + "kernel"])
        out = x.new_zeros(x.shape[0], w.shape[2])
        for k, (o, i) in enumerate(pairs):
            if o.numel():
                out = out.index_add(0, o, x[i] @ w[k])
        return self._a(out)

    def down(self, name, x, d: Down, n_coarse):
        w = self._w(self.p[name + "kernel"])
        out = x.new_zeros(n_coarse, w.shape[2])
        for t in range(w.shape[0]):
            rows = torch.nonzero((d.parent >= 0) & (d.tap == t))[:, 0]
            if rows.numel():
                out = out.index_add(0, d.parent[rows], x[rows] @ w[t])
        return self._a(out)

    def up(self, name, x, d: Down):
        w = self._w(self.p[name + "kernel"])
        out = x.new_zeros(d.parent.shape[0], w.shape[2])
        for t in range(w.shape[0]):
            rows = torch.nonzero((d.parent >= 0) & (d.tap == t))[:, 0]
            if rows.numel():
                out = out.index_add(0, rows, x[d.parent[rows]] @ w[t])
        return self._a(out)

    @staticmethod
    def unpool(x, d: Down):
        rows = torch.nonzero(d.parent >= 0)[:, 0]
        out = x.new_zeros(d.parent.shape[0], x.shape[1])
        return out.index_add(0, rows, x[d.parent[rows]])

    def block(self, name, x, pairs):
        if not self.residual:
            return self.subm(name + "conv.", self.bnrelu(name + "bnrelu.", x),
                             pairs)
        nin = self.p.get(name + "nin.kernel")
        short = x if nin is None else self._a(x @ self._w(nin))
        h = self.subm(name + "conv1.", self.bnrelu(name + "bnrelu1.", x),
                      pairs)
        h = self.subm(name + "conv2.", self.bnrelu(name + "bnrelu2.", h),
                      pairs)
        return self._a(short + h)

    def body(self, name, x, g: Geometry, lvl: int):
        for i in range(self.reps):
            x = self.block(f"{name}enc{i}.", x, g.subm[lvl])
        if lvl + 1 == len(self.planes):
            return x
        d = g.downs[lvl]
        h = self.bnrelu(name + "down_bnrelu.", x)
        h = self.down(name + "down_conv.", h, d, g.levels[lvl + 1].size)
        h = self.body(name + "inner.", h, g, lvl + 1)
        if self.kind == "uppool":
            return self.unpool(h, d)
        h = self.bnrelu(name + "up_bnrelu.", h)
        h = self.up(name + "up_deconv.", h, d)
        x = torch.cat([x, h], dim=1)
        for i in range(self.reps):
            x = self.block(f"{name}dec{i}.", x, g.subm[lvl])
        return x

    def scene_logits(self, g: Geometry, feats: torch.Tensor,
                     num_scenes: int) -> torch.Tensor:
        """(B, 20) logits of the batch whose points carry ``feats``."""
        lv0 = g.levels[0]
        keep = g.point_voxel >= 0
        pv = g.point_voxel[keep]
        vox = feats.new_zeros(lv0.size, feats.shape[1]).index_add(
            0, pv, feats[keep]) / lv0.counts[:, None].to(feats.dtype)
        h = self.subm("pc_encoder.stem.", self._a(vox), g.subm[0])
        h = self.body("pc_encoder.body.", h, g, 0)
        h = self.bnrelu("pc_encoder.final_bnrelu.", h)
        scene = g.point_scene[keep]
        pooled = h.new_zeros(num_scenes, h.shape[1]).index_add(0, scene, h[pv])
        n = torch.bincount(scene, minlength=num_scenes).clamp(min=1)
        pooled = pooled / n[:, None].to(h.dtype)
        return pooled @ self.p["linear.weight"].t() + self.p["linear.bias"]


def soft_margin(logits: torch.Tensor, tags: torch.Tensor) -> torch.Tensor:
    """Mean over scenes of the mean over classes of
    -[y log sigmoid(x) + (1 - y) log sigmoid(-x)]."""
    per = tags * F.logsigmoid(logits) + (1 - tags) * F.logsigmoid(-logits)
    return -per.mean(dim=1).mean()


class Adam:
    """Adam over a dict of leaves (PyTorch's and optax's update)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.p, self.lr, self.b1, self.b2, self.eps = params, lr, *betas, eps
        self.m = {n: torch.zeros_like(v) for n, v in params.items()}
        self.v = {n: torch.zeros_like(v) for n, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for n, g in grads.items():
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[n] / c2).sqrt_().add_(self.eps)
            self.p[n].addcdiv_(self.m[n], denom, value=-self.lr / c1)
