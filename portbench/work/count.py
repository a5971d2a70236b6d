"""The frozen yardstick of a training step's convolution work.

From a batch's points (worked out by :mod:`portbench.reference.collate`,
voxelized by :mod:`portbench.reference.voxels`), the live entries each
convolution needs, whatever implements it:

- a 3x3x3 submanifold conv: its level's live (output voxel, tap) pairs;
- a stride-2 conv and a deconv: the live children of the finer level
  (one tap each);
- a 1x1 projection: the level's voxels;
- an unpool: a copy, so bytes only.

Per pass (forward; in training the input's gradient, except the stem's,
whose input needs none; and the weight's gradient): FLOPs are
``2 * entries * Cin * Cout``; bytes count each live input row, output
row and weight once, at the compute dtype's width, and the weight's
gradient in f32.  A pass's least time on an H100 is the larger of its
FLOPs over the dense peak and its bytes over HBM's bandwidth.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import torch

from portbench.reference.model import encoder, param_spec
from portbench.reference.voxels import build_levels, subm_pairs

# NVIDIA H100 SXM data sheet, dense: bf16 / fp16 on the tensor cores,
# f32 on the CUDA cores; HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
_WIDTH = {"bfloat16": 2, "float16": 2, "float32": 4}


@dataclass
class Op:
    """One convolution (or unpool) of the step: ``kind`` subm, stem,
    down, up, nin or unpool; ``level`` the finer level it touches."""

    name: str
    kind: str
    level: int
    cin: int
    cout: int
    taps: int


def step_ops(pc: dict) -> List[Op]:
    """The convolutions and unpools of the configured model's step."""
    planes, kind = encoder(pc)
    ops = []
    for name, leaf in param_spec(pc).items():
        if not name.endswith("kernel"):
            continue
        level = name.count("inner.")
        if ".stem." in name:
            k = "stem"
        elif ".down_conv." in name:
            k = "down"
        elif ".up_deconv." in name:
            k = "up"
        elif ".nin." in name:
            k = "nin"
        else:
            k = "subm"
        shape = leaf.shape if len(leaf.shape) == 3 else (1,) + leaf.shape
        ops.append(Op(name, k, level, shape[1], shape[2], shape[0]))
    if kind == "uppool":
        for lvl in range(len(planes) - 1):
            ops.append(Op(f"unpool{lvl}", "unpool", lvl, planes[-1],
                          planes[-1], 1))
    return ops


@dataclass
class Counts:
    """Live voxels, submanifold pairs and children per level."""

    voxels: List[int]
    pairs: List[int]
    children: List[int]


def live_counts(coords: torch.Tensor, caps: Sequence[int]) -> Counts:
    """The live entries of a batch whose points have ``coords`` (N, 4)."""
    levels, downs, _ = build_levels(coords, caps)
    return Counts(
        voxels=[lv.size for lv in levels],
        pairs=[sum(int(o.numel()) for o, _ in subm_pairs(lv))
               for lv in levels],
        children=[int((d.parent >= 0).sum()) for d in downs])


@dataclass
class Work:
    flops: float = 0.0
    bytes: float = 0.0
    least_s: float = 0.0

    def add(self, other: "Work") -> None:
        self.flops += other.flops
        self.bytes += other.bytes
        self.least_s += other.least_s


def _pass(flops: float, nbytes: float, dtype: str) -> Work:
    return Work(flops, nbytes, max(flops / PEAK_FLOPS[dtype],
                                   nbytes / HBM_BYTES_PER_S))


def op_work(op: Op, c: Counts, dtype: str, train: bool = True) -> Work:
    """The least work of one op in a step over ``c``."""
    e = _WIDTH[dtype]
    lv = op.level
    if op.kind in ("subm", "stem"):
        entries, v_in, v_out = c.pairs[lv], c.voxels[lv], c.voxels[lv]
    elif op.kind == "nin":
        entries, v_in, v_out = c.voxels[lv], c.voxels[lv], c.voxels[lv]
    elif op.kind == "down":
        entries, v_in, v_out = c.children[lv], c.voxels[lv], c.voxels[lv + 1]
    elif op.kind in ("up", "unpool"):
        entries, v_in, v_out = c.children[lv], c.voxels[lv + 1], c.voxels[lv]
    else:
        raise ValueError(op.kind)
    x, y = v_in * op.cin * e, v_out * op.cout * e
    if op.kind == "unpool":
        out = Work()
        out.add(_pass(0.0, x + y, dtype))
        if train:
            out.add(_pass(0.0, x + y, dtype))
        return out
    f = 2.0 * entries * op.cin * op.cout
    w = op.taps * op.cin * op.cout
    out = Work()
    out.add(_pass(f, x + y + w * e, dtype))
    if train:
        if op.kind != "stem":
            out.add(_pass(f, y + x + w * e, dtype))
        out.add(_pass(f, x + y + w * 4, dtype))
    return out


def step_work(ops: Sequence[Op], c: Counts, dtype: str
              ) -> Dict[str, Work]:
    """``{"conv": ..., "unpool": ...}``: the least work of a training
    step's convolutions (with the 1x1 projections) and of its unpools."""
    out = {"conv": Work(), "unpool": Work()}
    for op in ops:
        out["unpool" if op.kind == "unpool" else "conv"].add(
            op_work(op, c, dtype))
    return out
