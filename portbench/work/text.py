"""The frozen yardstick of a text-supervised training step's work: the
FCN's convolutions and unpool copies, and the text tower's.

The FCN's by :mod:`portbench.work.count`'s rules over the same live
entries: its submanifold, stem and strided convs from the text
reference's parameters (:func:`portbench.reference.text_model.param_spec`),
and at each level but the last an unpool of the level below's output
(``sum(planes[l + 1:])`` wide) and the join that concatenates it with
the level's own (``planes[l]``) into ``sum(planes[l:])`` columns, both
copies: bytes only, read and written once, forward and backward.

The text tower's from the rows it computes (every (scene, slot) row of
the batch at the context length ``L``), in f32, per pass as
``count.py`` counts a conv's:

- each dense layer (q, k, v, out, ``c_fc``, ``c_proj``, ``text_linear``)
  of ``M`` rows from ``K`` to ``N``: ``2 M K N`` FLOPs in the forward,
  the input's gradient and the weight's gradient each; bytes the input,
  the output and the weight once a pass;
- attention over the causal pairs, ``L (L + 1) / 2`` a row and head: the
  scores and the weighted sum of values, each ``2 pairs head_dim``
  FLOPs a pass, forward and twice backward; bytes q, k, v, the output
  and the probabilities once a pass;
- the elementwise work (embedding gather, LayerNorms, softmax,
  QuickGELU, residual sums): bytes only, each input and output once in
  the forward and twice in the backward (the gradient in, the saved
  input, the gradient out).

``text_linear`` reads one row a (scene, slot), the EOT feature.
"""

from __future__ import annotations

from typing import Dict, List

from portbench.reference.text_model import fcn_planes, param_spec
from portbench.work.count import (HBM_BYTES_PER_S, PEAK_FLOPS, Counts, Op,
                                  Work, op_work)

F32 = 4


def fcn_ops(cfg: dict) -> List[Op]:
    """The FCN's convolutions of the configured model."""
    ops = []
    for name, leaf in param_spec(cfg).items():
        if not (name.startswith("pc_encoder.") and name.endswith("kernel")):
            continue
        kind = ("stem" if ".stem." in name else
                "down" if ".down_conv." in name else "subm")
        ops.append(Op(name, kind, name.count("inner."), leaf.shape[1],
                      leaf.shape[2], leaf.shape[0]))
    return ops


def _bytes(nbytes: float) -> Work:
    return Work(0.0, nbytes, nbytes / HBM_BYTES_PER_S)


def fcn_work(cfg: dict, c: Counts, dtype: str) -> Dict[str, Work]:
    """``{"conv": ..., "unpool": ...}`` of one step over ``c``: the
    convolutions, and the unpools with their joins."""
    out = {"conv": Work(), "unpool": Work()}
    for op in fcn_ops(cfg):
        out["conv"].add(op_work(op, c, dtype))
    planes = fcn_planes(cfg["pointcloud_model"])
    e = 2 if dtype in ("bfloat16", "float16") else F32
    for lvl in range(len(planes) - 1):
        inner = sum(planes[lvl + 1:])
        out["unpool"].add(op_work(Op(f"unpool{lvl}", "unpool", lvl, inner,
                                     inner, 1), c, dtype))
        join = c.voxels[lvl] * (planes[lvl] + inner) * e * 2
        out["unpool"].add(_bytes(2 * join))
    return out


def _dense(m: float, k: int, n: int) -> Work:
    flops = 3 * 2.0 * m * k * n
    nbytes = 3 * (m * k + m * n + k * n) * F32
    return Work(flops, nbytes, 0.0)


def tower_work(tm: dict, rows: int, embed: int) -> Work:
    """The least work of one training step of the text tower and
    ``text_linear`` over ``rows`` token rows."""
    d, length, layers = tm["width"], tm["context_length"], tm["layers"]
    heads = max(1, d // 64)
    m = rows * length
    act = m * d * F32                   # one (rows, L, width) tensor
    pairs = rows * heads * length * (length + 1) / 2
    w = Work()
    for _ in range(layers):
        for k, n in ((d, d),) * 4 + ((d, 4 * d), (4 * d, d)):
            w.add(_dense(m, k, n))
        w.add(Work(3 * 2 * 2.0 * pairs * (d // heads),
                   3 * (4 * act + pairs * F32), 0.0))
        # two LayerNorms, the softmax, QuickGELU, two residual sums
        elementwise = 2 * 2 * act + 2 * pairs * F32 + 2 * 4 * act \
            + 2 * 3 * act
        w.add(Work(0.0, 3 * elementwise, 0.0))
    w.add(Work(0.0, 3 * (3 * act + 2 * act), 0.0))  # embedding, ln_final
    w.add(_dense(rows, d, embed))
    w.least_s = max(w.flops / PEAK_FLOPS["float32"],
                    w.bytes / HBM_BYTES_PER_S)
    return w
