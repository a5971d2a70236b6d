"""How far the bench training step's gradients through the kernels stand
from the same step through the plain versions, on one card.

    python3 -m tdwss_torch.tools.step_grads [--dtype f32|bf16] [--seeds 4]
                                            [--out FILE] [--device cuda]

Run from the repository root (it reuses ``chip_smoke.py``'s bench
configuration and its switch to the plain versions).  For each seed
``s`` (dataset seed ``7 + s``, collate rng and weights seeded ``s``), one
step's gradients in the chosen compute dtype are taken through the
kernels, again through the kernels (the two must be bit-identical: the
kernels' dW partials and the spill kernels' sums add in a fixed order,
with no switch of PyTorch's), and through the plain versions; per
parameter tensor it reports ``||g_kern - g_plain|| / ||g_plain||``, the
largest and the median.

In f32, for seed 0 it also shows where the difference grows: for every
batch norm, its valid rows, the share of its ReLU's on/off decisions
that differ between the two runs, the relative difference of the
cotangent at its output, and the cancellation of its weight gradient,
``sum_v |dy * xhat| / |sum_v dy * xhat|`` per channel; and it repeats
seed 0's comparison with ``vox_feats`` rounded to bf16 (the batch a
bf16 configuration slims).  In either dtype it holds three deliberately
faulted kernel runs against seed 0's plain run, to see what a whole-step
limit catches:

- ``dw_tap0``: K2's, K3's and K6's dW lose tap 0;
- ``dfeats_tile0``: K2's and K6's dfeats lose their first row tile;
- ``bf16_k2``: K2 reads its operands rounded to bf16.

The faults wrap the kernel entry points for that run only; the code
itself is unchanged.  Prints a log and, as its last line, one JSON
object with every number; ``--out`` writes that object to a file too.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _ratios(ga, gb):
    out = {}
    for n in ga:
        ref = torch.linalg.vector_norm(gb[n]).item()
        diff = torch.linalg.vector_norm(ga[n] - gb[n]).item()
        out[n] = diff / ref if ref > 0 else (0.0 if diff == 0 else math.inf)
    return out


def _summary(rs):
    ordered = sorted(rs.items(), key=lambda kv: -kv[1])
    vals = sorted(rs.values())
    return dict(largest=ordered[0][1], largest_tensor=ordered[0][0],
                next=[[n, r] for n, r in ordered[1:4]],
                median=vals[len(vals) // 2])


@contextlib.contextmanager
def _bn_probe(model, keep):
    """Record, per batch norm of ``model``, the cotangent at its output
    (valid rows, f32) and the cancellation of its weight gradient."""
    from tdwss_torch.models.layers import MaskedBatchNorm

    handles = []
    for name, mod in model.named_modules():
        if not isinstance(mod, MaskedBatchNorm):
            continue

        def fwd(mod, args, out, name=name):
            valid = args[1]
            keep[name] = dict(on=out.detach()[valid] > 0,
                              rows=int(valid.sum()))

            def on_grad(g):
                dy = g.float()[valid]
                xh = out.detach().float()[valid] - mod.bias.detach()
                terms = dy * xh
                kappa = (terms.abs().sum(0)
                         / terms.sum(0).abs().clamp_min(1e-30))
                keep[name].update(dy=dy, kappa=kappa)

            out.register_hook(on_grad)

        handles.append(mod.register_forward_hook(fwd))
    try:
        yield keep
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def _fault(kind):
    """Wrap the kernel entry points of ``tdwss_torch.ops.sparse_conv``
    with one deliberate fault."""
    from tdwss_torch.ops import sparse_conv as sc

    saved = {n: getattr(sc, n) for n in ("windowed_bwd_gather",
                                         "windowed_dw_sub",
                                         "windowed_bwd_sub")}
    k2, k3 = saved["windowed_bwd_gather"], saved["windowed_dw_sub"]
    k6 = saved["windowed_bwd_sub"]

    def k2_fault(dout, feats, starts, soff, rb_local_t, wt, *a, **kw):
        if kind == "bf16_k2":
            def r(t):
                return t.to(torch.bfloat16).to(t.dtype)
            dout, feats, wt = r(dout), r(feats), r(wt)
        dx, dw = k2(dout, feats, starts, soff, rb_local_t, wt, *a, **kw)
        if kind == "dw_tap0":
            dw = dw.clone()
            dw[0] = 0
        if kind == "dfeats_tile0" and dx is not None:
            dx = dx.clone()
            dx[:kw["tile"]] = 0
        return dx, dw

    def k3_fault(*a, **kw):
        dw = k3(*a, **kw)
        if kind == "dw_tap0":
            dw = dw.clone()
            dw[0] = 0
        return dw

    def k6_fault(*a, **kw):
        dx, dw = k6(*a, **kw)
        if kind == "dw_tap0":
            dw = dw.clone()
            dw[0] = 0
        if kind == "dfeats_tile0" and dx is not None:
            dx = dx.clone()
            dx[:kw["tile"]] = 0
        return dx, dw

    sc.windowed_bwd_gather, sc.windowed_dw_sub = k2_fault, k3_fault
    sc.windowed_bwd_sub = k6_fault
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(sc, n, fn)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                    help="the step's compute dtype")
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cpu runs the plain versions in place of the "
                         "kernels (a rehearsal of the script)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("step_grads: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from tdwss_torch.data.collate import train_collate
    from tdwss_torch.data.plans import attach_host_plans, slim_batch_for_train
    from tdwss_torch.data.synthetic import make_dataset
    from tdwss_torch.engine.steps import compute_loss
    from tdwss_torch.models.meta_arch import build_model
    from tdwss_torch.ops import windowed as W
    from tdwss_torch.ops.host_plan import reset_sticky_plans

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        t0 = time.perf_counter()
        for part in W.SOURCES:
            W.build(part)
        cs.log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    f32 = args.dtype == "f32"
    cfg = cs.bench_config()
    cfg.engine.compute_dtype = "float32" if f32 else "bfloat16"

    def loss_and_grads(model, batch, ctx=contextlib.nullcontext()):
        model.zero_grad(set_to_none=True)
        with ctx:
            loss, _ = compute_loss(cfg, model, batch)
            loss.backward()
        if device.type == "cuda":
            torch.cuda.synchronize()
        return float(loss.detach()), {n: p.grad.detach().float().clone()
                                      for n, p in model.named_parameters()}

    cfg16 = copy.deepcopy(cfg)
    cfg16.engine.compute_dtype = "bfloat16"
    result = dict(dtype=args.dtype, seeds=[], layers=[], faults={})
    for seed in range(args.seeds):
        scenes = make_dataset(cs.NUM_SCENES, num_points=cs.POINTS_PER_SCENE,
                              seed=7 + seed, with_text=False)
        reset_sticky_plans()
        planned = attach_host_plans(train_collate(
            scenes, cfg, np.random.default_rng(seed)), cfg)
        batch = slim_batch_for_train(planned, cfg).to(device)
        model = build_model(cfg, seed=seed, device=device)
        model.train()
        probe_k, probe_p = {}, {}
        probe = seed == 0 and f32
        with _bn_probe(model, probe_k) if probe else contextlib.nullcontext():
            lk, gk = loss_and_grads(model, batch)
        _, gk2 = loss_and_grads(model, batch)
        with _bn_probe(model, probe_p) if probe else contextlib.nullcontext():
            lp, gp = loss_and_grads(model, batch, cs.plain_versions())
        rs = _ratios(gk, gp)
        same = all(torch.equal(gk[n], gk2[n]) for n in gk)
        row = dict(seed=seed, loss_kern=lk, loss_plain=lp,
                   reproducible=same, **_summary(rs))
        result["seeds"].append(row)
        cs.log(f"seed {seed}: loss {lk:.8f} vs {lp:.8f}; kernels twice "
               f"bit-identical: {same}; ratio largest {row['largest']:.4g} "
               f"({row['largest_tensor']}), median {row['median']:.4g}; "
               f"next {row['next']}")
        if probe:
            for name in probe_p:
                dk, dp = probe_k[name]["dy"], probe_p[name]["dy"]
                rel = (torch.linalg.vector_norm(dk - dp)
                       / torch.linalg.vector_norm(dp).clamp_min(1e-30)).item()
                kap = probe_p[name]["kappa"]
                wname = name + ".weight"
                flips = (probe_k[name]["on"] != probe_p[name]["on"]
                         ).float().mean().item()
                result["layers"].append(dict(
                    bn=name, rows=probe_p[name]["rows"], relu_flips=flips,
                    dy_rel=rel,
                    kappa_median=kap.median().item(),
                    kappa_max=kap.max().item(),
                    weight_ratio=rs.get(wname, float("nan")),
                    bias_ratio=rs.get(name + ".bias", float("nan"))))
            probe_k.clear()
            probe_p.clear()
            for lay in sorted(result["layers"],
                              key=lambda d: -d["weight_ratio"])[:12]:
                cs.log(f"  {lay['bn']}: valid rows {lay['rows']}, ReLU "
                       f"decisions flipped {lay['relu_flips']:.3g}, "
                       f"cotangent rel diff {lay['dy_rel']:.3g}, "
                       f"weight-gradient cancellation median {lay['kappa_median']:.3g} max "
                       f"{lay['kappa_max']:.3g}; weight ratio "
                       f"{lay['weight_ratio']:.3g}, bias ratio "
                       f"{lay['bias_ratio']:.3g}")
            b16 = slim_batch_for_train(planned, cfg16).to(device)
            _, g16 = loss_and_grads(model, b16)
            _, g16p = loss_and_grads(model, b16, cs.plain_versions())
            row = _summary(_ratios(g16, g16p))
            result["seed0_bf16_inputs"] = row
            cs.log(f"seed 0 with bf16 vox_feats: ratio largest "
                   f"{row['largest']:.4g} ({row['largest_tensor']}), median "
                   f"{row['median']:.4g}")
            del b16, g16, g16p
        if seed == 0:
            for kind in ("dw_tap0", "dfeats_tile0", "bf16_k2"):
                with _fault(kind):
                    _, gf = loss_and_grads(model, batch)
                fr = _ratios(gf, gp)
                over = sorted(fr.values())
                row = dict(**_summary(fr), tensors=len(fr),
                           over_0_05=sum(r > 0.05 for r in over),
                           over_0_1=sum(r > 0.1 for r in over))
                result["faults"][kind] = row
                cs.log(f"fault {kind}: largest {row['largest']:.4g} "
                       f"({row['largest_tensor']}), median "
                       f"{row['median']:.4g}; tensors over 0.05: "
                       f"{row['over_0_05']}, over 0.1: {row['over_0_1']} "
                       f"of {row['tensors']}")
        del model, batch, gk, gk2, gp
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
