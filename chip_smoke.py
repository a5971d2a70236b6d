"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's two main paths at the bench width (MultiLabel over
SparseConvUNet: m=32, block_reps=2, residual blocks, 7 levels, scale 50,
bf16 compute; 5 synthetic scenes of 150,000 points, ``max_points``
786,432; seeded random weights) and checks them:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: the kernels' two shared libraries (nvcc: forward K1/K4,
   backward K2/K3/K5) and the native host planner (g++), compiled from
   the checkout in parallel, timed;
3. kernels: K1 (windowed_matmul_sub) and K4 (windowed_matmul) at the
   bench plans' level-0 shapes against their plain PyTorch versions on
   the card, with times (CUDA events), the plain versions' times and the
   bound of each on an H100; then, untimed, at the widest decoder conv;
4. backward kernels: K2 (windowed_bwd_gather, both tap orientations),
   K3 (windowed_dw_sub) and K5 (windowed_dw, the same windows in the
   flat form) at the level-0 shape, and K3 at the widest conv of the
   path, against their plain versions in bf16 and in f32, timed as in 3;
5. validation: ``validate`` (2 vote repetitions) with the launch counts
   set to 0 just before and read just after, equal to what the plans
   route to each kernel; the per-point logits of a full forward held
   against the same forward through the plain versions on the card;
6. training: one bench batch through ``train_collate`` ->
   ``attach_host_plans`` -> ``slim_batch_for_train`` (host, timed), then
   3 ``train_step``s (forward with batch norm in train mode, scene
   pooling, Classification loss, backward through the kernels, Adam) with
   the launch counts set to 0 just before and read just after, equal to
   the plans' routing; the loss is finite and every parameter moves; one
   step's loss and gradients through the kernels are held against the
   same step through the plain versions on the card;
7. one JSON line with the numbers of every kernel the main paths
   launched, the card line from ``nvidia-smi``, and the result line.

Any failure raises and the exit code is not 0.  Without CUDA, or without
the rest of the repository beside this file, it exits non-zero and prints
no result.  Imports nothing of JAX or of the JAX package ``tdwss``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()

NUM_SCENES = 5
POINTS_PER_SCENE = 150_000
MAX_POINTS = 786_432
VAL_REPS = 2
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12          # dense bf16 tensor-core peak
# Kernel vs plain version, both bf16 with f32 accumulation and one final
# rounding: the summation order differs, so an output may land one bf16
# rounding step apart — |d| <= 2^-7 * max|plain| (two ulps of the
# largest value).
KERNEL_TOL = 2.0 ** -7
# The same kernels in f32: sums of at most 27 * C products in another
# order, |d| <= 1e-4 * max|plain|.
KERNEL_TOL_F32 = 1e-4
# dW (f32 accumulation, bf16 or f32 inputs) vs its plain version: sums
# over up to ~10^6 rows in another order.  Each kernel block sums its
# chunk of ~1,500 rows in order (rounding ~1,500 * 2^-24 ~ 1e-4 of the
# partial sums' magnitude), the chunks in a fixed order, while the plain
# version sums through cuBLAS; |d| <= 1e-3 * max|plain| leaves a 10x
# margin over that.
DW_TOL = 1e-3
# Full forward through the kernels vs through the plain versions (bf16):
# one-ulp differences at a layer's output propagate through ~60 layers;
# max |d| <= 0.05 * max |plain| and mean |d| <= 0.01 * mean |plain|.
LOGITS_MAX_TOL, LOGITS_MEAN_TOL = 0.05, 0.01
# One training step through the kernels vs the plain versions.
# - Layer by layer (the gate on the kernels): every windowed conv's
#   backward in the step is run again through the plain versions on the
#   same inputs; dfeats within KERNEL_TOL (bf16) or KERNEL_TOL_F32, dW
#   within DW_TOL.
# - The whole step: the loss within 1e-2 relative in bf16 and 1e-5 in
#   f32, and the f32 step's gradients, under PyTorch's deterministic
#   algorithms (the spill adds sorted, not atomic): two runs through the
#   kernels bit for bit, and kernels vs plain within 0.05 per tensor,
#   ||g_kern - g_plain|| <= 0.05 ||g_plain||.  Whole-step gradients are
#   ill-conditioned: the forward's rounding flips a few ReLU decisions
#   at near-zero activations, and as the scene-pooled loss gives every
#   voxel a cotangent of about the same size, one flipped entry moves the
#   cotangent's norm by ~1/sqrt(entries), most at the small deep levels.
#   ``python3 -m tdwss_torch.tools.step_grads`` measured, on an H100
#   80GB HBM3 (700 W), kernels vs plain at 0.0059-0.0088 (largest per
#   tensor, 4 seeds; 0.026 with vox_feats rounded to bf16), and faulted
#   kernels at 0.37 (K2/K3 dW without one tap) and 0.15 (K2 dfeats
#   without one row tile): 0.05 lies between.  A precision fault (K2 on
#   bf16-rounded operands, 0.010) is within the spread; the layer-by-layer
#   check is what catches it.  bf16 whole-step gradients differ by a
#   median ~0.2 between two runs through the kernels (atomic spill
#   adds), so only the bf16 loss is held.
LOSS_RTOL = 1e-2
LOSS_RTOL_F32, GRAD_RTOL_F32 = 1e-5, 0.05
TRAIN_STEPS = 3
STEPS_PER_EPOCH = 100
# The reference's K2 width gate (tdwss/ops/sparse_conv.py:936, :1455)
GATHER_MAX_C = 128


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def bench_config():
    from tdwss_torch.config import (Config, EngineConfig, LossConfig,
                                    PointcloudDataConfig,
                                    PointcloudModelConfig)

    return Config(
        training_name="chip_smoke",
        model_name="MultiLabel",
        label="scene_level",
        pointcloud_data=PointcloudDataConfig(scale=50, batch_size=NUM_SCENES,
                                             val_reps=VAL_REPS),
        pointcloud_model=PointcloudModelConfig(
            name="SparseConvUNet", m=32, full_scale=4096, block_reps=2,
            residual_blocks=True),
        loss=LossConfig(Classification=True),
        engine=EngineConfig(max_points=MAX_POINTS,
                            level_capacity_schedule=[2, 3, 4, 4, 4, 4],
                            min_level_capacity=4096,
                            compute_dtype="bfloat16"),
    )


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``iters`` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_build():
    from tdwss_torch import native
    from tdwss_torch.ops import windowed

    results, errors = {}, []

    def run(name, fn):
        t = time.perf_counter()
        try:
            results[name] = (fn(), time.perf_counter() - t)
        except BaseException as e:          # re-raised below
            errors.append(e)

    jobs = {"forward kernels": lambda: windowed.build("fwd"),
            "backward kernels": lambda: windowed.build("bwd"),
            "planner": native.build}
    threads = [threading.Thread(target=run, args=item)
               for item in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    native.require()
    for name, (path, secs) in results.items():
        log(f"build {name}: {secs:.2f} s -> {os.path.relpath(path, HERE)}")
    for name in ("forward kernels", "backward kernels"):
        with open(results[name][0] + ".log") as f:
            lines = f.read().splitlines()
        for i, ln in enumerate(lines):
            if "registers" in ln:
                fn = lines[i - 1].split("'")[1] if "'" in lines[i - 1] else ""
                log(f"ptxas: {fn[:60]} {ln.strip()}")


def level_case(plans, level, c, cout, device, gen):
    """K1 / K4 arguments at one level's subm conv of the bench plans: the
    sub-form plan as built, and the same windows in the flat form
    (big-window locals, the reference's flat evaluation of a sub plan)."""
    import torch

    win = plans.levels[level].win
    if not win.sub:
        raise RuntimeError(f"level {level} of the bench plans is not sub-form")
    v, k = win.rb_local.shape
    tiles, nwin = win.starts.shape
    tile = v // tiles
    rb = torch.from_numpy(win.rb_local.astype("int32")).to(device)
    starts = torch.from_numpy(win.starts).to(device)
    soff = torch.from_numpy(win.sub_off).to(device)
    g = torch.arange(k, device=device) % nwin
    big = soff.repeat_interleave(win.sub, dim=0)[:, g]
    rb_flat = torch.where(rb == win.subwin, torch.full_like(rb, win.window),
                          rb + big).to(torch.int32)
    x = torch.randn((v, c), generator=gen).to(device, torch.bfloat16)
    w = (torch.randn((k, c, cout), generator=gen) * (2.0 / (k * c)) ** 0.5
         ).to(device, torch.bfloat16)
    dout = torch.randn((v, cout), generator=gen).to(device, torch.bfloat16)
    return dict(x=x, w=w, dout=dout, starts=starts, soff=soff, rb=rb,
                rb_flat=rb_flat, tile=tile, window=win.window, sub=win.sub,
                subwin=win.subwin)


def check_against_plain(name, out, ref, label, tol_rel=KERNEL_TOL):
    """Max |kernel - plain| against ``tol_rel * max|plain|``; raises
    beyond it."""
    import torch

    d = (out.float() - ref.float()).abs()
    scale = ref.float().abs().max().item()
    err = d.max().item()
    tol = tol_rel * scale
    log(f"{name}: {label}: max|d|={err:.6g} (relative "
        f"{err / scale:.3g}; tolerance {tol:.6g} = {tol_rel:.3g} * "
        f"max|plain| {scale:.6g})")
    if not (torch.isfinite(out.float()).all() and err <= tol):
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{err} > {tol}")
    return err


def kernel_row(name, source, replaces, run, plain, work, err):
    """Time ``run`` and ``plain`` (CUDA events) and bound the work."""
    ms = cuda_time_ms(run, iters=20)
    plain_ms = cuda_time_ms(plain, iters=3, warmup=1)
    nbytes, flops = work()
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / BF16_FLOPS_PER_S * 1e3
    bound_ms = max(bound_bytes, bound_ops)
    log(f"{name}: {ms:.4f} ms (median of 20), plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms ({nbytes} B, {flops} flop)")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                library_ms=None)


def phase_kernels(case):
    import torch

    from tdwss_torch.ops import windowed as W

    x, w, st = case["x"], case["w"], case["starts"]
    k1 = dict(
        name=W.K1, source="tdwss_torch/csrc/windowed_fwd.cu",
        replaces="tdwss/ops/pallas_subm.py:698",
        run=lambda: W.windowed_matmul_sub(
            x, st.reshape(-1), case["soff"].reshape(-1), case["rb"].t(), w,
            case["window"], case["tile"], case["sub"], case["subwin"]),
        plain=lambda: W.windowed_matmul_sub_plain(
            x, st.reshape(-1), case["soff"].reshape(-1), case["rb"].t(), w,
            case["window"], case["tile"], case["sub"], case["subwin"]),
        work=lambda: W.work(x, st.reshape(-1), case["soff"].reshape(-1),
                            case["rb"].t(), w, case["tile"], case["sub"],
                            case["subwin"]))
    k4 = dict(
        name=W.K4, source="tdwss_torch/csrc/windowed_fwd.cu",
        replaces="tdwss/ops/pallas_subm.py:341",
        run=lambda: W.windowed_matmul(x, st.reshape(-1),
                                      case["rb_flat"].t(), w,
                                      case["window"], case["tile"]),
        plain=lambda: W.windowed_matmul_plain(x, st.reshape(-1),
                                              case["rb_flat"].t(), w,
                                              case["window"], case["tile"]),
        work=lambda: W.work(x, st.reshape(-1), None, case["rb_flat"].t(), w,
                            case["tile"], 0, case["window"]))
    rows = []
    outs = {}
    for kern in (k1, k4):
        out = kern["run"]()
        ref = kern["plain"]()
        torch.cuda.synchronize()
        err = check_against_plain(
            kern["name"], out, ref, f"V={x.shape[0]} C={x.shape[1]} "
            f"Cout={w.shape[2]} K={w.shape[0]} bf16")
        outs[kern["name"]] = out
        rows.append(kernel_row(kern["name"], kern["source"],
                               kern["replaces"], kern["run"], kern["plain"],
                               kern["work"], err))
    same = (outs[W.K1].float() - outs[W.K4].float()).abs().max().item()
    log(f"K1 (sub form) vs K4 (flat form) on the same level-0 windows: "
        f"max|d| = {same}")
    if same != 0.0:
        raise AssertionError("K1 and K4 disagree on the same windows")
    return rows


def phase_wide(wide):
    """Both kernels, untimed, at the widest decoder conv of the path
    (several channel chunks and output-column blocks per row block)."""
    import torch

    from tdwss_torch.ops import windowed as W

    x, w, st = wide["x"], wide["w"], wide["starts"].reshape(-1)
    label = (f"V={x.shape[0]} C={x.shape[1]} Cout={w.shape[2]} "
             f"K={w.shape[0]} bf16")
    args = (wide["window"], wide["tile"], wide["sub"], wide["subwin"])
    soff = wide["soff"].reshape(-1)
    out = W.windowed_matmul_sub(x, st, soff, wide["rb"].t(), w, *args)
    ref = W.windowed_matmul_sub_plain(x, st, soff, wide["rb"].t(), w, *args)
    torch.cuda.synchronize()
    check_against_plain(W.K1, out, ref, label)
    out4 = W.windowed_matmul(x, st, wide["rb_flat"].t(), w, wide["window"],
                             wide["tile"])
    ref4 = W.windowed_matmul_plain(x, st, wide["rb_flat"].t(), w,
                                   wide["window"], wide["tile"])
    torch.cuda.synchronize()
    check_against_plain(W.K4, out4, ref4, label)


def phase_bwd_kernels(case, wide):
    """K2 (both tap orientations), K3 and K5 at the level-0 shape and K3
    at the widest conv of the path, against their plain versions in bf16
    and f32; timed rows for K2 (flipped taps, the subm route), K3 and K5
    at level 0, and K3's time at the widest shape."""
    import torch

    from tdwss_torch.ops import windowed as W

    src = "tdwss_torch/csrc/windowed_bwd.cu"

    def args(cs, dtype):
        st = cs["starts"].reshape(-1)
        soff = cs["soff"].reshape(-1)
        x, dout = cs["x"].to(dtype), cs["dout"].to(dtype)
        # K2's operands: the cotangent (width Cout) is its gather source,
        # the primal rows (width C) its dense side, wt[a] = W[26-a]^T
        wt = cs["w"].to(dtype).flip(0).transpose(1, 2).contiguous()
        geo = (cs["window"], cs["tile"], cs["sub"], cs["subwin"])
        flat = (cs["window"], cs["tile"])
        return dict(
            k2=lambda fn, flip: fn(dout, x, st, soff, cs["rb"].t(), wt, *geo,
                                   flip_taps=flip),
            k3=lambda fn: fn(x, st, soff, cs["rb"].t(), dout, *geo),
            k5=lambda fn: fn(x, st, cs["rb_flat"].t(), dout, *flat),
            work_k2=lambda: W.work_bwd_gather(dout, x, st, soff,
                                              cs["rb"].t(), wt, cs["tile"],
                                              cs["sub"], cs["subwin"]),
            work_k3=lambda: W.work_dw(x, st, soff, cs["rb"].t(), dout,
                                      cs["tile"], cs["sub"], cs["subwin"]),
            work_k5=lambda: W.work_dw(x, st, None, cs["rb_flat"].t(), dout,
                                      cs["tile"], 0, cs["window"]),
            label=(f"V={x.shape[0]} C={x.shape[1]} Cout={dout.shape[1]} "
                   f"K={cs['rb'].shape[1]} {str(dtype)[6:]}"))

    errs = {}
    for dtype, tol in ((torch.bfloat16, KERNEL_TOL),
                       (torch.float32, KERNEL_TOL_F32)):
        a = args(case, dtype)
        for flip in (True, False):
            (dx, dw), (pdx, pdw) = (a["k2"](W.windowed_bwd_gather, flip),
                                    a["k2"](W.windowed_bwd_gather_plain,
                                            flip))
            torch.cuda.synchronize()
            lab = f"{a['label']} flip_taps={flip}"
            e = check_against_plain(W.K2, dx, pdx, f"dfeats {lab}", tol)
            e = max(e, check_against_plain(W.K2, dw, pdw, f"dW {lab}",
                                           DW_TOL))
            if dtype == torch.bfloat16 and flip:
                errs[W.K2] = e
        for name, key, fn, plain in (
                (W.K3, "k3", W.windowed_dw_sub, W.windowed_dw_sub_plain),
                (W.K5, "k5", W.windowed_dw, W.windowed_dw_plain)):
            out, ref = a[key](fn), a[key](plain)
            torch.cuda.synchronize()
            e = check_against_plain(name, out, ref, f"dW {a['label']}",
                                    DW_TOL)
            if dtype == torch.bfloat16:
                errs[name] = e
        w = args(wide, dtype)
        out, ref = w["k3"](W.windowed_dw_sub), w["k3"](W.windowed_dw_sub_plain)
        torch.cuda.synchronize()
        check_against_plain(W.K3, out, ref, f"dW {w['label']}", DW_TOL)
    # the two tap orientations differ only in where tap a's dW lands
    a = args(case, torch.bfloat16)
    _, dw_f = a["k2"](W.windowed_bwd_gather, True)
    _, dw_n = a["k2"](W.windowed_bwd_gather, False)
    if not torch.equal(dw_f, dw_n.flip(0)):
        raise AssertionError("K2's two tap orientations disagree")
    # dW is reduced over chunks in a fixed order: bitwise reproducible
    if not torch.equal(a["k3"](W.windowed_dw_sub),
                       a["k3"](W.windowed_dw_sub)):
        raise AssertionError("K3's dW is not reproducible run to run")

    rows = [kernel_row(W.K2, src, "tdwss/ops/pallas_subm.py:926",
                       lambda: a["k2"](W.windowed_bwd_gather, True),
                       lambda: a["k2"](W.windowed_bwd_gather_plain, True),
                       a["work_k2"], errs[W.K2]),
            kernel_row(W.K3, src, "tdwss/ops/pallas_subm.py:1122",
                       lambda: a["k3"](W.windowed_dw_sub),
                       lambda: a["k3"](W.windowed_dw_sub_plain),
                       a["work_k3"], errs[W.K3]),
            kernel_row(W.K5, src, "tdwss/ops/pallas_subm.py:473",
                       lambda: a["k5"](W.windowed_dw),
                       lambda: a["k5"](W.windowed_dw_plain),
                       a["work_k5"], errs[W.K5])]
    w = args(wide, torch.bfloat16)
    log(f"{W.K3} at the widest conv ({w['label']}):")
    kernel_row(W.K3, src, "", lambda: w["k3"](W.windowed_dw_sub),
               lambda: w["k3"](W.windowed_dw_sub_plain), w["work_k3"], 0.0)
    return rows


def expected_launches(model, plans, train: bool, reps: int = 1):
    """Kernel launches the plans route ``reps`` forwards (and, with
    ``train``, backwards) to, per kernel, from each windowed conv's plan
    form and channel widths.

    Forward: every windowed subm conv (the stem, the encoder and decoder
    blocks) and, where a level has both cross-level plans, its strided
    conv (down plan) and deconv (up plan) go to K1 when sub-form, K4 when
    flat.  Backward: where the backward plan is sub-form and both widths
    are at most GATHER_MAX_C, K2; otherwise K3 (sub) or K5 (flat) on the
    forward plan for dW, and K1 or K4 on the backward plan for dfeats,
    except at the stem, whose input needs no gradient.
    """
    from tdwss_torch.ops import windowed as W

    counts = {name: 0 for name in W.launches}
    fwd = {True: W.K1, False: W.K4}

    def conv(plan, bplan, kernel, needs_dfeats=True):
        if plan is None:
            return                           # rulebook route: no kernel
        counts[fwd[bool(plan.sub)]] += reps
        if not train:
            return
        _, cin, cout = kernel.shape
        if bplan.sub and cin <= GATHER_MAX_C and cout <= GATHER_MAX_C:
            counts[W.K2] += reps
        else:
            counts[W.K3 if plan.sub else W.K5] += reps
            if needs_dfeats:
                counts[fwd[bool(bplan.sub)]] += reps

    enc = model.pc_encoder
    level0 = plans.levels[0]
    conv(level0.win, level0.win, enc.stem.kernel, needs_dfeats=False)
    body, i = enc.body, 0
    while True:
        lvl = plans.levels[i]
        blocks = [getattr(body, f"enc{j}") for j in range(body.reps)]
        if body.deep:
            blocks += [getattr(body, f"dec{j}") for j in range(body.reps)]
        for blk in blocks:
            for name in ("conv", "conv1", "conv2"):
                if hasattr(blk, name):
                    conv(lvl.win, lvl.win, getattr(blk, name).kernel)
        if not body.deep:
            return counts
        if lvl.wg_down is not None and lvl.wg_up is not None:
            conv(lvl.wg_down, lvl.wg_up, body.down_conv.kernel)
            conv(lvl.wg_up, lvl.wg_down, body.up_deconv.kernel)
        body, i = body.inner, i + 1


@contextlib.contextmanager
def plain_versions():
    """Route the model's windowed evaluations, forward and backward,
    through the plain versions (for the comparison runs only)."""
    from tdwss_torch.ops import sparse_conv
    from tdwss_torch.ops import windowed as W

    names = ("windowed_matmul_sub", "windowed_matmul", "windowed_bwd_gather",
             "windowed_dw_sub", "windowed_dw")
    saved = {n: getattr(sparse_conv, n) for n in names}
    for n in names:
        setattr(sparse_conv, n, getattr(W, n + "_plain"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(sparse_conv, n, fn)


@contextlib.contextmanager
def layer_by_layer_check(dfeats_tol, dw_tol):
    """Run every windowed conv backward of the enclosed step a second time
    through the plain versions on the same inputs and compare (dfeats
    within ``dfeats_tol``, dW within ``dw_tol`` of max|plain|); yields a
    dict with the count and the largest relative errors."""
    from tdwss_torch.ops import sparse_conv

    seen = {"n": 0, "dfeats": 0.0, "dw": 0.0}

    def rel(a, b, tol, what, label):
        scale = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        r = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
        seen[what] = max(seen[what], r)
        if not r <= tol:
            raise AssertionError(f"{label}: {what} through the kernels "
                                 f"disagrees with the plain versions: "
                                 f"{r} > {tol}")

    def wrap(fn):
        def checked(feats, weight, dout, *rest):
            dfeats, dw = fn(feats, weight, dout, *rest)
            with plain_versions():
                pdfeats, pdw = fn(feats, weight, dout, *rest)
            seen["n"] += 1
            label = (f"{fn.__name__} V={feats.shape[0]} "
                     f"W={tuple(weight.shape)}")
            if pdfeats is not None:
                rel(dfeats, pdfeats, dfeats_tol, "dfeats", label)
            rel(dw, pdw, dw_tol, "dw", label)
            return dfeats, dw
        return checked

    saved = (sparse_conv._subm_w27_backward, sparse_conv._wg_backward)
    sparse_conv._subm_w27_backward = wrap(saved[0])
    sparse_conv._wg_backward = wrap(saved[1])
    try:
        yield seen
    finally:
        sparse_conv._subm_w27_backward, sparse_conv._wg_backward = saved


def phase_main(cfg, scenes, plans_rep1, batch_rep1, device):
    import torch

    from tdwss_torch.engine.evaluate import validate
    from tdwss_torch.engine.steps import eval_step
    from tdwss_torch.models.meta_arch import build_model
    from tdwss_torch.ops import windowed as W

    model = build_model(cfg, seed=0, device=device)
    timings = []
    torch.cuda.reset_peak_memory_stats()
    W.reset_launches()
    ious = validate(cfg, model, scenes, reps=VAL_REPS, verbose=False,
                    device=device, timings=timings)
    launches = dict(W.launches)
    for t, miou in zip(timings, ious):
        log(f"validate rep {t['rep']}: host planning {t['plan_s']:.3f} s, "
            f"device forward+votes {t['device_s']:.3f} s, mIoU {miou:.6f}")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    if len(ious) != VAL_REPS or not all(math.isfinite(x) for x in ious):
        raise AssertionError(f"bad mIoU list {ious}")
    want = expected_launches(model, plans_rep1, train=False, reps=VAL_REPS)
    log(f"launches in validate: {launches}; routed by the plans: {want}")
    if launches != want or launches[W.K1] == 0:
        raise AssertionError("validate's launches differ from the plans' "
                             f"routing: {launches} vs {want}")

    b = batch_rep1.to(device)
    logits = eval_step(model, b)
    with plain_versions():
        plain = eval_step(model, b)
    torch.cuda.synchronize()
    if logits.shape != (MAX_POINTS, 20) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad logits {tuple(logits.shape)}")
    valid = b.valid
    d = (logits - plain).abs()[valid]
    ref = plain.abs()[valid]
    dmax, dmean = d.max().item(), d.mean().item()
    rmax, rmean = ref.max().item(), ref.mean().item()
    log(f"logits through kernels vs plain versions ({int(valid.sum())} "
        f"points, bf16): max|d| {dmax:.6g} (limit {LOGITS_MAX_TOL} * "
        f"{rmax:.6g}), mean|d| {dmean:.6g} (limit {LOGITS_MEAN_TOL} * "
        f"{rmean:.6g}); argmax agreement "
        f"{(logits.argmax(1) == plain.argmax(1))[valid].float().mean().item():.6f}")
    if dmax > LOGITS_MAX_TOL * rmax or dmean > LOGITS_MEAN_TOL * rmean:
        raise AssertionError("main-path logits disagree with the plain "
                             "versions beyond the stated tolerance")
    return launches


def phase_train(cfg, scenes, device):
    """One bench batch, 3 training steps, launches against the plans'
    routing, and one step's loss and gradients against the plain
    versions."""
    import numpy as np
    import torch

    from tdwss_torch.data.collate import train_collate
    from tdwss_torch.data.plans import attach_host_plans, slim_batch_for_train
    from tdwss_torch.engine.steps import (compute_loss, make_optimizer,
                                          train_step)
    from tdwss_torch.models.meta_arch import build_model
    from tdwss_torch.ops import windowed as W
    from tdwss_torch.ops.host_plan import reset_sticky_plans

    reset_sticky_plans()
    t = time.perf_counter()
    planned = attach_host_plans(
        train_collate(scenes, cfg, np.random.default_rng(0)), cfg)
    host = slim_batch_for_train(planned, cfg)
    host_s = time.perf_counter() - t
    lvl0 = host.plans.levels[0]
    log(f"train batch on the host (collate + plans + slim): {host_s:.3f} s;"
        f" level 0: V={lvl0.grid.valid.shape[0]} "
        f"valid={int(lvl0.grid.valid.sum())}")
    t = time.perf_counter()
    batch = host.to(device)
    torch.cuda.synchronize()
    log(f"train batch to the card: {time.perf_counter() - t:.3f} s")

    model = build_model(cfg, seed=0, device=device)
    opt, sched = make_optimizer(cfg, model, STEPS_PER_EPOCH)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    W.reset_launches()
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        loss, _ = train_step(cfg, model, opt, sched, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(loss)
    launches = dict(W.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in losses]
    for i, (x, sec) in enumerate(zip(losses, step_s)):
        log(f"train step {i + 1}: loss {x:.6f}; device {sec:.3f} s "
            f"(forward + backward + Adam, ended by a synchronise); host "
            f"planning of its batch {host_s:.3f} s")
    log(f"peak device memory over the steps: {peak:.2f} GiB")
    want = expected_launches(model, host.plans, train=True,
                             reps=TRAIN_STEPS)
    log(f"launches in {TRAIN_STEPS} training steps: {launches}; routed by "
        f"the plans: {want}")
    if launches != want or not (launches[W.K1] and launches[W.K2]
                                and launches[W.K3]):
        raise AssertionError("training launches differ from the plans' "
                             f"routing: {launches} vs {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss {losses}")
    unmoved = [n for n, p in model.named_parameters()
               if torch.equal(p.detach(), before[n])]
    if unmoved:
        raise AssertionError(f"parameters that did not move: {unmoved}")
    log(f"all {len(before)} parameter tensors moved over {TRAIN_STEPS} "
        f"steps")
    del model, opt, sched, before

    def loss_and_grads(model, ctx):
        model.zero_grad(set_to_none=True)
        with ctx:
            loss, _ = compute_loss(cfg_of[id(model)], model,
                                   batch_of[id(model)])
            loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), {n: p.grad.detach().float().clone()
                                      for n, p in model.named_parameters()}

    def ratios(ga, gb):
        out = []
        for n in ga:
            ref = torch.linalg.vector_norm(gb[n]).item()
            diff = torch.linalg.vector_norm(ga[n] - gb[n]).item()
            out.append((diff / ref if ref > 0 else
                        (0.0 if diff == 0 else math.inf), n))
        return sorted(out, reverse=True)

    def check_loss(dtype, lk, lp, tol):
        rel = abs(lk - lp) / abs(lp)
        log(f"one {dtype} step's loss through the kernels vs the plain "
            f"versions: {lk:.8f} vs {lp:.8f} (relative {rel:.3g}, limit "
            f"{tol})")
        if not rel <= tol:
            raise AssertionError(f"the {dtype} training loss through the "
                                 "kernels disagrees with the plain versions")

    def summary(rs):
        return (", ".join(f"{n} {r:.3g}" for r, n in rs[:3])
                + f"; median {rs[len(rs) // 2][0]:.3g}")

    cfg32 = copy.deepcopy(cfg)
    cfg32.engine.compute_dtype = "float32"
    m16 = build_model(cfg, seed=0, device=device)
    m32 = build_model(cfg32, seed=0, device=device)
    cfg_of = {id(m16): cfg, id(m32): cfg32}
    # the f32 step reads the batch as an f32 configuration slims it
    batch_of = {id(m16): batch,
                id(m32): slim_batch_for_train(planned, cfg32).to(device)}

    for model, dtype, tols in ((m16, "bf16", (KERNEL_TOL, DW_TOL)),
                               (m32, "f32", (KERNEL_TOL_F32, DW_TOL))):
        with layer_by_layer_check(*tols) as checked:
            loss_and_grads(model, contextlib.nullcontext())
        log(f"layer by layer, {dtype}: {checked['n']} windowed conv "
            f"backwards re-run through the plain versions on the same "
            f"inputs; largest dfeats max|d| / max|plain| "
            f"{checked['dfeats']:.3g} (limit {tols[0]:.3g}), dW "
            f"{checked['dw']:.3g} (limit {tols[1]})")

    # bf16: the loss alone (the whole-step gradients are ill-conditioned,
    # see above).  f32, under deterministic algorithms: the loss, two runs
    # through the kernels bit for bit, and the gradients per tensor.
    lk, _ = loss_and_grads(m16, contextlib.nullcontext())
    lp, _ = loss_and_grads(m16, plain_versions())
    check_loss("bf16", lk, lp, LOSS_RTOL)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        lk, gk = loss_and_grads(m32, contextlib.nullcontext())
        _, gk2 = loss_and_grads(m32, contextlib.nullcontext())
        lp, gp = loss_and_grads(m32, plain_versions())
    finally:
        torch.use_deterministic_algorithms(False)
    check_loss("f32", lk, lp, LOSS_RTOL_F32)
    rs = ratios(gk, gp)
    same = all(torch.equal(gk[n], gk2[n]) for n in gk)
    log(f"one f32 step (deterministic algorithms), ||g_kern - g_plain|| / "
        f"||g_plain|| over {len(rs)} tensors (limit {GRAD_RTOL_F32}), "
        f"largest: {summary(rs)}; two runs through the kernels "
        f"bit-identical: {same}")
    if not (rs[0][0] <= GRAD_RTOL_F32 and same):
        raise AssertionError("f32 training gradients through the kernels "
                             "disagree with the plain versions or are not "
                             "reproducible")
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "tdwss_torch")):
        print("chip_smoke.py: the tdwss_torch package is not beside this "
              "file", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}"
        f", {torch.cuda.device_count()} card(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    phase_build()

    from tdwss_torch.data.dataset import val_offsets
    from tdwss_torch.data.loader import val_batches
    from tdwss_torch.data.synthetic import make_dataset
    from tdwss_torch.ops.host_plan import reset_sticky_plans

    cfg = bench_config()
    t = time.perf_counter()
    scenes = make_dataset(NUM_SCENES, num_points=POINTS_PER_SCENE, seed=7,
                          with_text=False)
    log(f"data: {NUM_SCENES} scenes x {POINTS_PER_SCENE} points in "
        f"{time.perf_counter() - t:.2f} s")
    reset_sticky_plans()
    t = time.perf_counter()
    batch = next(val_batches(scenes, cfg, val_offsets(scenes)[0], 1))
    log(f"host plan of the rep-1 batch: {time.perf_counter() - t:.3f} s")
    for i, lvl in enumerate(batch.plans.levels):
        forms = [f"{n}={'sub' if p.sub else 'flat'}/w{p.window}"
                 for n, p in (("win", lvl.win), ("down", lvl.wg_down),
                              ("up", lvl.wg_up)) if p is not None]
        log(f"level {i}: V={lvl.grid.valid.shape[0]} "
            f"valid={int(lvl.grid.valid.sum())} {' '.join(forms)}")

    gen = torch.Generator().manual_seed(0)
    m = cfg.pointcloud_model.m
    case = level_case(batch.plans, 0, m, m, device, gen)
    rows = phase_kernels(case)
    deep = len(batch.plans.levels) - 2          # deepest level with a decoder
    planes = (deep + 1) * m
    wide = level_case(batch.plans, deep, 2 * planes, planes, device, gen)
    phase_wide(wide)
    rows += phase_bwd_kernels(case, wide)
    del case, wide
    reset_sticky_plans()
    val_launches = phase_main(cfg, scenes, batch.plans, batch, device)
    train_launches = phase_train(cfg, scenes, device)
    for row in rows:
        row["launches"] = (val_launches[row["name"]]
                           + train_launches[row["name"]])
    # The kernels line lists the kernels of the main paths (validate and
    # training, launches summed); a kernel whose plan form the bench plans
    # lack was checked above and is logged here.
    on_path = [row for row in rows if row["launches"] > 0]
    for row in rows:
        if row["launches"] == 0:
            log(f"not on the main paths (no flat-form plan), checked "
                f"above: {json.dumps(row)}")
    log("all phases passed")
    print(json.dumps({"kernels": on_path}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
