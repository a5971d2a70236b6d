"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's main paths: validation and training of MultiLabel over
SparseConvUNet at the bench width (m=32, block_reps=2, residual blocks,
7 levels, scale 50, bf16 compute), and training of MultiLabel over the
FCN-family encoders of two shipped configs at their own widths
(``configs/3DUNetWithText_scannet_fcnet_baseline_narrower.yaml``:
SparseConvFCNetNarrow, m=16, planes 16..256, 5 levels;
``..._finer.yaml``: SparseConvFCNet, m=16, 7 levels), and training of
MultiLabelContrastive with its text tower
(``configs/3DUNetWithText_scannet_fcnet.yaml``: SparseConvFCNet, m=16, 7
levels; text tower width 256, 12 layers, context 120, vocab 49,408), all
on the bench batch (5 synthetic scenes of 150,000 points with their
descriptions, ``max_points`` 786,432, in place of the configs' 6 or 8
scenes in 4,194,304 or 2,097,152) with seeded random weights,
drives the experimental brick engine at the bench level 0, and drives
the weak-supervision loop through the port's entry points (``Trainer``,
the pseudo-label stage, ``FullySupervised`` and the train CLI) at
SparseConvFCNet's width, and checks them:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: the kernels' four shared libraries (nvcc: forward K1/K4,
   backward K2/K3/K5, fused subm backward K6, block gather K7) and the
   native host planner (g++), compiled from the checkout in parallel,
   timed;
3. kernels: K1 (windowed_matmul_sub) and K4 (windowed_matmul) at the
   bench plans' level-0 shapes against their plain PyTorch versions on
   the card, with times (CUDA events), the plain versions' times and the
   bound of each on an H100; then, untimed, at the widest decoder conv;
4. backward kernels: K2 (windowed_bwd_gather, both tap orientations),
   K3 (windowed_dw_sub) and K5 (windowed_dw, the same windows in the
   flat form) at the level-0 shape, and K3 at the widest conv of the
   path, against their plain versions in bf16 and in f32, timed as in 3;
   K6 (windowed_bwd_sub) at the bench UNet's widest subm conv and at
   Narrow's widest level, in bf16 and f32, bit for bit twice, timed (K2,
   K3, K5 and K6 in samples of BACK_TO_BACK calls back to back);
5. validation: ``validate`` (2 vote repetitions) with the launch counts
   set to 0 just before and read just after, equal to what the plans
   route to each kernel, every K1/K4 launch on the tensor-core body (the
   per-body counts of K1/K4, K2 and K6); each kernel's device time in one rep's forward
   (CUDA events around each kernel wrapper call); the per-point logits
   of a full forward, bit for bit over two forwards, and held against the
   same forward through the plain versions on the card;
6. training, per path (UNet 3 steps, Narrow 3 steps, FCNet 1 step, Text
   3 steps: ``configs/3DUNetWithText_scannet_fcnet.yaml``,
   MultiLabelContrastive over SparseConvFCNet with its 12-layer text
   tower at width 256 on the scenes' descriptions, the batch's
   tokenizing timed apart): one
   batch through ``train_collate`` -> ``attach_host_plans`` ->
   ``slim_batch_for_train`` (host, timed), then ``train_step``s (forward
   with batch norm in train mode, scene pooling, Classification loss,
   backward through the kernels, Adam) with the launch counts set to 0
   just before and read just after, equal to the plans' routing, and
   every K1/K4, K2 and K6 launch on the tensor-core body; the loss is
   finite and every parameter moves; each kernel's device time in one
   more (warm) step; every windowed backward and unpool of one step re-run through
   the plain versions, and the step's loss held against them; for the
   UNet also two bf16 steps' gradients bit for bit and the f32 step (see
   the tolerances below); the identity unpools of the Narrow batch timed
   per level; for the text path its text loss and total in bf16 within
   TEXT_LOSS_RTOL, for model seeds 0-7, and a planted K1 fault beyond it,
   two bf16 steps' gradients bit for bit,
   an f32 step's loss parts against the plain versions, the text tower's
   features, ``TextContrastive`` and the text mask on the card against
   the same weights on the CPU, the tower's forward and backward ms
   (CUDA events) and share of a warm step, and no synchronising call in
   a warm text step;
7. forward sweep: K1 at every distinct (form, C, Cout, K) that the paths
   of 5-6 launched, on their own windows, and at a ragged synthetic plan
   (V_out not a multiple of 64, Cout not a multiple of 8, rb in the
   (K, V_out) layout, a row block of sentinels), against its plain
   version in bf16 and f32, each launch on the body its dtype selects;
   K4 on the same windows in the flat form bit for bit equal to K1 in
   bf16; one line per shape with its bf16 time and the bound;
8. backward sweep: K2 and K6 at every distinct (kernel, Cin, Cout, K,
   flip_taps, need_dfeats) that the paths of 6 launched, on their own
   plans, against their plain versions in bf16 and f32, each launch on
   the body its dtype selects, two launches bit for bit equal; one line
   per shape with its bf16 time and the bound;
9. dW sweep: K3 (and K5, had a path a flat-form plan) at every distinct
   (kernel, C, Cout, K) that the paths of 6 launched, on their own
   plans, against its plain version in bf16 and f32, each launch on the
   body its dtype selects, two launches bit for bit equal; K5 on the same
   windows in the flat form, against its plain version and bit for bit
   equal to K3 in bf16; one line per shape with the bf16 times and the
   bound;
10. brick engine (``tdwss_torch.ops.experimental``), on the level-0 grid
   of the bench batch: with the launch counts set to 0 just before and
   read just after, the host brick plan (timed), ``brick_subm_conv`` at
   32 -> 32 in bf16, and the halo-face gather through ``gather_blocks``
   (K7; the two x-faces of every
   occupied brick's neighbours, each one (8, 8*32) bf16 block); then the
   brick conv against the windowed ``subm_conv_apply`` (K1 route) on the
   same grid and weights in bf16 (max|d| <= 2^-7 max|windowed|) and f32
   (1e-4), both timed with their peak memory, and the bf16 brick conv's
   parts; K7 against its plain version bit for bit at that shape and at
   the reference test's (128, 8, 128) f32 with 64 indices, timed
   (samples of BACK_TO_BACK calls back to back) beside
   ``torch.index_select`` and its bound, and at 30-byte rows (2-byte
   copies), bit for bit;
11. profile: one warm UNet training step with
    ``torch.cuda.set_sync_debug_mode("warn")`` (every synchronising call,
    by file:line), then one traced by ``tdwss_torch.utils.profiling``
    (torch.profiler, host and card): the top device operations by total
    time, the device's idle share over the traced window, and the device
    time by category (the hand-written kernels, the forward's batch norm,
    the spill tiers' segmented sums, the conv backward around the
    kernels, the kernel wrappers' own ops, Adam, casts and copies, other
    forward and backward ops); the trace goes to
    ``<--trace-dir>/trace.json.gz`` (default ``exp/chip_smoke/``);
12. loop, in a temporary working directory, on 10 synthetic train scenes
    of 150,000 points and the 5 val scenes: a ``Trainer`` over
    ``configs/3DUNetWithText_pseudolabel_finer.yaml`` (cut to the bench
    batch) fits one epoch (2 steps and the epoch-1 validation) and a
    second ``Trainer`` resumes at epoch 2 with its state bit for bit;
    ``threshold_sweep`` and ``generate_pseudo_labels`` at 0.71; a
    ``Trainer`` over ``..._fcnet_with_pseudo.yaml`` (FullySupervised,
    cut the same way) fits one epoch on those labels, and its epoch 2 is
    timed (wall seconds per step through the prefetching loader, device
    seconds per step by CUDA events) against the host's seconds per batch
    planned serially; the launch counts over these are read and K1 and
    K2 must have run, every launch on the tensor-core body; one
    FullySupervised step goes through the checks of 6 with two bf16 steps'
    gradients bit for bit, and ``devoxelize_seg``'s backward repeats bit
    for bit at the head's width; a ``Trainer`` over
    ``3DUNetWithText_scannet_fcnet.yaml`` fits one epoch on the train
    scenes' descriptions (tokenized in the loader's threads), K1 and K2
    launched on the tensor-core body; last, ``python -m tdwss_torch.cli.train
    --config configs/smoke_cpu.yaml --epochs 1`` runs on the card as a
    subprocess and must print its mIoU;
13. one JSON line with the numbers of every ported kernel (K1-K7, each
    with its launches over the main paths, the loop and the brick path,
    0 included), the card line from ``nvidia-smi``, and the result line.

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
LOOP_SCENES = 10                   # train scenes of the loop phase
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
#   backward in the step, and every windowed unpool forward and
#   backward, is run again through the plain versions on the same
#   inputs; dfeats within KERNEL_TOL (bf16) or KERNEL_TOL_F32, dW within
#   DW_TOL.
# - Reproducibility: the kernels' dW partials and the spill tiers'
#   segmented sums add in a fixed order, so two bf16 steps through the
#   kernels give every gradient tensor bit for bit, with no switch of
#   PyTorch's set.
# - The whole step: the loss within 1e-2 relative in bf16 and 1e-5 in
#   f32, and the f32 step's gradients: two runs through the kernels bit
#   for bit, and kernels vs plain within 0.05 per tensor,
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
#   check is what catches it.  In bf16 the whole-step gradients are held
#   only to be reproducible (see ``step_grads --dtype bf16`` and
#   PERF.md for the spread against the plain versions).
# - The text loss in bf16 (TEXT_LOSS_RTOL): it multiplies the
#   scene-pooled features by text features of norm ~21 (similarities
#   -12..8 at the seeded weights).  In bf16 the pooled features of a run
#   through the kernels and one through the plain versions differ by up
#   to 1.4% of their largest (one-ulp roundings carried through the 7
#   levels, batch norm over 59 voxels at the deepest), which moves the
#   text loss by up to 2.0% and the total by up to 1.7% over model seeds
#   0-7; in f32 the two runs agree within 3e-6.  A planted fault, tap 0 of
#   the weight zeroed in the forward's first K1 launch only, moves them by
#   4.2% and 3.4%; on an H100 80GB HBM3 (700 W), printed by
#   ``check_text_loss_limit``.  So the text path holds its text loss and
#   total in bf16 to 3%, between the two (the script checks that the
#   limit still lies between them), its Classification part to
#   LOSS_RTOL, and its whole loss and parts in f32 to LOSS_RTOL_F32.  Its
#   f32 gradients are not held per tensor: the attention's key bias has a
#   zero gradient in exact arithmetic (softmax ignores a shift common to a
#   query's keys), so both runs give rounding noise there.
LOSS_RTOL = 1e-2
LOSS_RTOL_F32, GRAD_RTOL_F32 = 1e-5, 0.05
TEXT_LOSS_RTOL = 3e-2
TEXT_LOSS_SEEDS = tuple(range(1, 8))    # beside phase_train's seed 0
TRAIN_STEPS = 3
STEPS_PER_EPOCH = 100
# The reference's K2 width gate (tdwss/ops/sparse_conv.py:936, :1455)
GATHER_MAX_C = 128
# The brick engine's width: the bench m.
BRICK_C = 32
# The text path: MultiLabelContrastive over SparseConvFCNet with its
# text tower (width 256, 12 layers, context 120, vocab 49,408, f32), cut
# to the bench batch like the other configs.
TEXT_CONFIG = "3DUNetWithText_scannet_fcnet.yaml"
TEXT_STEPS = 3
# The text tower's features on the card vs the same weights on the CPU,
# both f32 with TF32 off: sums of 256-1024 products in another order
# through 12 layers, max|d| <= 1e-4 * max|cpu|; TextContrastive's value
# from those features within 1e-4 relative; the text mask equal.
TEXT_TOL = 1e-4
# Samples (CUDA events) of the tower's forward and backward, after one
# warm-up.
TEXT_TIMED = 10
# K7, K1/K4, K2, K3/K5 and K6 take 0.05-1 ms, the same order as their
# wrappers' host work: each timed sample of them, their plain versions and the
# library call, and each bf16 time of the forward and backward sweeps, is
# the mean of this many calls back to back, so that the device does not
# wait on the host.
BACK_TO_BACK = 10


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


def narrow_config():
    """``configs/3DUNetWithText_scannet_fcnet_baseline_narrower.yaml``
    field for field (the card machine has no YAML reader)."""
    from tdwss_torch.config import (Config, EngineConfig, LossConfig,
                                    PointcloudDataConfig,
                                    PointcloudModelConfig)

    return Config(
        training_name="scene_level_with_fcnet_narrower",
        model_name="MultiLabel", label="scene_level", has_text=False,
        epochs=1024,
        pointcloud_data=PointcloudDataConfig(
            scale=20, val_reps=1, batch_size=6, elastic_deformation=True),
        pointcloud_model=PointcloudModelConfig(
            name="SparseConvFCNetNarrow", m=16, dimension=3, full_scale=4096,
            block_reps=2, residual_blocks=True, n_planes=[64, 128, 192, 256]),
        loss=LossConfig(Classification=True),
        engine=EngineConfig(max_points=4194304, level_capacity_shrink=2,
                            min_level_capacity=8192,
                            compute_dtype="bfloat16"))


def fcnet_config():
    """``configs/3DUNetWithText_scannet_fcnet_baseline_finer.yaml`` field
    for field."""
    from tdwss_torch.config import (Config, EngineConfig, LossConfig,
                                    PointcloudDataConfig,
                                    PointcloudModelConfig)

    return Config(
        training_name="scene_level_with_fcnet_baseline_finer",
        model_name="MultiLabel", label="scene_level", has_text=False,
        epochs=1024,
        pointcloud_data=PointcloudDataConfig(
            scale=50, val_reps=1, batch_size=6, elastic_deformation=True),
        pointcloud_model=PointcloudModelConfig(
            name="SparseConvFCNet", m=16, dimension=3, full_scale=4096,
            block_reps=2, residual_blocks=True),
        loss=LossConfig(Classification=True),
        engine=EngineConfig(max_points=4194304, level_capacity_shrink=2,
                            min_level_capacity=8192,
                            compute_dtype="bfloat16"))


def cut_to_bench_batch(cfg):
    """The config with the bench batch in place of its own: NUM_SCENES
    scenes in ``MAX_POINTS`` points (the configs ask for 6 scenes in
    4,194,304)."""
    cfg = copy.deepcopy(cfg)
    cfg.pointcloud_data.batch_size = NUM_SCENES
    cfg.engine.max_points = MAX_POINTS
    return cfg


def cuda_time_ms(fn, iters: int, warmup: int = 2, window: int = 1) -> float:
    """Median milliseconds of ``fn`` over ``iters`` samples (CUDA events),
    each the mean of ``window`` calls run back to back (more than one
    where a call's host work is comparable to its device time, so that
    the device does not wait on the host between launches)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(window):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / window)
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
            "fused subm backward kernel": lambda: windowed.build("bwd_sub"),
            "block gather kernel": lambda: windowed.build("gather"),
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
    for name in ("forward kernels", "backward kernels",
                 "fused subm backward kernel", "block gather kernel"):
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


def kernel_row(name, source, replaces, run, plain, work, err, library=None,
               window=1):
    """Time ``run``, ``plain`` and, where one PyTorch call computes the
    same function, ``library`` (CUDA events; ``window`` calls per
    sample), and bound the work."""
    ms = cuda_time_ms(run, iters=20, window=window)
    plain_ms = cuda_time_ms(plain, iters=3, warmup=1, window=window)
    library_ms = (cuda_time_ms(library, iters=20, window=window)
                  if library else None)
    nbytes, flops = work()
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / BF16_FLOPS_PER_S * 1e3
    bound_ms = max(bound_bytes, bound_ops)
    lib = f", library {library_ms:.4f} ms" if library else ""
    per = f" of {window} back to back" if window > 1 else ""
    log(f"{name}: {ms:.4f} ms (median of 20{per}), plain {plain_ms:.3f} ms{lib}, "
        f"bound {bound_ms:.4f} ms ({nbytes} B, {flops} flop)")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                library_ms=library_ms)


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
                               kern["work"], err, window=BACK_TO_BACK))
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
                       a["work_k2"], errs[W.K2], window=BACK_TO_BACK),
            kernel_row(W.K3, src, "tdwss/ops/pallas_subm.py:1122",
                       lambda: a["k3"](W.windowed_dw_sub),
                       lambda: a["k3"](W.windowed_dw_sub_plain),
                       a["work_k3"], errs[W.K3], window=BACK_TO_BACK),
            kernel_row(W.K5, src, "tdwss/ops/pallas_subm.py:473",
                       lambda: a["k5"](W.windowed_dw),
                       lambda: a["k5"](W.windowed_dw_plain),
                       a["work_k5"], errs[W.K5], window=BACK_TO_BACK)]
    w = args(wide, torch.bfloat16)
    log(f"{W.K3} at the widest conv ({w['label']}):")
    kernel_row(W.K3, src, "", lambda: w["k3"](W.windowed_dw_sub),
               lambda: w["k3"](W.windowed_dw_sub_plain), w["work_k3"], 0.0,
               window=BACK_TO_BACK)
    return rows


def phase_k6(cases):
    """K6 (windowed_bwd_sub) against its plain version in bf16 and f32 at
    each ``(label, case)`` of ``cases`` (level_case arguments: Cin = the
    case's C, Cout = its dout width), timed in bf16 (20 CUDA-event
    launches) beside its bound and its plain version; returns the row of
    the first case and logs the others on lines of their own."""
    import torch

    from tdwss_torch.ops import windowed as W

    rows = []
    for label, cs in cases:
        st, soff = cs["starts"].reshape(-1), cs["soff"].reshape(-1)
        geo = (cs["window"], cs["tile"], cs["sub"], cs["subwin"])
        err = 0.0
        for dtype, tol in ((torch.bfloat16, KERNEL_TOL),
                           (torch.float32, KERNEL_TOL_F32)):
            x, dout = cs["x"].to(dtype), cs["dout"].to(dtype)
            wt = cs["w"].to(dtype).flip(0).transpose(1, 2).contiguous()
            run = (lambda x=x, dout=dout, wt=wt: W.windowed_bwd_sub(
                x, dout, st, soff, cs["rb"].t(), wt, *geo))
            plain = (lambda x=x, dout=dout, wt=wt: W.windowed_bwd_sub_plain(
                x, dout, st, soff, cs["rb"].t(), wt, *geo))
            (dx, dw), (pdx, pdw) = run(), plain()
            torch.cuda.synchronize()
            lab = (f"{label}: V={x.shape[0]} Cin={x.shape[1]} "
                   f"Cout={dout.shape[1]} K=27 {str(dtype)[6:]}")
            e = check_against_plain(W.K6, dx, pdx, f"dfeats {lab}", tol)
            e = max(e, check_against_plain(W.K6, dw, pdw, f"dW {lab}",
                                           DW_TOL))
            again = run()
            if not (torch.equal(again[0], dx) and torch.equal(again[1], dw)):
                raise AssertionError("K6 is not reproducible run to run")
            if dtype == torch.bfloat16:
                err, timed = e, (run, plain, x, dout, wt)
        run, plain, x, dout, wt = timed
        log(f"{W.K6} at {label}:")
        rows.append(kernel_row(
            W.K6, "tdwss_torch/csrc/windowed_bwd_sub.cu",
            "tdwss/ops/pallas_subm.py:1339", run, plain,
            lambda: W.work_bwd_sub(x, dout, st, soff, cs["rb"].t(), wt,
                                   cs["tile"], cs["sub"], cs["subwin"]),
            err, window=BACK_TO_BACK))
    for (label, _), row in zip(cases[1:], rows[1:]):
        log(f"{W.K6} at {label} (logged only): {json.dumps(row)}")
    return rows[0]


def check_bodies(label):
    """Every K1 / K4, K2, K3 / K5 and K6 launch counted since the last
    reset went to the tensor-core body (the counted paths run in bf16)."""
    from tdwss_torch.ops import windowed as W

    bodies = dict(W.body_launches)
    log(f"{label}: K1/K4, K2, K3/K5, K6 launches per body: {bodies}")
    for name in (W.K1, W.K4, W.K2, W.K3, W.K5, W.K6):
        if (bodies[f"{name}:{W.BODY_FMA}"]
                or bodies[f"{name}:{W.BODY_MMA}"] != W.launches[name]):
            raise AssertionError(f"{label}: a bf16 {name} launch did not take "
                                 f"the tensor-core body: {bodies}")


def expected_launches(model, plans, train: bool, reps: int = 1):
    """Kernel launches the plans route ``reps`` forwards (and, with
    ``train``, backwards) to, per kernel, from each windowed conv's plan
    form and channel widths.

    Forward: every windowed subm conv (the stem, the encoder and decoder
    blocks) and, where a level has both cross-level plans, its strided
    conv (down plan) and its deconv or unpool (up plan) go to K1 when
    sub-form, K4 when flat.  Backward: where the backward plan is
    sub-form and both widths are at most GATHER_MAX_C, K2; otherwise a
    sub-form subm conv takes K6, and any other conv K3 (sub) or K5 (flat)
    on the forward plan for dW and K1 or K4 on the backward plan for
    dfeats, except at the stem, whose input needs no gradient.  An
    unpool's backward is K1 or K4 on the down plan (no dW).
    """
    from tdwss_torch.ops import windowed as W

    counts = {name: 0 for name in W.launches}
    fwd = {True: W.K1, False: W.K4}

    def conv(plan, bplan, kernel, needs_dfeats=True, subm=False):
        if plan is None:
            return                           # rulebook route: no kernel
        counts[fwd[bool(plan.sub)]] += reps
        if not train:
            return
        _, cin, cout = kernel.shape
        if bplan.sub and cin <= GATHER_MAX_C and cout <= GATHER_MAX_C:
            counts[W.K2] += reps
        elif subm and plan.sub:
            counts[W.K6] += reps
        else:
            counts[W.K3 if plan.sub else W.K5] += reps
            if needs_dfeats:
                counts[fwd[bool(bplan.sub)]] += reps

    enc = model.pc_encoder
    level0 = plans.levels[0]
    conv(level0.win, level0.win, enc.stem.kernel, needs_dfeats=False,
         subm=True)
    body, i = enc.body, 0
    while True:
        lvl = plans.levels[i]
        blocks = [getattr(body, f"enc{j}") for j in range(body.reps)]
        if body.deep and hasattr(body, "dec0"):
            blocks += [getattr(body, f"dec{j}") for j in range(body.reps)]
        for blk in blocks:
            for name in ("conv", "conv1", "conv2"):
                if hasattr(blk, name):
                    conv(lvl.win, lvl.win, getattr(blk, name).kernel,
                         subm=True)
        if not body.deep:
            return counts
        if lvl.wg_down is not None and lvl.wg_up is not None:
            conv(lvl.wg_down, lvl.wg_up, body.down_conv.kernel)
            if hasattr(body, "up_deconv"):
                conv(lvl.wg_up, lvl.wg_down, body.up_deconv.kernel)
            else:                            # the unpool: identity weights
                counts[fwd[bool(lvl.wg_up.sub)]] += reps
                if train:
                    counts[fwd[bool(lvl.wg_down.sub)]] += reps
        body, i = body.inner, i + 1


# The kernel entry points the model's routes call (tdwss_torch.ops.
# sparse_conv's names, which are also the kernels' names K1-K6).
KERNEL_ENTRIES = ("windowed_matmul_sub", "windowed_matmul",
                  "windowed_bwd_gather", "windowed_dw_sub", "windowed_dw",
                  "windowed_bwd_sub")


@contextlib.contextmanager
def patched_entries(names, make):
    """Replace each of ``names`` in tdwss_torch.ops.sparse_conv by
    ``make(name, current)`` for the enclosed block."""
    from tdwss_torch.ops import sparse_conv

    saved = {n: getattr(sparse_conv, n) for n in names}
    for n, fn in saved.items():
        setattr(sparse_conv, n, make(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(sparse_conv, n, fn)


SPLITS = {}


def kernel_split(label, fn):
    """Device time of ``fn`` (CUDA events around it) and of each kernel
    wrapper call it makes (CUDA events around each call of a
    KERNEL_ENTRIES function; the wrapper's own casts and copies are
    inside, and so is any time the device waits on the wrapper's host
    work): logs each kernel's summed ms and calls against the whole and
    returns {name: [ms, calls]} with the whole under "device"."""
    import torch

    pairs = {n: [] for n in KERNEL_ENTRIES}

    def make(name, fn):
        def timed(*args, **kwargs):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*args, **kwargs)
            ev[1].record()
            pairs[name].append(ev)
            return out
        return timed

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with patched_entries(KERNEL_ENTRIES, make):
        start.record()
        fn()
        end.record()
    end.synchronize()
    total = start.elapsed_time(end)
    split = {n: [sum(a.elapsed_time(b) for a, b in evs), len(evs)]
             for n, evs in pairs.items()}
    kern = sum(ms for ms, _ in split.values())
    log(f"device time split, {label}: {total:.3f} ms in all (CUDA events); "
        f"kernel wrapper calls {kern:.3f} ms ({kern / total:.1%}): " +
        ", ".join(f"{n} {ms:.3f} ms / {calls} calls ({ms / total:.1%})"
                  for n, (ms, calls) in split.items() if calls))
    split["device"] = [total, 1]
    SPLITS[label] = split
    return split


@contextlib.contextmanager
def record_fwd_shapes(shapes):
    """Record, for each distinct (form, C, Cout, K) that the enclosed run
    sends to K1 or K4, the arguments of its first call (plan tensors kept,
    features and weights by shape only) into ``shapes``."""
    def make(name, fn):
        def recorded(feats3, starts, *rest, **kwargs):
            if name == "windowed_matmul_sub":
                soff, rb_t, w = rest[:3]
            else:
                soff, (rb_t, w) = None, rest[:2]
            key = (name, feats3.shape[1], w.shape[2], w.shape[0])
            if key not in shapes:
                shapes[key] = dict(v_src=feats3.shape[0], starts=starts,
                                   soff=soff, rb_t=rb_t, kwargs=kwargs)
            return fn(feats3, starts, *rest, **kwargs)
        return recorded

    with patched_entries(("windowed_matmul_sub", "windowed_matmul"), make):
        yield shapes


@contextlib.contextmanager
def record_bwd_shapes(shapes):
    """Record, for each distinct (kernel, Cin, Cout, K, flip_taps,
    need_dfeats) that the enclosed run sends to K2 or K6, the plan
    tensors and geometry of its first call (features and weights by shape
    only) into ``shapes``."""
    def make(name, fn):
        def recorded(a, b, starts, soff, rb_t, wt, **kwargs):
            # K2: (dout, feats, ...); K6: (feats, dout, ...)
            k, cout, cin = wt.shape
            flip = (kwargs.get("flip_taps", True)
                    if name == "windowed_bwd_gather" else None)
            key = (name, cin, cout, k, flip, kwargs.get("need_dfeats", True))
            if key not in shapes:
                geo = {n: kwargs[n] for n in ("window", "tile", "sub",
                                              "subwin")}
                shapes[key] = dict(v_src=a.shape[0], rows=b.shape[0],
                                   starts=starts, soff=soff, rb_t=rb_t,
                                   geo=geo)
            return fn(a, b, starts, soff, rb_t, wt, **kwargs)
        return recorded

    with patched_entries(("windowed_bwd_gather", "windowed_bwd_sub"), make):
        yield shapes


@contextlib.contextmanager
def record_dw_shapes(shapes):
    """Record, for each distinct (kernel, C, Cout, K) that the enclosed
    run sends to K3 (sub form) or K5 (flat form), the plan tensors and
    geometry of its first call (features and cotangents by shape only)
    into ``shapes``, as ``record_fwd_shapes`` records K1's."""
    def make(name, fn):
        def recorded(feats3, starts, *rest, **kwargs):
            if name == "windowed_dw_sub":
                soff, rb_t, dout = rest[:3]
            else:
                soff, (rb_t, dout) = None, rest[:2]
            key = (name, feats3.shape[1], dout.shape[1], rb_t.shape[0])
            if key not in shapes:
                shapes[key] = dict(v_src=feats3.shape[0], starts=starts,
                                   soff=soff, rb_t=rb_t, kwargs=kwargs)
            return fn(feats3, starts, *rest, **kwargs)
        return recorded

    with patched_entries(("windowed_dw_sub", "windowed_dw"), make):
        yield shapes


def plain_versions():
    """Route the model's windowed evaluations, forward and backward,
    through the plain versions (for the comparison runs only)."""
    from tdwss_torch.ops import windowed as W

    return patched_entries(KERNEL_ENTRIES,
                           lambda n, fn: getattr(W, n + "_plain"))


@contextlib.contextmanager
def layer_by_layer_check(dfeats_tol, dw_tol):
    """Run every windowed conv backward of the enclosed step, and every
    windowed unpool's forward and backward, a second time through the
    plain versions on the same inputs and compare (dfeats and unpool
    outputs within ``dfeats_tol``, dW within ``dw_tol`` of max|plain|);
    yields a dict with the counts and the largest relative errors."""
    from tdwss_torch.ops import sparse_conv

    seen = {"n": 0, "unpool": 0, "dfeats": 0.0, "dw": 0.0}

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

    def wrap_identity(fn):
        # the unpools' forward and backward (identity weights, no dW)
        def checked(feats, plan):
            out = fn(feats, plan)
            with plain_versions():
                ref = fn(feats, plan)
            seen["n"] += 1
            seen["unpool"] += 1
            rel(out, ref, dfeats_tol, "dfeats",
                f"unpool V_out={out.shape[0]} C={out.shape[1]}")
            return out
        return checked

    saved = (sparse_conv._subm_w27_backward, sparse_conv._wg_backward,
             sparse_conv._identity_apply)
    sparse_conv._subm_w27_backward = wrap(saved[0])
    sparse_conv._wg_backward = wrap(saved[1])
    sparse_conv._identity_apply = wrap_identity(saved[2])
    try:
        yield seen
    finally:
        (sparse_conv._subm_w27_backward, sparse_conv._wg_backward,
         sparse_conv._identity_apply) = saved


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
    check_bodies("validate")
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
    kernel_split("validate: one rep's forward (eval_step on the rep-1 "
                 "batch)", lambda: eval_step(model, b))
    logits = eval_step(model, b)
    again = eval_step(model, b)
    with plain_versions():
        plain = eval_step(model, b)
    torch.cuda.synchronize()
    same = torch.equal(logits, again)
    log(f"validate logits, two forwards through the kernels (bf16): "
        f"bit-identical: {same}")
    if not same:
        raise AssertionError("the forward through the kernels is not "
                             "reproducible")
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


def plan_train_batch(cfg, scenes, label):
    """One training batch of ``cfg`` planned on the host (collate + plans
    + slim, timed): (planned, slimmed, seconds)."""
    import numpy as np

    from tdwss_torch.data.collate import train_collate
    from tdwss_torch.data.plans import attach_host_plans, slim_batch_for_train
    from tdwss_torch.ops.host_plan import reset_sticky_plans

    reset_sticky_plans()
    t = time.perf_counter()
    planned = attach_host_plans(
        train_collate(scenes, cfg, np.random.default_rng(0)), cfg)
    host = slim_batch_for_train(planned, cfg)
    host_s = time.perf_counter() - t
    log(f"{label}: train batch on the host (collate + plans + slim): "
        f"{host_s:.3f} s")
    for i, lvl in enumerate(host.plans.levels):
        forms = [f"{n}={'sub' if p.sub else 'flat'}/w{p.window}"
                 for n, p in (("win", lvl.win), ("down", lvl.wg_down),
                              ("up", lvl.wg_up)) if p is not None]
        log(f"{label}: level {i}: V={lvl.grid.valid.shape[0]} "
            f"valid={int(lvl.grid.valid.sum())} {' '.join(forms)}")
    return planned, host, host_s


def phase_train(label, cfg, planned, host, host_s, device, steps,
                full_checks, repro=False, loss_rtol=None, f32_loss=False):
    """``steps`` training steps of ``cfg`` on one planned batch, launches
    against the plans' routing, and one step's loss parts and
    layer-by-layer backward against the plain versions, each part held
    to its limit in ``loss_rtol`` (every part to LOSS_RTOL if not given).
    With ``f32_loss`` also an f32 step's loss parts (LOSS_RTOL_F32).
    With ``full_checks`` (the bench UNet) or ``repro`` also two bf16
    steps' gradients bit for bit; with ``full_checks`` also the f32 step
    (layer by layer, loss, gradients per tensor, bit for bit)."""
    import torch

    from tdwss_torch.data.plans import slim_batch_for_train
    from tdwss_torch.engine.steps import (compute_loss, make_optimizer,
                                          train_step)
    from tdwss_torch.models.meta_arch import build_model
    from tdwss_torch.ops import windowed as W

    t = time.perf_counter()
    batch = host.to(device)
    torch.cuda.synchronize()
    log(f"{label}: train batch to the card: {time.perf_counter() - t:.3f} s")

    model = build_model(cfg, seed=0, device=device)
    opt, sched = make_optimizer(cfg, model, STEPS_PER_EPOCH)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    W.reset_launches()
    losses, step_s, issue_s = [], [], []
    for _ in range(steps):
        t = time.perf_counter()
        loss, _ = train_step(cfg, model, opt, sched, batch)
        issue_s.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(loss)
    launches = dict(W.launches)
    check_bodies(label)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in losses]
    for i, (x, sec, iss) in enumerate(zip(losses, step_s, issue_s)):
        log(f"{label}: train step {i + 1}: loss {x:.6f}; device {sec:.3f} s "
            f"(forward + backward + Adam, ended by a synchronise), of which "
            f"{iss:.3f} s until train_step returned (the host's issue time, "
            f"with any synchronisation inside the step); host planning of "
            f"its batch {host_s:.3f} s")
    log(f"{label}: peak device memory over the steps: {peak:.2f} GiB")
    per_step = expected_launches(model, host.plans, train=True)
    want = {k: v * steps for k, v in per_step.items()}
    log(f"{label}: launches per step routed by the plans: {per_step}; in "
        f"{steps} steps: {launches}")
    if launches != want or not launches[W.K1]:
        raise AssertionError(f"{label}: training launches differ from the "
                             f"plans' routing: {launches} vs {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: non-finite training loss {losses}")
    unmoved = [n for n, p in model.named_parameters()
               if torch.equal(p.detach(), before[n])]
    if unmoved:
        raise AssertionError(f"{label}: parameters that did not move: "
                             f"{unmoved}")
    log(f"{label}: all {len(before)} parameter tensors moved over {steps} "
        f"steps")
    kernel_split(f"{label}: one warm training step",
                 lambda: train_step(cfg, model, opt, sched, batch))
    del model, opt, sched, before

    def loss_and_grads(model, c, b, ctx=contextlib.nullcontext()):
        """({loss part: value}, {parameter: gradient}) of one step."""
        model.zero_grad(set_to_none=True)
        with ctx:
            loss, aux = compute_loss(c, model, b)
            loss.backward()
        torch.cuda.synchronize()
        return ({k: float(v.detach()) for k, v in aux.items()},
                {n: p.grad.detach().float().clone()
                 for n, p in model.named_parameters()})

    def ratios(ga, gb):
        out = []
        for n in ga:
            ref = torch.linalg.vector_norm(gb[n]).item()
            diff = torch.linalg.vector_norm(ga[n] - gb[n]).item()
            out.append((diff / ref if ref > 0 else
                        (0.0 if diff == 0 else math.inf), n))
        return sorted(out, reverse=True)

    def check_loss(dtype, lk, lp, limits):
        """Each loss part through the kernels vs the plain versions,
        held to its limit in ``limits``."""
        if limits.keys() != lk.keys():
            raise AssertionError(f"{label}: loss parts {sorted(lk)} but "
                                 f"limits for {sorted(limits)}")
        for part in lk:
            rel = abs(lk[part] - lp[part]) / abs(lp[part])
            log(f"{label}: one {dtype} step's {part} through the kernels vs "
                f"the plain versions: {lk[part]:.8f} vs {lp[part]:.8f} "
                f"(relative {rel:.3g}, limit {limits[part]})")
            if not rel <= limits[part]:
                raise AssertionError(f"{label}: the {dtype} training loss "
                                     "through the kernels disagrees with "
                                     "the plain versions")

    def layer_by_layer(model, c, b, dtype, tols):
        with layer_by_layer_check(*tols) as checked:
            loss_and_grads(model, c, b)
        log(f"{label}: layer by layer, {dtype}: {checked['n']} windowed "
            f"evaluations re-run through the plain versions on the same "
            f"inputs ({checked['unpool']} of them unpools, forward and "
            f"backward); largest dfeats max|d| / max|plain| "
            f"{checked['dfeats']:.3g} (limit {tols[0]:.3g}), dW "
            f"{checked['dw']:.3g} (limit {tols[1]})")

    def f32_run():
        c32 = copy.deepcopy(cfg)
        c32.engine.compute_dtype = "float32"
        return (build_model(c32, seed=0, device=device), c32,
                slim_batch_for_train(planned, c32).to(device))

    m16 = build_model(cfg, seed=0, device=device)
    layer_by_layer(m16, cfg, batch, "bf16", (KERNEL_TOL, DW_TOL))
    lk, gk = loss_and_grads(m16, cfg, batch)
    lp, _ = loss_and_grads(m16, cfg, batch, plain_versions())
    check_loss("bf16", lk, lp, loss_rtol or dict.fromkeys(lk, LOSS_RTOL))
    if f32_loss and not full_checks:
        m32, cfg32, b32 = f32_run()
        lk32 = loss_and_grads(m32, cfg32, b32)[0]
        check_loss("f32", lk32,
                   loss_and_grads(m32, cfg32, b32, plain_versions())[0],
                   dict.fromkeys(lk32, LOSS_RTOL_F32))
        del m32, b32
    if not (full_checks or repro):
        return launches

    # bf16: two steps through the kernels, every gradient bit for bit
    # (the dW partials and the spill tiers' segmented sums add in a fixed
    # order; no switch of PyTorch's is set).
    _, gk2 = loss_and_grads(m16, cfg, batch)
    same16 = all(torch.equal(gk[n], gk2[n]) for n in gk)
    log(f"{label}: one bf16 step twice through the kernels: all "
        f"{len(gk)} gradient tensors bit-identical: {same16}")
    if not same16:
        raise AssertionError("bf16 training gradients through the kernels "
                             "are not reproducible")
    del m16, gk, gk2
    if not full_checks:
        return launches
    # f32: layer by layer, the loss, the gradients per tensor, bit for bit
    m32, cfg32, b32 = f32_run()
    layer_by_layer(m32, cfg32, b32, "f32", (KERNEL_TOL_F32, DW_TOL))
    lk, gk = loss_and_grads(m32, cfg32, b32)
    _, gk2 = loss_and_grads(m32, cfg32, b32)
    lp, gp = loss_and_grads(m32, cfg32, b32, plain_versions())
    check_loss("f32", lk, lp, dict.fromkeys(lk, LOSS_RTOL_F32))
    rs = ratios(gk, gp)
    same = all(torch.equal(gk[n], gk2[n]) for n in gk)
    log(f"{label}: one f32 step, ||g_kern - g_plain|| / ||g_plain|| over "
        f"{len(rs)} tensors (limit {GRAD_RTOL_F32}), largest: "
        + ", ".join(f"{n} {r:.3g}" for r, n in rs[:3])
        + f"; median {rs[len(rs) // 2][0]:.3g}; two runs through the "
        f"kernels bit-identical: {same}")
    if not (rs[0][0] <= GRAD_RTOL_F32 and same):
        raise AssertionError("f32 training gradients through the kernels "
                             "disagree with the plain versions or are not "
                             "reproducible")
    return launches


def text_config():
    """``configs/3DUNetWithText_scannet_fcnet.yaml`` cut to the bench
    batch (5 scenes in 786,432 points for its 8 in 2,097,152)."""
    from tdwss_torch.config import load_config

    return cut_to_bench_batch(load_config(os.path.join(HERE, "configs",
                                                       TEXT_CONFIG)))


def phase_text(scenes, device):
    """The text path: tokenizing one batch on the host (timed), the train
    batch planned, TEXT_STEPS training steps through ``phase_train``
    (launches against the plans' routing, tensor-core bodies, layer by
    layer and the loss parts against the plain versions, the text loss
    and total at TEXT_LOSS_RTOL, bf16 gradients bit for bit, every
    parameter moved, the text tower's included, and an f32 step's loss
    parts against the plain versions), TEXT_LOSS_RTOL against more seeds
    and a planted fault (``check_text_loss_limit``), then the text parts
    against the CPU (``check_text_parts``).  Returns the launches."""
    from tdwss_torch.data.collate import collate_text

    cfg = text_config()
    t = time.perf_counter()
    text = collate_text(scenes, cfg)
    tok_s = time.perf_counter() - t
    used = (text.tokens != 0).any(-1).sum(-1)
    log(f"Text: tokenizing {int(used.sum())} descriptions of {len(scenes)} "
        f"scenes into {tuple(text.tokens.shape)} int32 ids (vocab "
        f"{cfg.text_model.vocab_size}) on the host: {tok_s:.4f} s per "
        f"batch; slots used per scene {used.tolist()} of "
        f"{cfg.text_data.cropped_texts}")
    if not (used.min() > 0 and used.max() < cfg.text_data.cropped_texts):
        raise AssertionError("Text: the batch should fill some slots of "
                             "every scene and leave some empty")
    planned, host, host_s = plan_train_batch(cfg, scenes, "Text")
    launches = phase_train("Text", cfg, planned, host, host_s, device,
                           TEXT_STEPS, full_checks=False, repro=True,
                           loss_rtol={"cls_loss": LOSS_RTOL,
                                      "text_loss": TEXT_LOSS_RTOL,
                                      "loss": TEXT_LOSS_RTOL},
                           f32_loss=True)
    del planned
    check_text_loss_limit(cfg, host, device)
    check_text_parts(cfg, host, device)
    return launches


def check_text_loss_limit(cfg, host, device):
    """TEXT_LOSS_RTOL between sound readings and a fault: the bf16 text
    loss and total through the kernels vs the plain versions for the
    models of seed 0 and TEXT_LOSS_SEEDS, each within the limit, and for
    seed 0 with a planted K1 fault (tap 0 of the weight zeroed in the
    forward's first launch only) beyond it."""
    import torch

    from tdwss_torch.engine.steps import compute_loss
    from tdwss_torch.models.meta_arch import build_model

    batch = host.to(device)
    held = ("text_loss", "loss")

    def parts(model, ctx):
        with torch.no_grad(), ctx:
            _, aux = compute_loss(cfg, model, batch)
        return {k: float(aux[k]) for k in held}

    def rel(a, b):
        return max(abs(a[k] - b[k]) / abs(b[k]) for k in held)

    calls = []

    def tap0_first(name, fn):
        w_at = 4 if name == "windowed_matmul_sub" else 3

        def faulted(*args, **kwargs):
            calls.append(name)
            if len(calls) == 1:
                args = list(args)
                args[w_at] = args[w_at].clone()
                args[w_at][0] = 0
            return fn(*args, **kwargs)
        return faulted

    sound = []
    for seed in (0,) + TEXT_LOSS_SEEDS:
        model = build_model(cfg, seed=seed, device=device)
        plain = parts(model, plain_versions())
        sound.append(rel(parts(model, contextlib.nullcontext()), plain))
        if seed == 0:
            with patched_entries(("windowed_matmul_sub", "windowed_matmul"),
                                 tap0_first):
                fault = rel(parts(model, contextlib.nullcontext()), plain)
        del model
    log(f"Text: bf16 text loss and total through the kernels vs the plain "
        f"versions, largest relative difference, model seeds 0-"
        f"{TEXT_LOSS_SEEDS[-1]}: " + ", ".join(f"{r:.4g}" for r in sound)
        + f" (limit {TEXT_LOSS_RTOL}); seed 0 with tap 0 of the weight "
        f"zeroed in the first of the forward's {len(calls)} K1 launches: "
        f"{fault:.4g} (must exceed the limit)")
    if not (max(sound) <= TEXT_LOSS_RTOL < fault):
        raise AssertionError("Text: TEXT_LOSS_RTOL does not lie between the "
                             "sound readings and the planted fault")


def check_text_parts(cfg, host, device):
    """On one seeded model of ``cfg``: the text tower's features,
    ``TextContrastive``'s value and the text mask on the card against the
    same weights and inputs on the CPU (f32, TEXT_TOL); the tower's
    forward and backward ms by CUDA events and their share of a warm
    step; the tower's device activities (torch.profiler); no
    synchronising call in a warm text ``train_step``."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tdwss_torch.engine.steps import (make_optimizer, text_mask,
                                          train_step)
    from tdwss_torch.models.meta_arch import build_model
    from tdwss_torch.utils.losses import TextContrastive

    batch = host.to(device)
    model = build_model(cfg, seed=0, device=device)
    tokens = batch.text.tokens
    bt, nt, length = tokens.shape

    def tower(enc, lin, tok):
        return lin(enc(tok.reshape(-1, length)).reshape(bt, nt, -1))

    with torch.no_grad():
        _, (gfeats, tfeats, has_text) = model(batch, istrain=True)
        feats = model.text_encoder(tokens.reshape(-1, length))
        loss = TextContrastive(gfeats, tfeats, has_text, text_mask(batch.text),
                               batch.scene_mask)
        mask = text_mask(batch.text)
        enc = copy.deepcopy(model.text_encoder).cpu()
        lin = copy.deepcopy(model.text_linear).cpu()
        cpu_tok = torch.from_numpy(host.text.tokens)
        cpu_feats = enc(cpu_tok.reshape(-1, length))
        cpu_tf = tower(enc, lin, cpu_tok)
        cpu_loss = TextContrastive(
            gfeats.cpu(), cpu_tf, torch.from_numpy(host.text.has_text),
            text_mask(host.text.to("cpu")),
            torch.from_numpy(host.scene_mask))
    with torch.no_grad(), plain_versions():
        _, (plain_g, plain_tf, _) = model(batch, istrain=True)
    sims = torch.einsum("btm,cm->btc", tfeats, gfeats)
    plain_sims = torch.einsum("btm,cm->btc", plain_tf, plain_g)
    dg = ((gfeats - plain_g).abs().max() / plain_g.abs().max()).item()
    log(f"Text: bf16 pooled scene features {tuple(gfeats.shape)} through "
        f"the kernels vs the plain versions: max|d| / max|plain| {dg:.3g}"
        f"; text feature norm {tfeats.norm(dim=-1).mean().item():.4g}; "
        f"text-scene similarities {plain_sims.min().item():.4g} .. "
        f"{plain_sims.max().item():.4g}, max|d| "
        f"{(sims - plain_sims).abs().max().item():.4g} (see "
        f"TEXT_LOSS_RTOL)")
    want_mask = host.text.valid[:, None] & (host.text.tokens != 0).any(-1)
    err = (feats.cpu() - cpu_feats).abs().max().item()
    scale = cpu_feats.abs().max().item()
    rel = abs(loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    same_mask = np.array_equal(mask.cpu().numpy(), want_mask)
    log(f"Text: tower features {tuple(feats.shape)} on the card vs the "
        f"same weights on the CPU (f32): max|d| {err:.3g} (limit "
        f"{TEXT_TOL} * {scale:.4g}); TextContrastive {loss.item():.8f} vs "
        f"{cpu_loss.item():.8f} (relative {rel:.3g}, limit {TEXT_TOL}); "
        f"text mask ({int(want_mask.sum())} of {want_mask.size} slots) "
        f"equal: {same_mask}")
    if not (err <= TEXT_TOL * scale and rel <= TEXT_TOL and same_mask):
        raise AssertionError("Text: the text parts on the card disagree "
                             "with the CPU")
    del enc, lin, cpu_feats, cpu_tf

    gen = torch.Generator(device=device).manual_seed(5)
    cot = torch.randn(tfeats.shape, generator=gen, device=device)
    fwd, bwd = [], []

    def fwd_bwd():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        out = tower(model.text_encoder, model.text_linear, tokens)
        ev[1].record()
        (out * cot).sum().backward()
        ev[2].record()
        return ev

    for i in range(TEXT_TIMED + 1):
        model.zero_grad(set_to_none=True)
        ev = fwd_bwd()
        ev[2].synchronize()
        if i:
            fwd.append(ev[0].elapsed_time(ev[1]))
            bwd.append(ev[1].elapsed_time(ev[2]))
    model.zero_grad(set_to_none=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fwd_bwd()
        torch.cuda.synchronize()
    activities = sum(1 for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and not e.is_user_annotation)
    step_ms = SPLITS["Text: one warm training step"]["device"][0]
    f_ms, b_ms = statistics.median(fwd), statistics.median(bwd)
    log(f"Text: text tower ({cfg.text_model.layers} layers, width "
        f"{cfg.text_model.width}, {bt * nt} sequences x {length} tokens, "
        f"f32) + text_linear: forward {f_ms:.3f} ms, backward {b_ms:.3f} ms "
        f"(median of {TEXT_TIMED}, CUDA events); {f_ms + b_ms:.3f} ms = "
        f"{(f_ms + b_ms) / step_ms:.1%} of a warm text step's "
        f"{step_ms:.3f} ms; {activities} device activities per forward + "
        f"backward (torch.profiler)")
    opt, sched = make_optimizer(cfg, model, STEPS_PER_EPOCH)
    for _ in range(2):
        train_step(cfg, model, opt, sched, batch)
    syncs = list_syncs(lambda: train_step(cfg, model, opt, sched, batch))
    log(f"Text: synchronising calls in one warm text train_step: "
        f"{len(syncs)} sites: {json.dumps(syncs)}")
    if syncs:
        raise AssertionError("the text train_step synchronises with the "
                             "host")


def list_syncs(fn):
    """Run ``fn`` with ``torch.cuda.set_sync_debug_mode("warn")`` and
    return {"[thread] file:line <- caller <- ...": count} of every
    synchronising call it made (the innermost frames, the warning's own
    and the warnings module's dropped; repository paths relative)."""
    import threading
    import traceback
    import warnings

    import torch

    seen = {}

    def short(path):
        return (os.path.relpath(path, HERE) if path.startswith(HERE)
                else "/".join(path.split("/")[-3:]))

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if not f.filename.endswith("warnings.py")]
        where = (f"[{threading.current_thread().name}] "
                 + " <- ".join(f"{short(f.filename)}:{f.lineno}"
                               for f in reversed(frames[-8:]))
                 + f" (warned at {short(filename)}:{lineno})")
        seen[where] = seen.get(where, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        # switching the mode on warns once by itself: record only fn's
        torch.cuda.set_sync_debug_mode("warn")
        warnings.showwarning = record
        try:
            fn()
        finally:
            warnings.showwarning = lambda *a, **k: None
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return seen


# Device-time categories of the profile phase: record_function scopes put
# around the forward's parts (by patching), and the scopes PyTorch itself
# records (the optimiser's step, autograd's backward functions).
_OUR_KERNELS = ("windowed_", "fwd_mma_kernel", "dw_mma_kernel",
                "reduce_partials_kernel", "block_gather_kernel")


def _category(event, kernel_name):
    if any(k in kernel_name for k in _OUR_KERNELS):
        return "hand-written kernels (K1-K7)"
    e = event
    while e is not None:
        name = e.name
        if name.startswith("smoke:"):
            return name[len("smoke:"):]
        if name.startswith("Optimizer.step") or "_foreach_" in name:
            return "Adam"
        if name.startswith("Optimizer.zero_grad"):
            return "zero_grad"
        e = e.cpu_parent
    name = event.name
    if name in ("aten::copy_", "aten::_to_copy", "aten::to"):
        return "casts and copies (elsewhere)"
    e = event
    while e is not None:
        if "evaluate_function" in e.name or "Backward" in e.name:
            return "backward, other ops"
        e = e.cpu_parent
    return "forward, other ops"


@contextlib.contextmanager
def profile_scopes():
    """Wrap the forward's batch norms, the spill tiers' segmented sums,
    the conv routes' backward functions and the kernel wrappers in
    record_function scopes named ``smoke:<category>``."""
    import torch

    from tdwss_torch.models import layers
    from tdwss_torch.ops import sparse_conv

    def scoped(fn, label):
        def inner(*a, **kw):
            with torch.profiler.record_function("smoke:" + label):
                return fn(*a, **kw)
        return inner

    targets = [(layers.MaskedBatchNorm, "forward", "batch norm forward"),
               (sparse_conv, "_segment_sum", "spill tiers' segmented sums"),
               (sparse_conv, "_subm_w27_backward",
                "conv backward around the kernels"),
               (sparse_conv, "_wg_backward",
                "conv backward around the kernels")]
    targets += [(sparse_conv, n, "kernel wrappers' own ops")
                for n in KERNEL_ENTRIES]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in targets]
    for obj, name, label in targets:
        setattr(obj, name, scoped(getattr(obj, name), label))
    try:
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def phase_profile(cfg, host, device, trace_dir):
    """One warm UNet training step: the synchronising calls it makes
    (sync debug mode), then a torch.profiler trace of another
    (``tdwss_torch.utils.profiling.trace``): the top device operations by
    total time, the device's idle share over the traced window, and the
    device time by category.  Returns (syncs, summary)."""
    import torch
    from torch.autograd import DeviceType

    from tdwss_torch.engine.steps import make_optimizer, train_step
    from tdwss_torch.models.meta_arch import build_model
    from tdwss_torch.utils import profiling

    batch = host.to(device)
    model = build_model(cfg, seed=0, device=device)
    opt, sched = make_optimizer(cfg, model, STEPS_PER_EPOCH)

    def step():
        return train_step(cfg, model, opt, sched, batch)

    for _ in range(2):
        step()
    syncs = list_syncs(step)
    log(f"profile: synchronising calls in one warm UNet train_step "
        f"(set_sync_debug_mode('warn')): {len(syncs)} sites, "
        f"{sum(syncs.values())} calls: {json.dumps(syncs)}")
    if syncs:
        raise AssertionError("train_step synchronises with the host")
    # the same step untraced: device time between CUDA events, and the
    # host's time until train_step returns (it does not wait)
    torch.cuda.synchronize()
    ev = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
    t = time.perf_counter()
    ev[0].record()
    step()
    issue_s = time.perf_counter() - t
    ev[1].record()
    ev[1].synchronize()
    step_ms = ev[0].elapsed_time(ev[1])
    log(f"profile: one warm UNet step untraced: {step_ms:.3f} ms between "
        f"CUDA events, train_step returned after {issue_s * 1e3:.3f} ms")
    torch.cuda.synchronize()
    with profile_scopes(), profiling.trace(trace_dir,
                                           "trace.json.gz") as prof:
        step()
        torch.cuda.synchronize()
    events = prof.events()
    # device activity: kernels, copies and sets (the record_function
    # ranges mirrored on the device timeline are not activity)
    device_ev = [e for e in events if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation
                 and not e.name.startswith("smoke:")]
    if not device_ev:
        raise AssertionError("the profiler recorded no device activity")
    lo = min(e.time_range.start for e in events)
    hi = max(e.time_range.end for e in events)
    spans = sorted((e.time_range.start, e.time_range.end) for e in device_ev)
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    window = hi - lo
    by_name = {}
    for e in device_ev:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                           n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    cats, attributed = {}, 0.0
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        for k in e.kernels:
            c = _category(e, k.name)
            cats[c] = cats.get(c, 0.0) + k.duration / 1e3
            attributed += k.duration / 1e3
    total_dev = sum(ms for ms, _ in by_name.values())
    cats["not attributed to a host op"] = total_dev - attributed
    summary = {"window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
               "idle_share": 1.0 - busy / window,
               "untraced_step_ms": step_ms,
               # an estimate across two steps: the traced step's busy
               # time over the untraced step's time between events
               "idle_share_untraced_est": 1.0 - busy / 1e3 / step_ms,
               "device_activities": len(device_ev),
               "device_ms_summed": total_dev,
               "by_category_ms": dict(sorted(cats.items(),
                                             key=lambda kv: -kv[1])),
               "top_ops": [[n[:90], round(ms, 4), c] for n, (ms, c) in top]}
    log(f"profile: one warm UNet step traced ({len(device_ev)} device "
        f"activities: kernels, copies, sets): window {window / 1e3:.3f} ms, "
        f"device busy {busy / 1e3:.3f} ms, idle share "
        f"{1.0 - busy / window:.4f} of the traced window (the profiler "
        f"slows the host); estimated {1.0 - busy / 1e3 / step_ms:.4f} of "
        f"the untraced step's {step_ms:.3f} ms (the traced step's busy "
        f"time over the other step's time)")
    log("profile: device ms by category: "
        + json.dumps(summary["by_category_ms"]))
    log("profile: top device operations by total ms [name, ms, count]: "
        + json.dumps(summary["top_ops"]))
    del model, opt, sched, batch
    return syncs, summary


def phase_unpool_times(plans, planes, device, gen):
    """K1's time on the identity unpools of a planned FCN batch: the
    forward (up plan) and backward (down plan) of each level's unpool, at
    the width it carries, timed in bf16 (5 CUDA-event launches)."""
    import torch

    from tdwss_torch.ops import windowed as W

    for i in range(len(plans.levels) - 1):
        lvl = plans.levels[i]
        if lvl.wg_up is None or lvl.wg_down is None:
            continue
        c = sum(planes[i + 1:])
        for direction, plan in (("forward", lvl.wg_up),
                                ("backward", lvl.wg_down)):
            v_src = plan.v_src
            starts = torch.from_numpy(plan.starts).to(device)
            if starts.dim() == 1:
                starts = starts[:, None]
            rb = torch.from_numpy(plan.rb_local.astype("int32")).to(device)
            tile = rb.shape[0] // starts.shape[0]
            soff = (torch.from_numpy(plan.sub_off).to(device).reshape(-1)
                    if plan.sub else None)
            x = torch.randn((v_src, c), generator=gen).to(device,
                                                          torch.bfloat16)
            eye = torch.eye(c, dtype=torch.bfloat16, device=device).expand(
                rb.shape[1], c, c)
            if plan.sub:
                def run():
                    return W.windowed_matmul_sub(
                        x, starts.reshape(-1), soff, rb.t(), eye,
                        plan.window, tile, plan.sub, plan.subwin)
                work = W.work(x, starts.reshape(-1), soff, rb.t(), eye, tile,
                              plan.sub, plan.subwin)
            else:
                def run():
                    return W.windowed_matmul(x, starts.reshape(-1), rb.t(),
                                             eye, plan.window, tile)
                work = W.work(x, starts.reshape(-1), None, rb.t(), eye, tile,
                              0, plan.window)
            ms = cuda_time_ms(run, iters=5, warmup=1)
            bound = max(work[0] / HBM_BYTES_PER_S, work[1] / BF16_FLOPS_PER_S)
            log(f"unpool level {i + 1} -> {i} {direction} ("
                f"{'K1' if plan.sub else 'K4'}, identity weights): "
                f"V_src={v_src} V_out={rb.shape[0]} C={c}: {ms:.4f} ms "
                f"(median of 5), bound {bound * 1e3:.4f} ms ({work[0]} B, "
                f"{work[1]} live flop)")
            del x, eye


def ragged_case(device, gen):
    """A sub-form plan no path builds, for the edges of K1's tiling:
    V_out = 1,000 (not a multiple of 64) in tiles of 40 rows, sub-windows
    of 8 rows, C = 24 (a part-filled channel chunk), Cout = 36 (not a
    multiple of 8), rb as a contiguous (K, V_out) array (the Pallas
    layout), its first 64 rows all sentinels, and sources past both ends
    of x."""
    import torch

    v_out, v_src, k, tile, sub, window, subwin = 1000, 1200, 27, 40, 8, 64, 16
    starts = torch.randint(-8, v_src - 32, (v_out // tile,), generator=gen,
                           dtype=torch.int32)
    soff = torch.randint(0, window - subwin + 1, (v_out // sub,),
                         generator=gen, dtype=torch.int32)
    rb = torch.randint(0, subwin + 1, (k, v_out), generator=gen,
                       dtype=torch.int32)
    rb[:, :64] = subwin
    return (("windowed_matmul_sub", 24, 36, k),
            dict(v_src=v_src, starts=starts.to(device), soff=soff.to(device),
                 rb_t=rb.to(device),
                 kwargs=dict(window=window, tile=tile, sub=sub,
                             subwin=subwin)))


def flat_locals(a, k):
    """The sub-form locals of a recorded K1 call as flat-form (K4) locals
    on the same windows: rb + the row's sub-window offset, a sentinel as
    ``window``; (K, V_out) like ``a["rb_t"]``."""
    import torch

    kw = a["kwargs"]
    rb = a["rb_t"]
    v_out = rb.shape[1]
    nwin = a["starts"].numel() // (v_out // kw["tile"])
    g = torch.arange(k, device=rb.device) % nwin
    big = a["soff"].reshape(-1, nwin).repeat_interleave(kw["sub"], dim=0)
    big = big[:, g].t()
    dead = (rb < 0) | (rb >= kw["subwin"])
    return torch.where(dead, torch.full_like(rb, kw["window"]),
                       rb + big).to(torch.int32).contiguous()


def phase_fwd_sweep(shapes, device, gen):
    """K1 / K4 at every distinct (form, C, Cout, K) of ``shapes`` (what the
    paths sent them, on the paths' own windows) and at ``ragged_case``,
    on seeded random features and weights, against the plain versions in
    bf16 (KERNEL_TOL) and f32 (KERNEL_TOL_F32), each launch on the body
    its dtype selects (bf16: the tensor cores); K4 on the same windows in
    the flat form bit for bit equal to K1 in bf16; one line per shape
    with the bf16 time (CUDA events) and the bound."""
    import torch

    from tdwss_torch.ops import windowed as W

    cases = sorted(shapes.items(), key=lambda kv: kv[0])
    cases.append(ragged_case(device, gen))
    for (name, c, cout, k), a in cases:
        sub = name == W.K1
        fn = getattr(W, name)
        plain = getattr(W, name + "_plain")
        kw = a["kwargs"]
        plan = ((a["starts"], a["soff"], a["rb_t"]) if sub
                else (a["starts"], a["rb_t"]))
        x = torch.randn((a["v_src"], c), generator=gen).to(device)
        w = (torch.randn((k, c, cout), generator=gen)
             * (2.0 / (k * c)) ** 0.5).to(device)
        v_out = a["rb_t"].shape[1]
        label = (f"{'sub' if sub else 'flat'} V_src={a['v_src']} "
                 f"V_out={v_out} C={c} Cout={cout} K={k}")
        for dtype, tol in ((torch.bfloat16, KERNEL_TOL),
                           (torch.float32, KERNEL_TOL_F32)):
            xd, wd = x.to(dtype), w.to(dtype)
            body = W.fwd_tile(c, cout, k, dtype)["body"]
            before = W.body_launches[f"{name}:{body}"]
            out, ref = fn(xd, *plan, wd, **kw), plain(xd, *plan, wd, **kw)
            torch.cuda.synchronize()
            if W.body_launches[f"{name}:{body}"] != before + 1 or (
                    dtype == torch.bfloat16 and body != W.BODY_MMA):
                raise AssertionError(f"sweep {label}: {dtype} did not take "
                                     f"its body")
            check_against_plain(name, out, ref, f"sweep {label} "
                                f"{str(dtype)[6:]}", tol)
            if sub and dtype == torch.bfloat16:
                # K4 on the same windows in the flat form: the same bits
                flat = W.windowed_matmul(xd, a["starts"],
                                         flat_locals(a, k), wd,
                                         kw["window"], kw["tile"])
                if not torch.equal(flat, out):
                    raise AssertionError(f"sweep {label}: K4 differs from K1 "
                                         "on the same windows")
                del flat
            del out, ref
        x16, w16 = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ms = cuda_time_ms(lambda: fn(x16, *plan, w16, **kw), iters=5,
                          warmup=1, window=BACK_TO_BACK)
        sentinel = kw["subwin"] if sub else kw["window"]
        nbytes, flops = W.work(
            x16, a["starts"], a["soff"] if sub else None, a["rb_t"], w16,
            kw["tile"], kw.get("sub", 0), sentinel)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
        log(f"sweep {name}: {label}: bf16 {ms:.4f} ms (median of 5 of "
            f"{BACK_TO_BACK} back to back), bound {bound:.4f} ms ({nbytes} B, "
            f"{flops} flop)")
        del x, w, x16, w16
    return len(cases)


def phase_bwd_sweep(shapes, device, gen):
    """K2 and K6 at every distinct (kernel, Cin, Cout, K, flip_taps,
    need_dfeats) of ``shapes`` (what the paths sent them, on the paths'
    own plans), on seeded random cotangents, features and weights,
    against the plain versions in bf16 (dfeats KERNEL_TOL) and f32
    (KERNEL_TOL_F32), dW within DW_TOL; each launch on the body its
    dtype selects (bf16: the tensor cores), two launches bit for bit
    equal; one line per shape with the bf16 time (CUDA events, samples of
    BACK_TO_BACK calls) and the bound.  Returns {key: (ms, bound_ms)}."""
    import torch

    from tdwss_torch.ops import windowed as W

    times = {}
    for key, a in sorted(shapes.items(), key=lambda kv: str(kv[0])):
        name, cin, cout, k, flip, need = key
        k2 = name == W.K2
        v_out = a["rb_t"].shape[1]
        dout = torch.randn((a["v_src"] if k2 else a["rows"], cout),
                           generator=gen).to(device)
        feats = torch.randn((a["rows"] if k2 else a["v_src"], cin),
                            generator=gen).to(device)
        wt = (torch.randn((k, cout, cin), generator=gen)
              * (2.0 / (k * cout)) ** 0.5).to(device)
        plan = (a["starts"], a["soff"], a["rb_t"])
        kw = dict(a["geo"], need_dfeats=need)
        if k2:
            kw["flip_taps"] = flip

        def call(fn, dt):
            d, f, w = dout.to(dt), feats.to(dt), wt.to(dt)
            return (fn(d, f, *plan, w, **kw) if k2
                    else fn(f, d, *plan, w, **kw))

        fn, plain = getattr(W, name), getattr(W, name + "_plain")
        label = (f"V_src={a['v_src']} V_out={v_out} Cin={cin} Cout={cout} "
                 f"K={k}" + (f" flip_taps={flip}" if k2 else "")
                 + f" need_dfeats={need}")
        for dtype, tol in ((torch.bfloat16, KERNEL_TOL),
                           (torch.float32, KERNEL_TOL_F32)):
            body = W.bwd_tile(name, cin, cout, k, dtype)["body"]
            before = W.body_launches[f"{name}:{body}"]
            (dx, dw), (pdx, pdw) = call(fn, dtype), call(plain, dtype)
            dx2, dw2 = call(fn, dtype)
            torch.cuda.synchronize()
            if W.body_launches[f"{name}:{body}"] != before + 2 or (
                    dtype == torch.bfloat16 and body != W.BODY_MMA):
                raise AssertionError(f"sweep {name} {label}: {dtype} did "
                                     "not take its body")
            lab = f"sweep {label} {str(dtype)[6:]}"
            if need:
                check_against_plain(name, dx, pdx, f"dfeats {lab}", tol)
            check_against_plain(name, dw, pdw, f"dW {lab}", DW_TOL)
            if not (torch.equal(dw, dw2) and (dx is None
                                              or torch.equal(dx, dx2))):
                raise AssertionError(f"sweep {name} {label}: two launches "
                                     "differ")
            del dx, dw, pdx, pdw, dx2, dw2
        d16, f16, w16 = (dout.to(torch.bfloat16), feats.to(torch.bfloat16),
                         wt.to(torch.bfloat16))
        ms = cuda_time_ms(lambda: call(fn, torch.bfloat16), iters=5,
                          warmup=1, window=BACK_TO_BACK)
        work = W.work_bwd_gather if k2 else W.work_bwd_sub
        nbytes, flops = (work(d16, f16, *plan, w16, a["geo"]["tile"],
                              a["geo"]["sub"], a["geo"]["subwin"], need)
                         if k2 else
                         work(f16, d16, *plan, w16, a["geo"]["tile"],
                              a["geo"]["sub"], a["geo"]["subwin"], need))
        bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
        log(f"sweep {name}: {label}: bf16 {ms:.4f} ms (median of 5 of "
            f"{BACK_TO_BACK} back to back), bound {bound:.4f} ms ({nbytes} B, "
            f"{flops} flop); tile {W.bwd_tile(name, cin, cout, k, torch.bfloat16)}")
        times[key] = (ms, bound)
        del dout, feats, wt, d16, f16, w16
    return times


def phase_dw_sweep(shapes, device, gen):
    """K3 / K5 at every distinct (kernel, C, Cout, K) of ``shapes`` (what
    the paths sent them, on the paths' own plans), on seeded random
    features and cotangents, against the plain versions in bf16 and f32
    within DW_TOL; each launch on the body its dtype selects (bf16: the
    tensor cores, f32: the CUDA cores), two launches bit for bit equal;
    for each sub-form plan also K5 on the same windows in the flat form
    (``flat_locals``), against its plain version and bit for bit equal to
    K3 in bf16.  One line per shape with the bf16 times (CUDA events,
    samples of BACK_TO_BACK calls) and the bound.  Returns {label:
    (ms, bound_ms)}, K5's flat runs under their own label."""
    import torch

    from tdwss_torch.ops import windowed as W

    times = {}
    for (name, c, cout, k), a in sorted(shapes.items(), key=lambda kv: kv[0]):
        kw = a["kwargs"]
        v_out = a["rb_t"].shape[1]
        x = torch.randn((a["v_src"], c), generator=gen).to(device)
        dout = torch.randn((v_out, cout), generator=gen).to(device)
        sub = a["soff"] is not None
        runs = [(name, (a["starts"], a["soff"], a["rb_t"]) if sub
                 else (a["starts"], a["rb_t"]), kw,
                 kw["subwin"] if sub else kw["window"])]
        if name == W.K3:
            runs.append((W.K5, (a["starts"], flat_locals(a, k)),
                         dict(window=kw["window"], tile=kw["tile"]),
                         kw["window"]))
        label = (f"V_src={a['v_src']} V_out={v_out} C={c} Cout={cout} "
                 f"K={k}")
        outs = {}
        for kern, plan, kwk, _ in runs:
            fn, plain = getattr(W, kern), getattr(W, kern + "_plain")
            form = "sub" if len(plan) == 3 else "flat"
            for dtype in (torch.bfloat16, torch.float32):
                xd, dd = x.to(dtype), dout.to(dtype)
                body = W.bwd_tile(kern, c, cout, k, dtype)["body"]
                want = W.BODY_MMA if dtype == torch.bfloat16 else W.BODY_FMA
                before = W.body_launches[f"{kern}:{body}"]
                out = fn(xd, *plan, dd, **kwk)
                ref = plain(xd, *plan, dd, **kwk)
                out2 = fn(xd, *plan, dd, **kwk)
                torch.cuda.synchronize()
                if body != want or (W.body_launches[f"{kern}:{body}"]
                                    != before + 2):
                    raise AssertionError(f"sweep {kern} {label}: {dtype} did "
                                         "not take its body")
                check_against_plain(kern, out, ref, f"dW sweep {form} {label} "
                                    f"{str(dtype)[6:]}", DW_TOL)
                if not torch.equal(out, out2):
                    raise AssertionError(f"sweep {kern} {label}: two launches "
                                         "differ")
                outs[(kern, dtype)] = out
                del ref, out2
        if name == W.K3:
            same, same32 = (torch.equal(outs[(W.K3, dt)], outs[(W.K5, dt)])
                            for dt in (torch.bfloat16, torch.float32))
            log(f"dW sweep {label}: K5 (flat form) vs K3 (sub form) on the "
                f"same windows: bit-identical in bf16: {same}, in f32: "
                f"{same32}")
            if not same:
                raise AssertionError(f"dW sweep {label}: K5 differs from K3 "
                                     "on the same windows")
        del outs
        x16, d16 = x.to(torch.bfloat16), dout.to(torch.bfloat16)
        for kern, plan, kwk, sentinel in runs:
            fn = getattr(W, kern)
            ms = cuda_time_ms(lambda: fn(x16, *plan, d16, **kwk), iters=5,
                              warmup=1, window=BACK_TO_BACK)
            soff = plan[1] if len(plan) == 3 else None
            nbytes, flops = W.work_dw(
                x16, plan[0], soff, plan[-1], d16, kw["tile"],
                kw["sub"] if soff is not None else 0, sentinel)
            bound = max(nbytes / HBM_BYTES_PER_S,
                        flops / BF16_FLOPS_PER_S) * 1e3
            form = "sub" if soff is not None else "flat"
            log(f"dW sweep {kern}: {form} {label}: bf16 {ms:.4f} ms (median "
                f"of 5 of {BACK_TO_BACK} back to back), bound {bound:.4f} ms "
                f"({nbytes} B, {flops} flop); tile "
                f"{W.bwd_tile(kern, c, cout, k, torch.bfloat16)}")
            times[f"{kern} {form} {c}->{cout} K={k} V_out={v_out}"] = (ms,
                                                                      bound)
        del x, dout, x16, d16
    return times


def halo_face_index(plan):
    """K7's index for the brick tensor viewed as (B * S, S, S * C) x-slabs:
    for every occupied brick, the low x-face (slab 0) of its dx = +1
    neighbour and the high x-face (slab S - 1) of its dx = -1 neighbour,
    padded to a multiple of 32; an absent neighbour (B) and the padding
    point past the end, where the gather clips them."""
    import numpy as np

    from tdwss_torch.ops.experimental.brick_plan import _NEIGHBOR_OFFSETS

    s = plan.size
    kept = min(plan.num_bricks, plan.neighbors.shape[0])
    offs = [tuple(o) for o in _NEIGHBOR_OFFSETS.tolist()]
    up = plan.neighbors[:kept, offs.index((1, 0, 0))].astype(np.int64)
    down = plan.neighbors[:kept, offs.index((-1, 0, 0))].astype(np.int64)
    idx = np.stack([up * s, down * s + s - 1], axis=1).reshape(-1)
    pad = -len(idx) % 32
    end = plan.neighbors.shape[0] * s
    return np.concatenate([idx, np.full(pad, end)]).astype(np.int32)


def phase_brick(batch, device, gen):
    """The experimental brick engine on the level-0 grid of the bench
    batch (rebuilt from its points: the collate keeps only the plans'
    scene column).  The path (launch counts set to 0 just before and
    read just after): the host brick plan, ``brick_subm_conv`` at
    BRICK_C -> BRICK_C in bf16, and the halo-face gather through
    ``gather_blocks`` (K7).  Then the checks and times: the brick conv
    against the windowed ``subm_conv_apply`` (K1 route) in bf16 and f32,
    and K7 against its plain version at that shape and at the reference
    test's.  Returns (K7's row, the path's launches)."""
    import numpy as np
    import torch

    from tdwss_torch.ops import windowed as W
    from tdwss_torch.ops.experimental import block_gather as BG
    from tdwss_torch.ops.experimental.brick_conv import (_fill_bricks,
                                                         _halo_pad,
                                                         brick_subm_conv,
                                                         plan_to)
    from tdwss_torch.ops.experimental.brick_plan import (build_brick_plan,
                                                         reset_brick_caps)
    from tdwss_torch.ops.host_plan import voxelize_np
    from tdwss_torch.ops.sparse_conv import subm_conv_apply

    level0 = batch.plans.levels[0]
    v = level0.grid.valid.shape[0]
    grid, _, _ = voxelize_np(batch.coords, None, batch.valid, v)
    if not np.array_equal(np.asarray(grid.valid),
                          np.asarray(level0.grid.valid)):
        raise AssertionError("the rebuilt level-0 grid is not the plans'")
    c = BRICK_C
    x32 = torch.randn((v, c), generator=gen).to(device)
    w = (torch.randn((27, c, c), generator=gen) * (2.0 / (27 * c)) ** 0.5
         ).to(device)
    x16 = x32.to(torch.bfloat16)

    reset_brick_caps()
    torch.cuda.synchronize()
    W.reset_launches()
    BG.reset_launches()
    t = time.perf_counter()
    plan = build_brick_plan(grid)
    plan_s = time.perf_counter() - t
    dplan = plan_to(plan, device)
    y16 = brick_subm_conv(x16, dplan, w)
    # (B, x, y, z, C) bricks as (B * S, S, S * C): one x-slab per block
    src = _fill_bricks(x16, dplan).reshape(-1, plan.size, plan.size * c)
    idx = torch.from_numpy(halo_face_index(plan)).to(device)
    faces = BG.gather_blocks(src, idx)
    torch.cuda.synchronize()
    launches = {**W.launches, **BG.launches}
    cap = plan.neighbors.shape[0]
    kept = min(plan.num_bricks, cap)
    nvalid = int(np.asarray(grid.valid).sum())
    log(f"brick engine: host brick plan of level 0 (V={v}, {nvalid} valid "
        f"voxels): {plan_s:.3f} s; {plan.num_bricks} bricks of "
        f"{plan.size}^3, capacity {cap}, occupancy "
        f"{nvalid / (kept * plan.size ** 3):.4f}")
    log(f"brick engine: launches on the brick path: {launches}")
    if launches[BG.K7] != 1 or any(n for k, n in launches.items()
                                   if k != BG.K7):
        raise AssertionError(f"the brick path's launches: {launches}")

    lvl = level0.to(device)
    valid = torch.from_numpy(np.asarray(grid.valid)).to(device)
    dense = 2 * cap * plan.size ** 3 * 27 * c * c

    def windowed(x):
        return subm_conv_apply(x, lvl.subm_rb, w, win=lvl.win)

    def peak_gib(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated() - base) / 2**30

    for dtype, x, tol in ((torch.bfloat16, x16, KERNEL_TOL),
                          (torch.float32, x32, KERNEL_TOL_F32)):
        name = str(dtype)[6:]
        yb, brick_gib = peak_gib(lambda: brick_subm_conv(x, dplan, w))
        yw, win_gib = peak_gib(lambda: windowed(x))
        if dtype == torch.bfloat16 and not torch.equal(yb, y16):
            raise AssertionError("the brick conv is not reproducible")
        check_against_plain("brick_subm_conv vs windowed subm_conv_apply",
                            yb[valid], yw[valid],
                            f"level 0, {nvalid} valid rows, {c}->{c} {name}",
                            tol)
        if yb[~valid].any():
            raise AssertionError("the brick conv wrote an invalid row")
        brick_ms = cuda_time_ms(lambda: brick_subm_conv(x, dplan, w), 20)
        win_ms = cuda_time_ms(lambda: windowed(x), 20)
        log(f"brick engine, {name}: brick_subm_conv {brick_ms:.4f} ms "
            f"(median of 20; dense conv3d work {dense} flop, "
            f"{dense / brick_ms / 1e9:.1f} TFLOP/s over the whole call), "
            f"peak memory above its inputs {brick_gib:.3f} GiB; windowed "
            f"subm_conv_apply (K1 + spill tiers) {win_ms:.4f} ms, "
            f"{win_gib:.3f} GiB")
        del yb, yw
    # where the bf16 brick conv's time goes
    bricks = _fill_bricks(x16, dplan)
    padded = _halo_pad(bricks, dplan.neighbors)
    kernel = w.reshape(3, 3, 3, c, c).permute(4, 3, 0, 1, 2).to(x16.dtype)
    parts = {
        "fill": lambda: _fill_bricks(x16, dplan),
        "halo": lambda: _halo_pad(bricks, dplan.neighbors),
        "conv3d": lambda: torch.nn.functional.conv3d(
            padded.permute(0, 4, 1, 2, 3), kernel)}
    log("brick engine, bfloat16, parts (median of 5): " + ", ".join(
        f"{k} {cuda_time_ms(fn, 5):.4f} ms" for k, fn in parts.items()))
    del bricks, padded

    # K7 against its plain version, bit for bit, at the reference test's
    # shape and at the halo-face gather; timed beside index_select
    rows = []
    small = torch.randn((128, 8, 128), generator=gen).to(device)
    sidx = torch.randint(-5, 133, (64,), generator=gen, dtype=torch.int32)
    sidx[:4] = torch.tensor([-1, 128, -7, 131], dtype=torch.int32)
    sidx = sidx.to(device)
    for label, s, i, run in (
            ("src (128, 8, 128) f32, M=64 (the reference test's shape)",
             small, sidx, lambda: BG.dma_block_gather(small, sidx)),
            (f"halo faces: src {tuple(src.shape)} bf16 "
             f"({src[0].numel() * src.element_size()} B blocks), "
             f"M={idx.shape[0]}", src, idx,
             lambda: BG.gather_blocks(src, idx))):
        out, ref = run(), BG.dma_block_gather_plain(s, i)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"K7 disagrees with its plain version at "
                                 f"{label}")
        log(f"{BG.K7}: {label}: equal to its plain version bit for bit")
        clipped = i.long().clamp(0, s.shape[0] - 1)
        rows.append(kernel_row(
            BG.K7, "tdwss_torch/csrc/block_gather.cu",
            "tdwss/ops/experimental/pallas_gather.py:59", run,
            lambda s=s, i=i: BG.dma_block_gather_plain(s, i),
            lambda s=s, i=i: BG.work(s, i), 0.0,
            library=lambda s=s, clipped=clipped: torch.index_select(
                s, 0, clipped), window=BACK_TO_BACK))
    if not torch.equal(faces, BG.dma_block_gather_plain(src, idx)):
        raise AssertionError("the brick path's halo-face gather differs "
                             "from the plain version")
    # rows of 30 bytes (not a multiple of 16): 2-byte copies
    odd = torch.randn((1000, 5, 3), generator=gen).to(device, torch.bfloat16)
    oidx = torch.randint(-5, 1005, (4096,), generator=gen,
                         dtype=torch.int32).to(device)
    BG.reset_launches()
    out = BG.gather_blocks(odd, oidx)
    ref = torch.index_select(odd, 0, oidx.long().clamp(0, odd.shape[0] - 1))
    torch.cuda.synchronize()
    log(f"{BG.K7}: src (1000, 5, 3) bf16 (30 B rows), M=4096: launches "
        f"{BG.launches}, equal to index_select on the clipped index: "
        f"{torch.equal(out, ref)}")
    if BG.launches[BG.K7] != 1 or not torch.equal(out, ref):
        raise AssertionError("K7 at 30-byte rows was not launched or "
                             "differs from index_select")
    log(f"{BG.K7} at the reference test's shape (logged only): "
        f"{json.dumps(rows[0])}")
    return rows[1], launches


def _state_equal(a, b):
    """Two Trainer.state_dict()s bit for bit equal (model, optimiser
    state, schedule, step)."""
    import torch

    if a["step"] != b["step"] or a["scheduler"] != b["scheduler"]:
        return False
    if a["model"].keys() != b["model"].keys():
        return False
    if not all(torch.equal(v, b["model"][k]) for k, v in a["model"].items()):
        return False
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    return sa.keys() == sb.keys() and all(
        torch.equal(v, sb[i][k]) if isinstance(v, torch.Tensor) else v ==
        sb[i][k] for i in sa for k, v in sa[i].items())


def check_run_sums(batch, width, device):
    """``devoxelize_seg``'s backward (the run sums) on the batch's point
    order at ``width`` channels: twice bit for bit, and against an f64
    sum of the same points (|d| <= 1e-5 max|f64|)."""
    import torch

    from tdwss_torch.ops.voxelize import run_sums

    perm, p2v = batch.point_perm, batch.point2voxel
    counts = batch.plans.levels[0].grid.counts
    gen = torch.Generator(device=device).manual_seed(3)
    dpts = torch.randn((perm.shape[0], width), generator=gen, device=device)
    a, b = run_sums(dpts, perm, counts), run_sums(dpts, perm, counts)
    v = counts.shape[0]
    ok = (p2v >= 0) & (p2v < v)
    ref = torch.zeros((v, width), dtype=torch.float64, device=device)
    ref.index_add_(0, p2v[ok].long(), dpts[ok].double())
    err = (a.double() - ref).abs().max().item()
    scale = ref.abs().max().item()
    same = torch.equal(a, b)
    log(f"devoxelize_seg backward (run sums) at ({perm.shape[0]}, {width}) "
        f"-> ({v}, {width}): two runs bit-identical: {same}; max|d| vs an "
        f"f64 sum {err:.3g} (limit 1e-5 * {scale:.3g})")
    if not same or err > 1e-5 * scale:
        raise AssertionError("devoxelize_seg's backward is not reproducible "
                             "or disagrees with the f64 sum")


def phase_loop(val_scenes, device):
    """The weak-supervision loop through the port's entry points, in a
    temporary working directory, on LOOP_SCENES synthetic train scenes of
    POINTS_PER_SCENE points and the bench's val scenes:

    1. ``Trainer`` over ``3DUNetWithText_pseudolabel_finer.yaml`` (cut to
       the bench batch): ``fit(epochs=1)``, 2 steps and the epoch-1
       validation; a second ``Trainer`` resumes at epoch 2 with the
       first's state bit for bit;
    2. ``threshold_sweep`` and ``generate_pseudo_labels`` at 0.71;
    3. ``Trainer`` over ``3DUNetWithText_scannet_fcnet_with_pseudo.yaml``
       (FullySupervised) on those labels: ``fit(epochs=1)``; then epoch 2
       timed (wall seconds per step through the prefetching loader,
       device seconds per step by CUDA events) against the host's
       seconds per batch planned serially;
    4. one FullySupervised step through ``phase_train`` (launches against
       the plans' routing, tensor-core bodies, layer by layer against the
       plain versions, loss, bf16 gradients bit for bit) and
       ``devoxelize_seg``'s backward bit for bit;
    5. ``Trainer`` over ``3DUNetWithText_scannet_fcnet.yaml``
       (MultiLabelContrastive, cut to the bench batch) on the train
       scenes with their descriptions: ``fit(epochs=1)``, 2 steps (the
       tokenizing in the loader's threads) and 1 validation rep;
    6. ``python -m tdwss_torch.cli.train --config configs/smoke_cpu.yaml
       --epochs 1`` as a subprocess on the card.

    Returns (launches of 1-3, launches of 4, launches of 5)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from tdwss_torch.config import load_config
    from tdwss_torch.data.loader import train_batches
    from tdwss_torch.data.synthetic import make_dataset
    from tdwss_torch.engine import train as train_mod
    from tdwss_torch.engine.pseudo import (generate_pseudo_labels,
                                           threshold_sweep)
    from tdwss_torch.ops import windowed as W
    from tdwss_torch.ops.host_plan import reset_sticky_plans

    t = time.perf_counter()
    scenes = make_dataset(LOOP_SCENES, num_points=POINTS_PER_SCENE, seed=11,
                          with_text=True)
    log(f"loop: {LOOP_SCENES} train scenes x {POINTS_PER_SCENE} points in "
        f"{time.perf_counter() - t:.2f} s")
    cwd = os.getcwd()
    work = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    os.chdir(work)
    try:
        gen_cfg = cut_to_bench_batch(load_config(os.path.join(
            HERE, "configs", "3DUNetWithText_pseudolabel_finer.yaml")))
        reset_sticky_plans()
        torch.cuda.synchronize()
        W.reset_launches()
        t = time.perf_counter()
        trainer = train_mod.Trainer(gen_cfg, scenes, val_scenes,
                                    device=device, verbose=False)
        log(f"loop: Trainer ({gen_cfg.training_name}, MultiLabel over "
            f"{gen_cfg.pointcloud_model.name}) built, plan shapes warmed "
            f"over epochs {trainer.warmed_epochs} "
            f"({gen_cfg.engine.collate_workers} collate workers): "
            f"{time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        hist = trainer.fit(epochs=1)
        log(f"loop: fit(epochs=1): {trainer.spe} steps and the epoch-1 "
            f"validation in {time.perf_counter() - t:.2f} s; mean loss "
            f"{hist[0]:.6f}")
        if len(hist) != 1 or not math.isfinite(hist[0]):
            raise AssertionError(f"loop: bad loss history {hist}")
        warm = copy.deepcopy(gen_cfg)
        warm.engine.prewarm_shapes = False   # this process is warm already
        resumed = train_mod.Trainer(warm, scenes, val_scenes, device=device,
                                    verbose=False)
        same = _state_equal(trainer.state_dict(), resumed.state_dict())
        log(f"loop: a second Trainer starts at epoch {resumed.start_epoch} "
            f"with the first's model, optimiser, schedule and step "
            f"bit-identical: {same}")
        if resumed.start_epoch != 2 or not same:
            raise AssertionError("loop: the resumed Trainer differs")
        del resumed
        t = time.perf_counter()
        sweep = threshold_sweep(gen_cfg, trainer.model, scenes,
                                verbose=False, device=device,
                                plot_path=os.path.join(work, "sweep.jpg"))
        log(f"loop: threshold_sweep over {sweep['total']} valid points in "
            f"{time.perf_counter() - t:.2f} s: " + ", ".join(
                f"{th:.3f}: {g} generated, {c} correct" for th, g, c in zip(
                    sweep["thresholds"], sweep["generated"],
                    sweep["correct"])))
        t = time.perf_counter()
        generated, correct, total = generate_pseudo_labels(
            gen_cfg, trainer.model, scenes, threshold=0.71, verbose=False,
            device=device)
        label_dir = os.path.join(work, gen_cfg.path,
                                 f"{gen_cfg.training_name}_thresh0.71")
        log(f"loop: generate_pseudo_labels at 0.71 in "
            f"{time.perf_counter() - t:.2f} s: {generated} of {total} points "
            f"labelled, {correct} of them correct")
        del trainer

        fs_cfg = cut_to_bench_batch(load_config(os.path.join(
            HERE, "configs", "3DUNetWithText_scannet_fcnet_with_pseudo.yaml")))
        fs_cfg.pseudo_label_path = label_dir
        for scene in scenes:
            scene.pseudo_labels = np.load(os.path.join(
                label_dir, scene.name + fs_cfg.pseudo_label_suffix))
        reset_sticky_plans()
        t = time.perf_counter()
        fs = train_mod.Trainer(fs_cfg, scenes, val_scenes, device=device,
                               verbose=False)
        log(f"loop: Trainer ({fs_cfg.training_name}, FullySupervised) "
            f"built, plan shapes warmed over epochs {fs.warmed_epochs}: "
            f"{time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        hist = fs.fit(epochs=1)
        log(f"loop: FullySupervised fit(epochs=1): {fs.spe} steps and "
            f"{fs_cfg.pointcloud_data.val_reps} validation reps in "
            f"{time.perf_counter() - t:.2f} s; mean loss {hist[0]:.6f}")
        if not math.isfinite(hist[0]):
            raise AssertionError(f"loop: bad FullySupervised loss {hist}")

        # epoch 2 through the prefetching loader, each step's device time
        # between CUDA events around it
        events = []
        real_step = train_mod.train_step

        def timed_step(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = real_step(*a, **kw)
            ev[1].record()
            events.append(ev)
            return out

        torch.cuda.synchronize()
        train_mod.train_step = timed_step
        try:
            t = time.perf_counter()
            fs.run_epoch(2)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            train_mod.train_step = real_step
        dev_s = [a.elapsed_time(b) / 1e3 for a, b in events]
        b = next(iter(train_batches(scenes, fs_cfg, 3, prefetch=False)))
        b = b.to(device)
        syncs = list_syncs(lambda: train_mod.train_step(
            fs_cfg, fs.model, fs.optimizer, fs.scheduler, b))
        log(f"loop: synchronising calls in one warm FullySupervised "
            f"train_step: {len(syncs)} sites: {json.dumps(syncs)}")
        if syncs:
            raise AssertionError("train_step synchronises with the host")
        del b
        # epoch 2's batches planned again on the host alone: in turn on
        # one thread, then on the collate threads at once (the native
        # planner is a ctypes call, which releases the GIL)
        serial_cfg = copy.deepcopy(fs_cfg)
        serial_cfg.engine.collate_workers = 1
        per_batch = {}
        for label, c in (("serially", serial_cfg), ("threaded", fs_cfg)):
            t = time.perf_counter()
            n = sum(1 for _ in train_batches(scenes, c, 2, prefetch=False))
            per_batch[label] = (time.perf_counter() - t) / n
        at_once = min(n, fs_cfg.engine.collate_workers)
        log(f"loop: FullySupervised epoch 2: {len(dev_s)} steps in "
            f"{wall:.3f} s wall through the prefetching loader "
            f"({fs_cfg.engine.collate_workers} collate workers, copies on "
            f"a copy stream): {wall / len(dev_s):.3f} s per step; device "
            f"seconds per step (CUDA events) "
            f"{', '.join(f'{x:.3f}' for x in dev_s)}; host seconds per "
            f"batch planned serially (1 worker, no prefetch) "
            f"{per_batch['serially']:.3f}, on {at_once} collate threads "
            f"at once {per_batch['threaded']:.3f} (overlap "
            f"{per_batch['serially'] / per_batch['threaded']:.2f}x of "
            f"{at_once} possible)")
        del fs
        launches = dict(W.launches)
        check_bodies("loop")
        log(f"loop: launches over the two Trainers, the sweep and the "
            f"generation: {launches}")
        if not (launches[W.K1] and launches[W.K2]):
            raise AssertionError("loop: K1 or K2 was not launched")

        planned, host, host_s = plan_train_batch(fs_cfg, scenes[:NUM_SCENES],
                                                 "FullySupervised")
        fs_launches = phase_train("FullySupervised", fs_cfg, planned, host,
                                  host_s, device, 1, full_checks=False,
                                  repro=True)
        from tdwss_torch.models.sparse_encoders import output_width

        check_run_sums(host.to(device), output_width(
            fs_cfg.pointcloud_model), device)
        del planned, host

        text_cfg = text_config()
        reset_sticky_plans()
        torch.cuda.synchronize()
        W.reset_launches()
        t = time.perf_counter()
        tt = train_mod.Trainer(text_cfg, scenes, val_scenes, device=device,
                               verbose=False)
        log(f"loop: Trainer ({text_cfg.training_name}, MultiLabelContrastive "
            f"over {text_cfg.pointcloud_model.name} with a "
            f"{text_cfg.text_model.layers}-layer text tower) built, plan "
            f"shapes warmed over epochs {tt.warmed_epochs}: "
            f"{time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        hist = tt.fit(epochs=1)
        torch.cuda.synchronize()
        text_launches = dict(W.launches)
        log(f"loop: MultiLabelContrastive fit(epochs=1): {tt.spe} steps "
            f"(Classification + TextContrastive) and "
            f"{text_cfg.pointcloud_data.val_reps} validation rep in "
            f"{time.perf_counter() - t:.2f} s; mean loss {hist[0]:.6f}; "
            f"launches {text_launches}")
        check_bodies("loop, text Trainer")
        if not (len(hist) == 1 and math.isfinite(hist[0])
                and text_launches[W.K1] and text_launches[W.K2]):
            raise AssertionError(f"loop: the text Trainer's epoch failed: "
                                 f"{hist}, {text_launches}")
        del tt

        t = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=HERE)
        res = subprocess.run(
            [sys.executable, "-m", "tdwss_torch.cli.train", "--config",
             os.path.join(HERE, "configs", "smoke_cpu.yaml"), "--epochs",
             "1"], cwd=work, env=env, capture_output=True, text=True,
            timeout=300)
        log(f"loop: python -m tdwss_torch.cli.train --config "
            f"configs/smoke_cpu.yaml --epochs 1 (on the card): exit "
            f"{res.returncode} in {time.perf_counter() - t:.2f} s; "
            + " | ".join(l for l in res.stdout.splitlines()
                         if "Train loss" in l or "mean IOU" in l))
        if res.returncode != 0 or "mean IOU" not in res.stdout:
            raise AssertionError("loop: the train CLI failed: "
                                 + res.stderr[-3000:])
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    return launches, fs_launches, text_launches


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--trace-dir",
                        default=os.path.join(HERE, "exp", "chip_smoke"),
                        help="where the profile phase writes trace.json.gz")
    args = parser.parse_args()
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
    from tdwss_torch.models.sparse_encoders import plane_schedule
    from tdwss_torch.ops.host_plan import reset_sticky_plans

    cfg = bench_config()
    t = time.perf_counter()
    scenes = make_dataset(NUM_SCENES, num_points=POINTS_PER_SCENE, seed=7,
                          with_text=True)
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
    del case

    # the FCN configs, cut to the bench batch; their batches are planned
    # here (host) so K6 can be held at Narrow's widest level
    narrow_cfg = cut_to_bench_batch(narrow_config())
    fcnet_cfg = cut_to_bench_batch(fcnet_config())
    narrow_batch = plan_train_batch(narrow_cfg, scenes, "Narrow")
    n_planes = plane_schedule(narrow_cfg.pointcloud_model)
    top = len(n_planes) - 1
    narrow_wide = level_case(narrow_batch[1].plans, top, n_planes[top],
                             n_planes[top], device, gen)
    rows.append(phase_k6([
        (f"the bench UNet's widest subm conv (level {deep})", wide),
        (f"Narrow's widest level ({top})", narrow_wide)]))
    del wide, narrow_wide

    reset_sticky_plans()
    shapes, bwd_shapes, dw_shapes = {}, {}, {}
    with record_fwd_shapes(shapes), record_bwd_shapes(bwd_shapes), \
            record_dw_shapes(dw_shapes):
        val_launches = phase_main(cfg, scenes, batch.plans, batch, device)
        unet_batch = plan_train_batch(cfg, scenes, "UNet")
        paths = {"validate": val_launches,
                 "UNet": phase_train("UNet", cfg, *unet_batch, device,
                                     TRAIN_STEPS, full_checks=True)}
        paths["Narrow"] = phase_train("Narrow", narrow_cfg, *narrow_batch,
                                      device, TRAIN_STEPS, full_checks=False)
        phase_unpool_times(narrow_batch[1].plans, n_planes, device, gen)
        del narrow_batch
        fcnet_batch = plan_train_batch(fcnet_cfg, scenes, "FCNet")
        paths["FCNet"] = phase_train("FCNet", fcnet_cfg, *fcnet_batch,
                                     device, 1, full_checks=False)
        del fcnet_batch
        paths["Text"] = phase_text(scenes, device)
    phase_profile(cfg, unet_batch[1], device, args.trace_dir)
    del unet_batch
    n = phase_fwd_sweep(shapes, device, gen)
    log(f"forward sweep: {n} shapes held against the plain versions")
    del shapes
    times = phase_bwd_sweep(bwd_shapes, device, gen)
    log(f"backward sweep: {len(times)} shapes of K2 and K6 held against "
        f"the plain versions; bf16 ms / bound ms: " + ", ".join(
            f"{k[0]} {k[1]}->{k[2]} K={k[3]}: {ms:.4f} / {b:.4f}"
            for k, (ms, b) in sorted(times.items(), key=lambda kv: str(kv[0]))))
    del bwd_shapes
    times = phase_dw_sweep(dw_shapes, device, gen)
    log(f"dW sweep: {len(dw_shapes)} shapes of K3/K5 held against the plain "
        f"versions; bf16 ms / bound ms: " + ", ".join(
            f"{k}: {ms:.4f} / {b:.4f}" for k, (ms, b) in times.items()))
    if not dw_shapes:
        raise AssertionError("no path launched K3 or K5")
    del dw_shapes
    k7_row, paths["brick"] = phase_brick(batch, device, gen)
    rows.append(k7_row)
    (paths["loop"], paths["FullySupervised"],
     paths["loop, text Trainer"]) = phase_loop(scenes, device)
    # The kernels line lists every ported kernel with its launches summed
    # over the paths (0 for K4 and K5: no plan of any path is flat-form).
    for row in rows:
        row["launches"] = sum(p.get(row["name"], 0) for p in paths.values())
    for name, launches in paths.items():
        log(f"launches on the {name} path: {launches}")
    log(f"device time split per path: {json.dumps(SPLITS)}")
    log("all phases passed")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
