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
drives the experimental brick engine at the bench level 0, drives
the weak-supervision loop through the port's entry points (``Trainer``,
the pseudo-label stage, ``FullySupervised`` and the train CLI) at
SparseConvFCNet's width, trains the 4-chip config data-parallel on 4
ranks that share the card, runs the bench UNet without host plans
(on-device voxelization and rulebooks) and with ``engine.remat``,
trains the KPConv backbone (KPFCNN) at its full width, and runs the
offline tools (GSS proposals, boxes in the train batch, the projector,
``Box2Mask`` and the pseudo-image mask pipeline), and checks them:

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
   K3, K5 and K6 in samples of BACK_TO_BACK calls back to back); the
   spill kernels K8 (spill_apply) and K9 (spill_dw, both orientations)
   on the bench plans' own spill entries at level 0 (32 -> 32) and at
   the widest cross-level convs (192 -> 224, 224 -> 192), in bf16 and
   f32, each twice bit for bit, K8's identity form at an unpool, timed
   at level 0;
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
   a warm text step; then ``..._fcnet_baseline_finer.yaml`` at its own
   batch (6 synthetic scenes of ``max_points // batch_size`` points in
   its ``max_points`` of 4,194,304): 2 steps with the launch counts set
   to 0 just before and read just after, equal to the plans' routing and
   on the tensor-core body, the loss finite, host plan s, device s per
   step and peak memory beside the cut's; then one more forward and
   backward in which each kernel's first launch at each operand shape of
   level 0 is copied and held against its plain version;
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
    the conv backward around the kernels, the kernel wrappers' own ops
    (the spill kernels' included), each read from the program's
    ``tdwss.*`` spans; Adam, casts and copies, other forward and backward
    ops); the trace goes to ``<--trace-dir>/trace.json.gz`` (default
    ``exp/chip_smoke/``), the program's spans to ``trace.spans.json``; then
    the rulebook pools (plain PyTorch, as the reference's): ``max_pool``,
    ``avg_pool`` and ``gather_neighbors`` over level 0's ``down_rb`` and
    ``gather_neighbors`` over its subm rulebook, on the bench UNet's
    train batch with ties among children and an entry beyond the level
    planted, card against CPU in f32 and bf16, values and gradients bit
    for bit (``avg_pool`` within POOL_AVG_TOL, and the subm rulebook's
    gradient, up to 27 entries per voxel summed in another order, within
    POOL_SUM_TOL);
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
13. data parallel: ``configs/3DUNetWithText_scannet_subcloud_uppool_4chip.yaml``
    (SparseConvFCNetDirectUpPool, m=16, planes 16..256, bf16, global
    batch 32 = 8 subclouds per rank, ``label: subcloud`` through
    ``expand_subclouds`` on 5 synthetic scenes of 150,000 points; 1
    validation rep in place of 3) on 4 gloo ranks started with
    ``torch.multiprocessing`` (spawn), all on this one card (NCCL refuses
    two ranks on one card; its path over several cards is not run here):
    the first of 4 batches planned here through one step with every
    windowed backward and unpool re-run through the plain versions and
    the loss parts held against them in bf16 and f32 (K1/K2/K3/K6 at this
    path's shapes); one DP step from the 4 batches against its one-process
    emulation on the card in f32 and bf16, the ranks bit for bit; a
    planted fault (one rank keeps its own running statistics) that both
    checks must catch; a ``Trainer`` fit of one epoch (2 global steps and
    the rank-0 validation) with the launch counts set to 0 just before and
    read just after on every rank, K1 and K2 launched on the tensor-core
    body, the ranks' parameters and buffers bit for bit (broadcast, max
    |d|), one checkpoint, and a resume on every rank bit for bit; device
    seconds per step per rank (CUDA events), wall seconds per global step,
    peak memory per rank;
14. plans-free: the bench UNet with ``engine.host_plans: false`` (the
    points voxelized and every level's rulebooks built on the card, the
    convs on the rulebook routes): with the launch counts set to 0 just
    before and read just after (K1-K9 must stay 0), ``validate`` (1 rep),
    the logits of the rep-1 batch, 2 training steps and a warm step with
    no synchronising call; the logits against the host-planned path on
    the same points (bf16 2^-7, f32 1e-4 of max|host|) and the first
    step's loss (LOSS_RTOL); host seconds per batch (collate alone
    against collate + plans + slim), device seconds per step of both
    paths, peak memory;
15. remat: the bench UNet with ``engine.remat: true`` (the encoder body
    under ``torch.utils.checkpoint``), 2 training steps with the launch
    counts set to 0 just before and read just after, equal to the plans'
    routing with the body's forward counted twice, every launch on the
    tensor-core body; the same 2 steps without remat from the same
    weights, the losses, the last gradients, the parameters and the
    running statistics bit for bit; peak memory and device ms per step
    of both;
16. KPConv: KPFCNN at ``KPConvConfig()``'s width (SCANNET_ARCHITECTURE,
    first_features_dim 64, 15 kernel points, dl 0.04 m, in_radius 2 m,
    20 classes, f32; plain PyTorch, no kernel) on 8 spheres drawn by
    ``PotentialSampler`` from the scenes grid-subsampled at 0.04 m: the
    host pyramid timed, an eval forward, one train step's logits, loss
    and gradients against the CPU on the same weights (the reference's
    NaN offset gradients at the same sites), a planted fault (a shadow
    neighbour read as row 0) caught, the card's f32 step with the CPU's
    f32 selections replayed on the exact-size and on the padded batch
    (KP_REPLAY_RTOL), 3 Adam steps with the deform group (CUDA events,
    peak memory, the loss falling, every parameter moved) and no
    synchronising call in a warm step;
17. offline tools: GSS proposals (``gss.generate_proposals`` on the
    native library) for one scene at its full point count, with the
    seconds of normals, region growing, merging and NMS, the boxes
    finite and no two kept boxes over IoU 0.75, written as
    ``<scene>_prop.npy`` (that scene's boxes stand for the others);
    the scenes loaded with ``with_boxes: true, max_boxes: 64`` through
    the port's dataset and ``train_collate`` and moved to the card; the
    bench UNet's eval forward on that batch through the kernels (K1's
    launches equal to the plans' routing) and ``project_from_batch`` on
    its per-point logits (20 channels -> Matting -> 2, resolution 256,
    views HWZ): the views and the gradient of their sum with respect to
    the Matting weights and the logits against the same call on the CPU
    with the same weights (views 1e-5 of max|cpu|, gradients 1e-4 of
    each tensor's max), and a planted fault on the card side (the crop
    without ``rot_inv``) caught; ``Box2Mask`` on that scene's points,
    logits and corner boxes (3 views, resolution 256, radius 4, nsample
    3) and ``run_mask_pipeline`` on 8 synthetic 256x256 images, each
    against the CPU (``Box2Mask`` on a seeded sample of the boxes
    stratified by proposal order and size, with the largest that fits
    BOX_CPU_POINTS; ball-query indices equal, or each flip a distance
    within a few ulps of the radius and the masks held with the CPU's
    indices; masks within 1e-5); ms and peak memory of each;
18. one JSON line with the numbers of every hand-written kernel (K1-K9, each
    with its launches over the main paths, the loop, the brick path and
    the DP, plans-free, remat and offline paths, 0 included), the card
    line from ``nvidia-smi``, and the result line.

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
# - Reproducibility: the kernels' dW partials and the spill kernels'
#   sums (K8, K9) add in a fixed order, so two bf16 steps through the
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
            "spill kernels": lambda: windowed.build("spill"),
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
                 "fused subm backward kernel", "block gather kernel",
                 "spill kernels"):
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


def phase_spill(plans, deep, m, device, gen):
    """K8 (spill_apply) and K9 (spill_dw) against their plain versions on
    the bench plans' own spill layouts: level 0's subm plan at m -> m and
    the widest cross-level convs, level ``deep``'s down map ((deep + 1) m
    -> (deep + 2) m) and up map (the reverse; where the up map has no
    spill entries, as at the bench's level 5, its widths on the down
    map's entries), in bf16 and f32, K9 in both orientations, each twice
    bit for bit; K8's identity form at level 0's up map; timed rows at
    level 0 in bf16.  Logs every plan's spill entries (the work the
    kernels take over)."""
    import torch

    from tdwss_torch.ops import windowed as W

    for i, lvl in enumerate(plans.levels):
        parts = []
        for name in ("win", "wg_down", "wg_up"):
            p = getattr(lvl, name)
            if p is not None:
                so = p.spill_order
                parts.append(f"{name} {so.entries} entries, "
                             f"{so.owner.shape[0]} owners, "
                             f"{so.chunk.shape[0] - 1} chunks")
        log(f"spill tiers, level {i}: {'; '.join(parts)}")

    planes = (deep + 1) * m
    lvl0, lvld = plans.levels[0], plans.levels[deep]
    up, up_label = lvld.wg_up, f"level {deep} up"
    if not up.spill_order.entries:
        up, up_label = lvld.wg_down, (f"level {deep} down's entries at the "
                                      "up map's widths")
    cases = [("level 0 subm", lvl0.win, m, m, True),
             (f"level {deep} down", lvld.wg_down, planes, planes + m, False),
             (up_label, up, planes + m, planes, False)]
    src = "tdwss_torch/csrc/spill.cu"
    replaces = ("none: port-only, the reference's spill tiers are plain jnp "
                "(tdwss/ops/sparse_conv.py:317,573)")
    rows = []
    for label, plan, cin, cout, subm in cases:
        so = plan.spill_order.to(device)
        if not so.entries:
            raise AssertionError(f"{label}: the plan has no spill entries")
        k = plan.rb_local.shape[1]
        v_out = plan.rb_local.shape[0]
        v_src = v_out if subm else plan.v_src
        x32 = torch.randn((v_src, cin), generator=gen).to(device)
        w32 = (torch.randn((k, cin, cout), generator=gen)
               * (2.0 / (k * cin)) ** 0.5).to(device)
        base32 = torch.randn((v_out, cout), generator=gen).to(device)
        d32 = torch.randn((v_out, cout), generator=gen).to(device)
        dw0 = torch.randn((k, cin, cout), generator=gen).to(device)
        for dtype, tol in ((torch.bfloat16, KERNEL_TOL),
                           (torch.float32, KERNEL_TOL_F32)):
            x, w, base, dout = (t.to(dtype) for t in (x32, w32, base32, d32))
            tag = (f"{label}: E={so.entries} C={cin} Cout={cout} K={k} "
                   f"{str(dtype)[6:]}")

            def apply(fn, w=w, x=x, base=base):
                return fn(x, so.owner, so.start, so.entry, w, base.clone())

            out, ref, out2 = (apply(W.spill_apply),
                              apply(W.spill_apply_plain),
                              apply(W.spill_apply))
            torch.cuda.synchronize()
            err = check_against_plain(W.K8, out, ref, tag, tol)
            if not torch.equal(out, out2):
                raise AssertionError(f"{W.K8} {tag}: two launches differ")
            orients = ((False, False), (True, True)) if subm else (
                (False, False), (True, False))
            for flip, flip_taps in orients:
                # flipped: feats in the owners' domain, dout in the sources'
                f_rows, d_rows = (v_out, v_src) if flip else (v_src, v_out)
                xf = torch.randn((f_rows, cin), generator=gen).to(device,
                                                                  dtype)
                df = torch.randn((d_rows, cout), generator=gen).to(device,
                                                                   dtype)

                def dw(fn, xf=xf, df=df, flip=flip, flip_taps=flip_taps):
                    return fn(xf, df, so.tap_entry, so.chunk, so.tap_chunk,
                              dw0.clone(), flip=flip, flip_taps=flip_taps)

                got, want, got2 = (dw(W.spill_dw), dw(W.spill_dw_plain),
                                   dw(W.spill_dw))
                torch.cuda.synchronize()
                e9 = check_against_plain(
                    W.K9, got - dw0, want - dw0,
                    f"{tag} flip={flip} flip_taps={flip_taps}", DW_TOL)
                if not torch.equal(got, got2):
                    raise AssertionError(f"{W.K9} {tag}: two launches "
                                         "differ")
            if label == "level 0 subm" and dtype == torch.bfloat16:
                scratch = base.clone()
                rows.append(kernel_row(
                    W.K8, src, replaces,
                    lambda: W.spill_apply(x, so.owner, so.start, so.entry, w,
                                          scratch),
                    lambda: W.spill_apply_plain(x, so.owner, so.start,
                                                so.entry, w, scratch),
                    lambda: W.work_spill_apply(x, so.owner, so.entry, w,
                                               base),
                    err, window=BACK_TO_BACK))
                acc = dw0.clone()
                rows.append(kernel_row(
                    W.K9, src, replaces,
                    lambda: W.spill_dw(x, dout, so.tap_entry, so.chunk,
                                       so.tap_chunk, acc),
                    lambda: W.spill_dw_plain(x, dout, so.tap_entry, so.chunk,
                                             so.tap_chunk, acc),
                    lambda: W.work_spill_dw(x, dout, so.tap_entry, so.chunk,
                                            so.tap_chunk),
                    e9, window=BACK_TO_BACK))
    # the identity form (the unpools) at level 0's up map
    up = lvl0.wg_up
    so = up.spill_order.to(device)
    x = torch.randn((up.v_src, m), generator=gen).to(device, torch.bfloat16)
    base = torch.randn((up.rb_local.shape[0], m), generator=gen).to(
        device, torch.bfloat16)
    out = W.spill_apply(x, so.owner, so.start, so.entry, None, base.clone())
    ref = W.spill_apply_plain(x, so.owner, so.start, so.entry, None,
                              base.clone())
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError(f"{W.K8}'s identity form differs from its "
                             "plain version (a copy and one add each)")
    log(f"{W.K8} identity form, level 0 up map (E={so.entries}, C={m}, "
        "bf16): equal to the plain version bit for bit")
    return rows


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
    unpool's backward is K1 or K4 on the down plan (no dW).  Every such
    evaluation of a plan with spill entries also launches K8 (forward,
    dfeats, unpool) or K9 (dW, on the backward plan on K2's route, else
    on the forward plan).
    """
    from tdwss_torch.ops import windowed as W

    counts = {name: 0 for name in W.launches}
    fwd = {True: W.K1, False: W.K4}

    def spill(name, plan):
        if plan.spill_order.entries:
            counts[name] += reps

    def conv(plan, bplan, kernel, needs_dfeats=True, subm=False):
        if plan is None:
            return                           # rulebook route: no kernel
        counts[fwd[bool(plan.sub)]] += reps
        spill(W.K8, plan)
        if not train:
            return
        _, cin, cout = kernel.shape
        if bplan.sub and cin <= GATHER_MAX_C and cout <= GATHER_MAX_C:
            counts[W.K2] += reps
            spill(W.K9, bplan)
        elif subm and plan.sub:
            counts[W.K6] += reps
            spill(W.K9, plan)
        else:
            counts[W.K3 if plan.sub else W.K5] += reps
            spill(W.K9, plan)
            if needs_dfeats:
                counts[fwd[bool(bplan.sub)]] += reps
        if needs_dfeats:
            spill(W.K8, bplan)

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
                spill(W.K8, lvl.wg_up)
                if train:
                    counts[fwd[bool(lvl.wg_down.sub)]] += reps
                    spill(W.K8, lvl.wg_down)
        body, i = body.inner, i + 1


# The kernel entry points the model's routes call (tdwss_torch.ops.
# sparse_conv's names, which are also the kernels' names K1-K6, K8, K9).
KERNEL_ENTRIES = ("windowed_matmul_sub", "windowed_matmul",
                  "windowed_bwd_gather", "windowed_dw_sub", "windowed_dw",
                  "windowed_bwd_sub", "spill_apply", "spill_dw")


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


@contextlib.contextmanager
def record_level_launches(held, rows):
    """Keep in ``held``, copied to the host, the arguments and outputs of
    the enclosed run's first launch of each kernel at each operand shape
    among the launches that have a feature operand of ``rows`` rows:
    {(name, shapes): (args, kwargs, out)}."""
    import torch

    def keep(x):
        if isinstance(x, tuple):
            return tuple(keep(y) for y in x)
        return x.cpu() if isinstance(x, torch.Tensor) else x

    def make(name, fn):
        def recorded(*args, **kwargs):
            ops = [a for a in args if isinstance(a, torch.Tensor)
                   and a.dim() >= 2]
            # features and weights past their rows; plans by their taps
            key = (name, tuple(tuple(a.shape[1:]) if a.is_floating_point()
                               else a.shape[0] for a in ops))
            first = key not in held and any(
                a.is_floating_point() and a.shape[0] == rows for a in ops)
            # kept before the call: K8 and K9 add into an operand in place
            before = (keep(args), keep(kwargs)) if first else None
            out = fn(*args, **kwargs)
            if first:
                held[key] = (*before, keep(out))
            return out
        return recorded

    with patched_entries(KERNEL_ENTRIES, make):
        yield held


def hold_launches(label, held, device):
    """Each launch in ``held`` (``record_level_launches``) against its
    plain version on the same arguments, one at a time on ``device``:
    outputs and dfeats within KERNEL_TOL, dW within DW_TOL."""
    import torch

    from tdwss_torch.ops import windowed as W

    def card(x):
        if isinstance(x, tuple):
            return tuple(card(y) for y in x)
        return x.to(device) if isinstance(x, torch.Tensor) else x

    # the names of each kernel's outputs, with their limits
    parts = {W.K1: (("out", KERNEL_TOL),), W.K4: (("out", KERNEL_TOL),),
             W.K3: (("dW", DW_TOL),), W.K5: (("dW", DW_TOL),),
             W.K2: (("dfeats", KERNEL_TOL), ("dW", DW_TOL)),
             W.K6: (("dfeats", KERNEL_TOL), ("dW", DW_TOL)),
             W.K8: (("out", KERNEL_TOL),), W.K9: (("dW", DW_TOL),)}
    for (name, _), (args, kwargs, out) in sorted(held.items(),
                                                  key=lambda kv: str(kv[0])):
        args, kwargs, out = card(args), card(kwargs), card(out)
        ref = getattr(W, name + "_plain")(*args, **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)
                  and a.is_floating_point()]
        for (what, tol), o, r in zip(parts[name], outs, refs):
            if o is not None:
                check_against_plain(name, o, r, f"{label}: {what} of a "
                                    f"level-0 launch (operands {shapes})",
                                    tol)
        del args, kwargs, out, ref, outs, refs


def phase_own_size(cut):
    """``configs/3DUNetWithText_scannet_fcnet_baseline_finer.yaml`` at its
    own batch: ``batch_size`` 6 scenes of ``max_points // batch_size``
    points planned on the host (timed), ``own_size.STEPS`` training steps
    through the kernels (``tools/own_size.run_steps``: the launch counts
    set to 0 just before and read just after), equal to the plans'
    routing and on the tensor-core body, the loss finite; host plan s,
    device s per step and peak memory beside ``cut``, the FCNet path's at
    the bench batch's cut.  Then one more forward and backward of the
    same model on the same batch, uncounted, in which each kernel's first
    launch at each operand shape of level 0 (4,194,304 rows) is copied
    to the host and then held against its plain version
    (``hold_launches``)."""
    import torch

    from tdwss_torch.data.synthetic import make_dataset
    from tdwss_torch.engine.steps import compute_loss
    from tdwss_torch.tools.own_size import STEPS, run_steps

    label = "FCNet at its own size"
    cfg = fcnet_config()
    n = cfg.pointcloud_data.batch_size
    pps = cfg.engine.max_points // n
    t = time.perf_counter()
    scenes = make_dataset(n, num_points=pps, seed=7, with_text=False)
    log(f"{label}: {n} scenes x {pps} points "
        f"({sum(sc.points.shape[0] for sc in scenes)} in all) in "
        f"{time.perf_counter() - t:.2f} s")
    planned, host, host_s = plan_train_batch(cfg, scenes, label)
    del planned, scenes
    torch.cuda.empty_cache()
    out = run_steps(cfg, host)
    launches = out["launches"]
    check_bodies(label)
    want = {k: v * STEPS for k, v in expected_launches(
        out["model"], host.plans, train=True).items()}
    cut_host, cut_steps, cut_peak = cut
    log(f"{label} (max_points {cfg.engine.max_points}, batch {n}): losses "
        f"{out['losses']}; host plan {host_s:.3f} s, device s per step "
        f"{', '.join(f'{x:.3f}' for x in out['step_s'])}, peak device "
        f"memory {out['peak_gib']:.2f} GiB; beside the cut to the bench "
        f"batch (max_points {MAX_POINTS}, {NUM_SCENES} scenes of "
        f"{POINTS_PER_SCENE}): host plan {cut_host:.3f} s, device s per "
        f"step {', '.join(f'{x:.3f}' for x in cut_steps)}, peak "
        f"{cut_peak:.2f} GiB; launches {launches}, routed by the plans "
        f"{want}")
    if launches != want or not launches["windowed_matmul_sub"]:
        raise AssertionError(f"{label}: launches differ from the plans' "
                             f"routing: {launches} vs {want}")
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"{label}: non-finite loss {out['losses']}")

    model, batch = out.pop("model"), out.pop("batch")
    device = next(model.parameters()).device
    held = {}
    with record_level_launches(held,
                               host.plans.levels[0].grid.valid.shape[0]):
        model.zero_grad(set_to_none=True)
        loss, _ = compute_loss(cfg, model, batch)
        loss.backward()
    torch.cuda.synchronize()
    del model, batch, loss, out
    torch.cuda.empty_cache()
    launched = {k for k, v in launches.items() if v}
    log(f"{label}: {len(held)} launches at level 0 held: "
        f"{sorted(held, key=str)}")
    if {name for name, _ in held} != launched:
        raise AssertionError(f"{label}: held {sorted(held, key=str)}, "
                             f"launched {sorted(launched)}")
    hold_launches(label, held, device)
    del held
    torch.cuda.empty_cache()
    return launches


def plan_train_batch(cfg, scenes, label):
    """One training batch of ``cfg`` planned on the host (collate + plans
    + slim, timed): (planned, slimmed, seconds)."""
    from tdwss_torch.tools.own_size import plan_batch

    planned, host, host_s = plan_batch(cfg, scenes)
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
    (layer by layer, loss, gradients per tensor, bit for bit).  Returns
    the launches and (host plan s, device s per step, peak GiB)."""
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
    stats = (host_s, step_s, peak)
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
        return launches, stats

    # bf16: two steps through the kernels, every gradient bit for bit
    # (the dW partials and the spill kernels' sums add in a fixed order;
    # no switch of PyTorch's is set).
    _, gk2 = loss_and_grads(m16, cfg, batch)
    same16 = all(torch.equal(gk[n], gk2[n]) for n in gk)
    log(f"{label}: one bf16 step twice through the kernels: all "
        f"{len(gk)} gradient tensors bit-identical: {same16}")
    if not same16:
        raise AssertionError("bf16 training gradients through the kernels "
                             "are not reproducible")
    del m16, gk, gk2
    if not full_checks:
        return launches, stats
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
    return launches, stats


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
    launches, _ = phase_train("Text", cfg, planned, host, host_s, device,
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


# Device-time categories of the profile phase: the program's spans
# (tdwss_torch.utils.profiling) around the forward's parts, the conv
# routes' backward and the kernel entries, and the scopes PyTorch itself
# records (the optimiser's step, autograd's backward functions).
_OUR_KERNELS = ("windowed_", "fwd_mma_kernel", "dw_mma_kernel",
                "reduce_partials_kernel", "block_gather_kernel", "spill_")
_SPAN_CATEGORIES = {"tdwss.bn": "batch norm forward",
                    "tdwss.conv.backward": "conv backward around the kernels"}


def _category(event, kernel_name):
    if any(k in kernel_name for k in _OUR_KERNELS):
        return "hand-written kernels (K1-K9)"
    e = event
    while e is not None:
        name = e.name
        if name in _SPAN_CATEGORIES:
            return _SPAN_CATEGORIES[name]
        if name.startswith("tdwss.kernel."):
            return "kernel wrappers' own ops"
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
    with profiling.trace(trace_dir, "trace.json.gz") as prof:
        step()
        torch.cuda.synchronize()
    events = prof.events()
    # device activity: kernels, copies and sets (the record_function
    # ranges mirrored on the device timeline are not activity)
    device_ev = [e for e in events if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation
                 and not e.name.startswith("tdwss.")]
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


# avg_pool: an f32 sum of at most 8 children, divided by their count;
# in bf16 the same f32 value rounded once more
POOL_AVG_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -8}   # of max|cpu|
# gather_neighbors' gradient over the subm rulebook: each voxel's up to
# 27 entries summed in another order on the card (the CPU adds a bf16
# gradient in bf16, one rounding per entry: 0.0052 of max|grad| against
# an f32 sum rounded once, on one 150,000-point scene)
POOL_SUM_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -6}   # of max|cpu|
POOL_SUBM_C = 8                    # the subm rulebook's gather, channels


def phase_pools(scenes, device, gen):
    """``max_pool``, ``avg_pool`` and ``gather_neighbors`` (plain PyTorch,
    no kernel, as the reference's are plain XLA) on level 0 of the bench
    UNet's train batch, planned on the host without the slimming that
    drops the rulebooks: the pools and ``gather_neighbors`` over its
    ``down_rb`` at the bench UNet's width, ``gather_neighbors`` over its
    subm rulebook (all 27 taps of every voxel) at POOL_SUBM_C channels;
    features on a grid of quarters (so that children tie), three
    children of one voxel made equal and above the rest (a tie of 3),
    one entry of ``down_rb`` set beyond the level (>= V); values and the
    gradients of the sum against a seeded cotangent, card against CPU,
    in f32 and bf16: bit for bit, except ``avg_pool`` (POOL_AVG_TOL) and
    the subm rulebook's gradient, a sum of up to 27 entries per voxel
    (POOL_SUM_TOL)."""
    import numpy as np
    import torch

    from tdwss_torch.data.collate import train_collate
    from tdwss_torch.data.plans import attach_host_plans
    from tdwss_torch.ops import gather_neighbors, max_pool
    from tdwss_torch.ops.host_plan import build_subm_rulebook_np
    from tdwss_torch.ops.sparse_conv import avg_pool

    cfg = bench_config()
    t = time.perf_counter()
    lvl = attach_host_plans(train_collate(scenes, cfg,
                                          np.random.default_rng(0)),
                            cfg, slim=False).plans.levels[0]
    plan_s = time.perf_counter() - t
    down = np.array(lvl.down_rb, np.int32)
    subm = np.asarray(lvl.subm_rb)
    t = time.perf_counter()
    if not subm.shape[0]:                   # a placeholder at windowed levels
        subm = build_subm_rulebook_np(lvl.grid, 3)
    rb_s = time.perf_counter() - t
    v, c = lvl.grid.valid.shape[0], cfg.pointcloud_model.m
    feats = torch.randint(-4, 5, (v, c), generator=gen).float() / 4
    live = (down >= 0).sum(1)
    r = int(np.nonzero(live >= 3)[0][0])
    kids = torch.from_numpy(down[r][down[r] >= 0][:3]).long()
    feats[kids] = feats[kids[0]].clone()
    feats[kids, 0] = 5.0
    far = int(np.nonzero(live >= 2)[0][-1])
    down[far, np.nonzero(down[far] >= 0)[0][0]] = v + 7
    rbs = {"down_rb": torch.from_numpy(down),
           "subm_rb": torch.from_numpy(np.ascontiguousarray(subm))}
    # (name, function, rulebook, channels, value limit, gradient limit);
    # a limit of None: bit for bit
    cases = (("max_pool", max_pool, "down_rb", c, None, None),
             ("avg_pool", avg_pool, "down_rb", c, POOL_AVG_TOL,
              POOL_AVG_TOL),
             ("gather_neighbors", gather_neighbors, "down_rb", c, None,
              None),
             ("gather_neighbors", gather_neighbors, "subm_rb", POOL_SUBM_C,
              None, POOL_SUM_TOL))
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for name, fn, rb_name, width, val_tol, grad_tol in cases:
            rows = rbs[rb_name].shape[0]
            cols = rbs[rb_name].shape[1] * width if \
                name == "gather_neighbors" else width
            # a seeded cotangent, cheap to make at 21M x 8 entries
            cgen = torch.Generator().manual_seed(1)
            cot = (torch.randn(rows, 1, generator=cgen)
                   * torch.randn(1, cols, generator=cgen))
            outs = {}
            for dev in (device, torch.device("cpu")):
                x = feats[:, :width].to(dev, dtype).clone().requires_grad_(
                    True)
                rb = rbs[rb_name].to(dev)
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(x, rb)
                (out * cot.to(dev, dtype)).float().sum().backward()
                torch.cuda.synchronize()
                outs[dev.type] = (out.detach().cpu(), x.grad.cpu(),
                                  (time.perf_counter() - t) * 1e3)
            (oc, gc, ms), (o, g, cpu_ms) = outs[device.type], outs["cpu"]
            parts = []
            for what, got, want, tol in (("values", oc, o, val_tol),
                                         ("gradients", gc, g, grad_tol)):
                err = _rel_err(got, want)
                if tol is None:
                    ok = torch.equal(got, want)
                    parts.append(f"{what} bit for bit: {ok} (max|d| / "
                                 f"max|cpu| {err:.3g})")
                else:
                    ok = err <= tol[dname]
                    parts.append(f"{what} max|d| / max|cpu| {err:.3g} "
                                 f"(limit {tol[dname]:.3g})")
                results.append(ok)
            log(f"pools: {name} over level 0's {rb_name} "
                f"{tuple(rbs[rb_name].shape)}, {dname}, {width} channels: "
                f"card vs CPU, {'; '.join(parts)}; out {tuple(o.shape)}; "
                f"card {ms:.1f} ms, CPU {cpu_ms:.1f} ms (forward + "
                f"backward, host clock)")
    ok = torch.from_numpy((down >= 0) & (down < v))
    vals = torch.where(ok[..., None], feats[torch.where(
        ok, torch.from_numpy(down), 0).long()], -math.inf)
    ties = (vals == vals.amax(1, keepdim=True)).sum(1)[ok.any(1)]
    log(f"pools: level 0 {v} voxels, {down.shape[0]} coarse rows ("
        f"{int((live == 0).sum())} with no live child), a tie of 3 planted "
        f"at coarse row {r}, an entry >= V at row {far}; the max's tie "
        f"counts over the live children (rows x channels with 1, 2, ... "
        f"tied): {torch.bincount(ties.flatten()).tolist()[1:]}; the batch "
        f"planned on the host in {plan_s:.3f} s, the subm rulebook in "
        f"{rb_s:.3f} s")
    if not all(results):
        raise AssertionError("pools: the card disagrees with the CPU")


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
        fs_launches, _ = phase_train("FullySupervised", fs_cfg, planned,
                                     host, host_s, device, 1,
                                     full_checks=False, repro=True)
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


# ---------------------------------------------------------------------------
# Data parallel: the 4-chip config's Trainer on DP_WORLD gloo ranks that
# share one card
# ---------------------------------------------------------------------------

DP_CONFIG = "3DUNetWithText_scannet_subcloud_uppool_4chip.yaml"
DP_WORLD = 4
DP_SCENES = 5                  # whole scenes cut into the train subclouds
DP_TIMEOUT_S = 600             # the ranks' joint deadline
# One DP step against its one-process emulation (the same 4 batches
# forward and backward in turn, gradients and running statistics
# averaged, one Adam step): the reference test's limits in f32
# (tests/test_parallel.py:51-71).  Both sides run the same kernels on the
# same batches, so the per-batch gradients agree bit for bit, and both
# average in f64, so the order of the sums does not matter.  With f32
# sums (gloo's order against a sum in turn) the f32 step measured max|d|
# 3.88e-6 at lr 0.004, beyond atol 1e-6: Adam's first update is
# lr * g / (|g| + eps), and a gradient that nearly cancels over the ranks
# keeps only its rounding.  In bf16 the same step measured max|d| 0 on
# an H100 80GB HBM3 (700 W; PERF.md section 6), so it is held to the
# same limits.
DP_TOL_F32 = dict(rtol=1e-4, atol=1e-6)
DP_TOL_BF16 = dict(rtol=1e-4, atol=1e-6)


def dp_config():
    """``configs/3DUNetWithText_scannet_subcloud_uppool_4chip.yaml`` as it
    is, with one validation repetition in place of 3 (the rank-0
    validation of the fit's epoch)."""
    from tdwss_torch.config import load_config

    cfg = load_config(os.path.join(HERE, "configs", DP_CONFIG))
    cfg.pointcloud_data.val_reps = 1
    return cfg


def _excess(got, want, tol):
    """max over elements of |got - want| - (atol + rtol |want|): <= 0
    within ``tol`` (numpy's allclose); and max |got - want|."""
    import torch

    d = (got.double() - want.double()).abs()
    lim = tol["atol"] + tol["rtol"] * want.double().abs()
    return (d - lim).max().item(), d.max().item()


def _state_excess(got, want, tol):
    """(max excess, max |d|, name of the worst) over a state dict's
    floating-point tensors (parameters and running statistics)."""
    worst_ex, worst_d, worst_name = -math.inf, 0.0, ""
    for name, w in want.items():
        if w.is_floating_point():
            ex, dmax = _excess(got[name], w, tol)
            worst_d = max(worst_d, dmax)
            if ex > worst_ex:
                worst_ex, worst_name = ex, name
    return worst_ex, worst_d, worst_name


def _replica_max_diff(tensors):
    """max |t - rank 0's t| over ``tensors`` on this rank (rank 0's copy
    broadcast), reduced to the largest over the ranks."""
    import torch
    import torch.distributed as dist

    worst = torch.zeros((), dtype=torch.float64,
                        device=tensors[0].device)
    for t in tensors:
        ref = t.detach().clone()
        dist.broadcast(ref, src=0)
        worst = torch.maximum(
            worst, (t.detach().double() - ref.double()).abs().max())
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    return worst.item()


def _dp_rank(rank, world, work, cfg, spe, device):
    """One rank of the DP phase (started by ``phase_dp``): the step
    parity in f32 and bf16 and the planted fault on the parent's shared
    batches, then a ``Trainer`` fit of one epoch and its resume; writes
    ``rank<r>.pt``."""
    import datetime

    import torch
    import torch.distributed as dist

    from tdwss_torch.engine import train as train_mod
    from tdwss_torch.engine.steps import make_optimizer, train_step
    from tdwss_torch.models.meta_arch import build_model
    from tdwss_torch.ops import windowed as W
    from tdwss_torch.parallel import dp

    torch.set_num_threads(2)
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(work, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    out = {}
    try:
        local = train_mod.local_config(cfg, world)
        batch = torch.load(os.path.join(work, f"batch{rank}.pt"),
                           weights_only=False).to(device)

        def one_step(dtype, fault=False):
            c = copy.deepcopy(local)
            c.engine.compute_dtype = dtype
            model = build_model(c, seed=0, device=device)
            opt, sched = make_optimizer(c, model, spe)
            dp.broadcast_state(model)
            real = dp.average_batch_stats
            if fault and rank == 1:
                # the planted fault: this rank joins the all-reduce of the
                # running statistics but keeps its own
                def keep_own(m, group=None):
                    mine = [b.clone() for b in dp.batch_stat_buffers(m)]
                    real(m, group)
                    for b, v in zip(dp.batch_stat_buffers(m), mine):
                        b.copy_(v)
                dp.average_batch_stats = keep_own
            try:
                loss, _ = train_step(c, model, opt, sched, batch,
                                     group=dist.group.WORLD)
            finally:
                dp.average_batch_stats = real
            loss = dp.average_scalars({"loss": loss})["loss"]
            state = {k: v.detach().cpu().clone()
                     for k, v in model.state_dict().items()}
            rep = _replica_max_diff(list(model.state_dict().values()))
            return dict(loss=float(loss), state=state, replica_diff=rep)

        out["float32"] = one_step("float32")
        out["bfloat16"] = one_step("bfloat16")
        out["fault"] = one_step("bfloat16", fault=True)
        del batch

        # the fit: one epoch through the Trainer, the counts set to 0 just
        # before and read just after
        fit_dir = os.path.join(work, "fit")
        os.makedirs(fit_dir, exist_ok=True)
        os.chdir(fit_dir)
        scenes = torch.load(os.path.join(work, "scenes.pt"),
                            weights_only=False)
        events, starts = [], []
        real_step = train_mod.train_step

        def timed_step(*a, **kw):
            starts.append(time.perf_counter())
            if not cuda:
                return real_step(*a, **kw)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            res = real_step(*a, **kw)
            ev[1].record()
            events.append(ev)
            return res

        t = time.perf_counter()
        trainer = train_mod.Trainer(cfg, scenes["train"], scenes["val"],
                                    device=device, verbose=False)
        out["build_s"] = time.perf_counter() - t
        out["warmed_epochs"] = trainer.warmed_epochs
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        W.reset_launches()
        train_mod.train_step = timed_step
        try:
            t = time.perf_counter()
            out["history"] = trainer.fit(epochs=1)
            if cuda:
                torch.cuda.synchronize()
            out["fit_s"] = time.perf_counter() - t
        finally:
            train_mod.train_step = real_step
        out["launches"] = dict(W.launches)
        out["bodies"] = dict(W.body_launches)
        out["steps"] = len(starts)
        out["step_starts"] = [s - starts[0] for s in starts]
        out["device_s"] = [a.elapsed_time(b) / 1e3 for a, b in events]
        out["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                           if cuda else 0.0)
        out["replica_diff"] = _replica_max_diff(
            list(trainer.model.state_dict().values()))
        out["checkpoints"] = sorted(os.listdir(os.path.join(
            "exp", cfg.training_name, "checkpoints_torch")))
        first = trainer.state_dict()
        warm = copy.deepcopy(cfg)
        warm.engine.prewarm_shapes = False    # this process is warm already
        resumed = train_mod.Trainer(warm, scenes["train"], scenes["val"],
                                    device=device, verbose=False)
        out["resume_epoch"] = resumed.start_epoch
        out["resume_equal"] = _state_equal(first, resumed.state_dict())
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _dp_emulation(cfg, batches, spe, dtype, device):
    """One DP step emulated in one process: the batches forward and
    backward in turn from the same state, their gradients and updated
    running statistics averaged (summed in turn in f64, the mean rounded
    to f32, as ``tdwss_torch.parallel.dp`` averages), one Adam step.
    Returns (mean loss, state dict on the host)."""
    import torch

    from tdwss_torch.engine.steps import compute_loss, make_optimizer
    from tdwss_torch.models.meta_arch import build_model
    from tdwss_torch.parallel import dp

    c = copy.deepcopy(cfg)
    c.engine.compute_dtype = dtype
    model = build_model(c, seed=0, device=device)
    opt, sched = make_optimizer(c, model, spe)
    params = dp.trainable(model)
    bufs = dp.batch_stat_buffers(model)
    start = [b.clone() for b in bufs]
    g_sum = [torch.zeros_like(p, dtype=torch.float64) for p in params]
    s_sum = [torch.zeros_like(b, dtype=torch.float64) for b in bufs]
    l_sum = 0.0
    model.train()
    for batch in batches:
        with torch.no_grad():
            for b, v in zip(bufs, start):
                b.copy_(v)
        model.zero_grad(set_to_none=True)
        loss, _ = compute_loss(c, model, batch.to(device))
        loss.backward()
        l_sum += float(loss.detach())
        for g, p in zip(g_sum, params):
            if p.grad is not None:
                g += p.grad
        for s, b in zip(s_sum, bufs):
            s += b
    n = len(batches)
    l_mean = float(torch.tensor(l_sum / n, dtype=torch.float32))
    with torch.no_grad():
        for p, g in zip(params, g_sum):
            p.grad = (g / n).float()
        for b, s in zip(bufs, s_sum):
            b.copy_((s / n).float())
    opt.step()
    sched.step()
    return l_mean, {k: v.detach().cpu().clone()
                       for k, v in model.state_dict().items()}


def phase_dp(device):
    """The 4-chip config (SparseConvFCNetDirectUpPool, m=16, global batch
    32 = 8 per rank, ``label: subcloud``) trained data-parallel on
    DP_WORLD gloo ranks started with ``torch.multiprocessing`` (spawn),
    all pinned to ``device`` (one card: NCCL refuses two ranks on one
    card; the NCCL path over several cards is not run here), rendezvous
    through a FileStore in a temporary directory.

    1. Four batches planned once here (elastic noise is unseeded, so the
       ranks load them).  The first goes through ``phase_train`` (one
       step; every windowed backward and unpool re-run through the plain
       versions, dfeats within KERNEL_TOL / KERNEL_TOL_F32 and dW within
       DW_TOL, the loss parts in bf16 and f32 against the plain
       versions), so K1/K2/K3/K6 are held at this path's shapes.  Then
       one DP step on the ranks against its one-process
       emulation on the card, in f32 (DP_TOL_F32) and bf16 (DP_TOL_BF16),
       the ranks bit for bit; the same bf16 step with a planted fault (rank
       1 keeps its own running statistics) must fail both checks.
    2. A ``Trainer`` on every rank fits one epoch (2 global steps and the
       rank-0 validation), the launch counts set to 0 just before and read
       just after: every rank's parameters and buffers bit for bit equal
       to rank 0's (broadcast, max |d|), K1 and K2 launched on every rank
       on the tensor-core body, exactly one checkpoint, and a resume on
       every rank restores it bit for bit; wall seconds per global step,
       each rank's device seconds per step (CUDA events) and peak memory.

    Returns the launches summed over the ranks' fits."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from tdwss_torch.data.dataset import expand_subclouds
    from tdwss_torch.data.loader import steps_per_epoch, train_batches
    from tdwss_torch.data.synthetic import make_dataset
    from tdwss_torch.engine import train as train_mod
    from tdwss_torch.models.sparse_encoders import plane_schedule
    from tdwss_torch.ops import windowed as W
    from tdwss_torch.ops.host_plan import reset_sticky_plans

    cfg = dp_config()
    if cfg.mesh.data != DP_WORLD:
        raise AssertionError(f"{DP_CONFIG}: mesh.data {cfg.mesh.data}")
    t = time.perf_counter()
    whole = make_dataset(DP_SCENES, num_points=POINTS_PER_SCENE, seed=13,
                         with_text=False)
    train = expand_subclouds(whole, in_radius=cfg.in_radius)
    val = make_dataset(2, num_points=POINTS_PER_SCENE, seed=17,
                       with_text=False)
    spe = steps_per_epoch(len(train), cfg.pointcloud_data.batch_size)
    local = train_mod.local_config(cfg, DP_WORLD)
    log(f"DP: {DP_CONFIG}: {cfg.pointcloud_model.name} m="
        f"{cfg.pointcloud_model.m}, planes "
        f"{plane_schedule(cfg.pointcloud_model)}, "
        f"{cfg.engine.compute_dtype}, global batch "
        f"{cfg.pointcloud_data.batch_size} = {DP_WORLD} ranks x "
        f"{local.pointcloud_data.batch_size}, max_points "
        f"{cfg.engine.max_points}, lr {cfg.lr}; {len(train)} subclouds "
        f"(radius {cfg.in_radius}) of {DP_SCENES} scenes x "
        f"{POINTS_PER_SCENE} points, {int(np.mean([s.points.shape[0] for s in train]))} "
        f"points each on average, {spe} global steps per epoch; 2 val "
        f"scenes; in {time.perf_counter() - t:.2f} s")
    if spe < 2:
        raise AssertionError("DP: fewer than 2 global steps per epoch")
    work = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        reset_sticky_plans()
        t = time.perf_counter()
        batches = []
        for b in train_batches(train, local, 1, prefetch=False):
            batches.append(b)
            if len(batches) == DP_WORLD:
                break
        plan_s = time.perf_counter() - t
        log(f"DP: {DP_WORLD} batches of {local.pointcloud_data.batch_size} "
            f"subclouds planned on the host in {plan_s:.2f} s")
        for r, b in enumerate(batches):
            torch.save(b, os.path.join(work, f"batch{r}.pt"))
        torch.save({"train": train, "val": val},
                   os.path.join(work, "scenes.pt"))
        emu = {}
        for dtype in ("float32", "bfloat16"):
            t = time.perf_counter()
            emu[dtype] = _dp_emulation(local, batches, spe, dtype, device)
            torch.cuda.synchronize()
            log(f"DP: one-process emulation of one {dtype} step "
                f"({DP_WORLD} batches in turn, averaged): loss "
                f"{emu[dtype][0]:.6f} in {time.perf_counter() - t:.2f} s")
        # K1/K2/K3/K6 at this path's own shapes, which neither the sweeps
        # nor the earlier paths see: rank 0's batch through the kernels
        # against the plain versions, layer by layer and the loss parts
        # in bf16 and f32 (the launches of this check count nowhere)
        phase_train("DP: rank 0's batch", local, batches[0], batches[0],
                    plan_s / DP_WORLD, device, 1, full_checks=False,
                    f32_loss=True)
        del batches
        torch.cuda.empty_cache()

        t = time.perf_counter()
        ctx = mp.start_processes(_dp_rank, args=(DP_WORLD, work, cfg, spe,
                                                   str(device)),
                                 nprocs=DP_WORLD, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + DP_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise AssertionError(f"DP: the ranks did not finish in "
                                         f"{DP_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        log(f"DP: {DP_WORLD} ranks ran in {time.perf_counter() - t:.2f} s "
            f"(start, step parity, fault, fit, resume)")
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                            weights_only=False) for r in range(DP_WORLD)]
    finally:
        shutil.rmtree(work, ignore_errors=True)

    failures = []
    for dtype, tol in (("float32", DP_TOL_F32), ("bfloat16", DP_TOL_BF16)):
        want_loss, want = emu[dtype]
        ex_l, d_l = _excess(torch.tensor(ranks[0][dtype]["loss"]),
                            torch.tensor(want_loss), tol)
        ex, dmax, worst = _state_excess(ranks[0][dtype]["state"], want, tol)
        rep = max(r[dtype]["replica_diff"] for r in ranks)
        log(f"DP: one {dtype} step on {DP_WORLD} ranks vs the one-process "
            f"emulation: loss {ranks[0][dtype]['loss']:.8f} vs "
            f"{want_loss:.8f} (|d| {d_l:.3g}); parameters and running "
            f"statistics max|d| {dmax:.3g}, worst excess over rtol "
            f"{tol['rtol']:g} atol {tol['atol']:g}: {ex:.3g} ({worst}); "
            f"ranks vs rank 0 max|d| {rep:.3g}")
        if ex_l > 0 or ex > 0 or rep != 0:
            failures.append(f"{dtype} step")
    f_ex, f_dmax, f_worst = _state_excess(ranks[1]["fault"]["state"],
                                          emu["bfloat16"][1], DP_TOL_BF16)
    f_rep = max(r["fault"]["replica_diff"] for r in ranks)
    caught = f_ex > 0 and f_rep > 0
    log(f"DP: planted fault (rank 1 keeps its own running statistics in one "
        f"bf16 step): rank 1 vs the emulation max|d| {f_dmax:.3g}, excess "
        f"{f_ex:.3g} ({f_worst}); ranks vs rank 0 max|d| {f_rep:.3g}; "
        f"caught: {caught}")
    if not caught:
        failures.append("the planted fault was not caught")

    for r, res in enumerate(ranks):
        dev_s = res["device_s"]
        starts = res["step_starts"]
        wall = ([b - a for a, b in zip(starts, starts[1:])]
                if len(starts) > 1 else [])
        log(f"DP: rank {r}: Trainer built in {res['build_s']:.2f} s (plan "
            f"shapes warmed over epochs {res['warmed_epochs']}), fit(epochs"
            f"=1) {res['fit_s']:.2f} s, {res['steps']} steps, mean loss "
            f"{res['history'][0]:.6f}; device s per step (CUDA events) "
            f"{', '.join(f'{x:.3f}' for x in dev_s)}; wall s between step "
            f"starts {', '.join(f'{x:.3f}' for x in wall)}; peak device "
            f"memory {res['peak_gib']:.2f} GiB; launches {res['launches']}")
        bodies = res["bodies"]
        ok_bodies = all(not bodies[f"{k}:{W.BODY_FMA}"]
                        and bodies[f"{k}:{W.BODY_MMA}"] == res["launches"][k]
                        for k in (W.K1, W.K4, W.K2, W.K3, W.K5, W.K6))
        if not (res["launches"][W.K1] and res["launches"][W.K2]
                and ok_bodies):
            failures.append(f"rank {r}: K1/K2 not launched on the "
                            f"tensor-core body: {bodies}")
        if res["steps"] != spe or not math.isfinite(res["history"][0]):
            failures.append(f"rank {r}: {res['steps']} steps, loss "
                            f"{res['history']}")
        if res["replica_diff"] != 0:
            failures.append(f"rank {r}: state differs from rank 0's by "
                            f"{res['replica_diff']}")
        if res["resume_epoch"] != 2 or not res["resume_equal"]:
            failures.append(f"rank {r}: the resume differs")
    log(f"DP: after the fit, every rank's parameters and buffers vs rank "
        f"0's max|d| {max(r['replica_diff'] for r in ranks):.3g}; rank 0 "
        f"wrote {ranks[0]['checkpoints']}; resumed at epoch "
        f"{[r['resume_epoch'] for r in ranks]}, bit-identical "
        f"{[r['resume_equal'] for r in ranks]}; wall s per global step "
        f"(fit incl. the rank-0 validation / steps) "
        f"{ranks[0]['fit_s'] / max(ranks[0]['steps'], 1):.3f}; the NCCL "
        f"path over several cards is not run here")
    if ranks[0]["checkpoints"] != ["epoch_1.pt"]:
        failures.append(f"rank 0 wrote {ranks[0]['checkpoints']}")
    if failures:
        raise AssertionError("DP: " + "; ".join(failures))
    return {k: sum(r["launches"][k] for r in ranks)
            for k in ranks[0]["launches"]}


# ---------------------------------------------------------------------------
# The plans-free branch: the bench UNet with engine.host_plans false
# ---------------------------------------------------------------------------

PF_LOGITS_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-4}
PF_STEPS = 2


def phase_plans_free(scenes, device):
    """The bench UNet (m=32, 7 levels, bf16) with ``engine.host_plans:
    false`` on the bench batch: the points voxelized and every level's
    rulebooks built on the card, the convs on the rulebook routes.  With
    the launch counts set to 0 just before and read just after (all must
    stay 0): ``validate`` (1 rep), the per-point logits of the rep-1 batch
    in bf16 and f32, PF_STEPS training steps (device seconds, peak
    memory) and a warm step under sync debug mode (no synchronising
    call).  Then the same points through the host-planned path: logits
    within PF_LOGITS_TOL of max|host| and the first step's loss within
    LOSS_RTOL; host seconds per batch (collate alone against collate +
    plans + slim) and device seconds per step beside it.  Returns the
    launches."""
    import numpy as np
    import torch

    from tdwss_torch.data.collate import train_collate
    from tdwss_torch.data.dataset import val_offsets
    from tdwss_torch.data.loader import val_batches
    from tdwss_torch.engine.evaluate import validate
    from tdwss_torch.engine.steps import eval_step, make_optimizer, train_step
    from tdwss_torch.models.meta_arch import build_model
    from tdwss_torch.ops import windowed as W
    from tdwss_torch.ops.experimental import block_gather as BG
    from tdwss_torch.ops.host_plan import reset_sticky_plans

    def f32(cfg):
        cfg = copy.deepcopy(cfg)
        cfg.engine.compute_dtype = "float32"
        return cfg

    host_cfg = bench_config()
    host_cfg.pointcloud_data.val_reps = 1
    free_cfg = copy.deepcopy(host_cfg)
    free_cfg.engine.host_plans = False

    t = time.perf_counter()
    train_collate(scenes, free_cfg, np.random.default_rng(0))
    collate_s = time.perf_counter() - t
    planned, host, host_s = plan_train_batch(host_cfg, scenes,
                                             "plans-free (host-planned twin)")
    bare = dict(plans=None, vox_feats=None, point2voxel=None,
                point_perm=None)
    free_b = planned.replace(**bare).to(device)
    reset_sticky_plans()
    val_host = next(val_batches(scenes, host_cfg, val_offsets(scenes)[0], 1))
    val_free = val_host.replace(**bare).to(device)
    log(f"plans-free: host seconds per train batch: collate alone "
        f"{collate_s:.3f} s, against collate + plans + slim {host_s:.3f} s "
        f"on the host-planned path")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    W.reset_launches()
    BG.reset_launches()
    model = build_model(free_cfg, seed=0, device=device)
    t = time.perf_counter()
    ious = validate(free_cfg, model, scenes, reps=1, verbose=False,
                    device=device)
    log(f"plans-free: validate (1 rep, voxelize + rulebooks on the card): "
        f"{time.perf_counter() - t:.2f} s, mIoU {ious[-1]:.6f}")
    if len(ious) != 1 or not math.isfinite(ious[0]):
        raise AssertionError(f"plans-free: bad mIoU {ious}")
    logits = {"bfloat16": eval_step(model, val_free)}
    m32 = build_model(f32(free_cfg), seed=0, device=device)
    logits["float32"] = eval_step(m32, val_free)
    del m32
    tmodel = build_model(free_cfg, seed=0, device=device)
    opt, sched = make_optimizer(free_cfg, tmodel, STEPS_PER_EPOCH)
    free_loss, free_dev = [], []
    for _ in range(PF_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, _ = train_step(free_cfg, tmodel, opt, sched, free_b)
        torch.cuda.synchronize()
        free_dev.append(time.perf_counter() - t)
        free_loss.append(float(loss))
    peak = torch.cuda.max_memory_allocated() / 2**30
    syncs = list_syncs(lambda: train_step(free_cfg, tmodel, opt, sched,
                                          free_b))
    launches = dict(W.launches)
    launches.update(BG.launches)
    del tmodel, opt, sched
    log(f"plans-free: {PF_STEPS} train steps: losses "
        f"{', '.join(f'{x:.6f}' for x in free_loss)}; device s per step "
        f"(ended by a synchronise) {', '.join(f'{x:.3f}' for x in free_dev)}"
        f"; peak device memory {peak:.2f} GiB; synchronising calls in a "
        f"warm step: {len(syncs)} sites: {json.dumps(syncs)}; launches "
        f"(K1-K9) {launches}")

    failures = []
    if any(launches.values()):
        failures.append(f"a kernel was launched: {launches}")
    if syncs:
        failures.append("the warm plans-free step synchronises")
    if not all(math.isfinite(x) for x in free_loss):
        failures.append(f"non-finite loss {free_loss}")
    hmodel = build_model(host_cfg, seed=0, device=device)
    hb = val_host.to(device)
    host_logits = {"bfloat16": eval_step(hmodel, hb)}
    m32 = build_model(f32(host_cfg), seed=0, device=device)
    host_logits["float32"] = eval_step(m32, hb)
    del m32
    valid = val_free.valid
    for dtype, tol in PF_LOGITS_TOL.items():
        a, b = logits[dtype][valid].float(), host_logits[dtype][valid].float()
        d = (a - b).abs()
        scale = b.abs().max().item()
        log(f"plans-free vs host-planned logits ({dtype}, "
            f"{int(valid.sum())} points): max|d| {d.max().item():.6g} "
            f"(limit {tol:.3g} * max|host| {scale:.6g}), mean|d| "
            f"{d.mean().item():.6g}, argmax agreement "
            f"{(a.argmax(1) == b.argmax(1)).float().mean().item():.6f}")
        if not torch.isfinite(a).all() or d.max().item() > tol * scale:
            failures.append(f"{dtype} logits beyond {tol:.3g} * max|host|")
    del hmodel, hb
    hmodel = build_model(host_cfg, seed=0, device=device)
    opt, sched = make_optimizer(host_cfg, hmodel, STEPS_PER_EPOCH)
    hbatch = host.to(device)
    host_loss, host_dev = [], []
    for _ in range(PF_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, _ = train_step(host_cfg, hmodel, opt, sched, hbatch)
        torch.cuda.synchronize()
        host_dev.append(time.perf_counter() - t)
        host_loss.append(float(loss))
    rel = abs(free_loss[0] - host_loss[0]) / abs(host_loss[0])
    log(f"plans-free vs host-planned first-step loss (bf16): "
        f"{free_loss[0]:.6f} vs {host_loss[0]:.6f}, relative {rel:.3g} "
        f"(limit {LOSS_RTOL:g}); host-planned device s per step "
        f"{', '.join(f'{x:.3f}' for x in host_dev)} beside the plans-free "
        f"{', '.join(f'{x:.3f}' for x in free_dev)}")
    if rel > LOSS_RTOL:
        failures.append(f"first-step loss {rel} > {LOSS_RTOL}")
    del hmodel, opt, sched, hbatch
    if failures:
        raise AssertionError("plans-free: " + "; ".join(failures))
    return launches


# KPConv phase (KPFCNN at KPConvConfig()'s full width, f32): tolerances
# of the card against the CPU on the same weights and batch, measured on
# the card (H100, TF32 off) against an f64 step on the card host's CPU
# (``python3 -m tdwss_torch.tools.kpconv_grads``).  The CPU's and the
# card's f32 gradients stand 1.8-2.8% (norm) from the f64 ones and
# 1.2-1.7% from each other; two card runs stand 2.4e-6 apart (the
# gathers' embedding backward adds with atomics).  The spread is the f32
# step's own selections: f32 rounding flips about 220 of 5.3e7 leaky
# ReLU signs, 7-12 of 3.5e6 max-pool winners and 0-1 closest neighbours,
# and with the f64 step's selections replayed the f32 step stands
# 1.3e-4-1.5e-4 from f64 on either device.  So the f32 gradient limit is
# loose: a fault only in the backward (row 0 of every gather takes no
# gradient) moves the f32 gradients 3.9-4.2%, within it.  The backward is
# held in f64, where the card and the CPU make the same selections and
# stand 2.6e-13 apart at most, and where that fault reads 3.8%:
# - logits of a train forward: max|d| <= KP_LOGITS_TOL * max|cpu|;
# - the loss (CE + regulariser): relative KP_LOSS_RTOL;
# - each parameter's gradient: ||d|| <= KP_GRAD_RTOL * ||cpu|| over the
#   finite entries (phase_train's f32 limit), NaN exactly where the CPU
#   has NaN;
# - the same step in f64: logits, loss and each gradient within
#   KP_F64_RTOL (relative to max|cpu|, |cpu| and ||cpu||), NaN where the
#   CPU has NaN; a fault only in the backward (row 0 of every gather
#   takes no gradient) must break it;
# - the card's f32 step with the CPU's f32 selections replayed (ties
#   split as the CPU's step splits them), on the exact-size and on the
#   padded batch: each gradient within KP_REPLAY_RTOL of the CPU's step
#   (||d|| / ||cpu||).  With its selections fixed the f32 step differs by
#   rounding alone: 1.3e-4-1.7e-4 on the exact-size batch (H100, the
#   basis of the limit, read again in the phase), and so on the padded
#   one, where a replay of one winner per tie had read 0.73%
#   (``tools.kpconv_grads --bisect``: the CPU replaying its own).
KP_LOGITS_TOL = 5e-4
KP_LOSS_RTOL = 1e-5
KP_GRAD_RTOL = 0.05
KP_F64_RTOL = 1e-9
KP_REPLAY_RTOL = 5e-4
KP_SPHERES = 8
KP_STEPS = 3
KP_LR = 1e-3
REMAT_STEPS = 2


def phase_kpconv(scenes, device):
    """KPFCNN at ``KPConvConfig()`` as shipped (SCANNET_ARCHITECTURE,
    first_features_dim 64, 15 kernel points, dl 0.04, in_radius 2.0,
    deformable layers 2-4, 20 classes, f32) on KP_SPHERES spheres drawn
    by ``PotentialSampler`` from the scenes grid-subsampled at 0.04 m,
    neighbour limits from ``calibrate_neighbors``: the host pyramid
    (``segmentation_inputs``, timed), an eval forward, one train step's
    logits, loss and gradients on the card against the same weights and
    batch on the CPU (NaN sites included: the reference's padding rows
    give NaN offset gradients), in f32 and in f64, a fault only in the
    backward that the f64 check must catch, a planted fault (a shadow
    neighbour read as row 0) that the logits check must catch, KP_STEPS
    Adam steps with the deform group on the same spheres padded to their
    exact sizes (no padding rows; CUDA events, peak memory; the loss
    finite and falling, every parameter moved), and a warm step under
    sync debug mode."""
    import torch

    from tdwss_torch.models.kpconv import (KPFCNN, KPConvConfig,
                                           calibrate_neighbors, kpfcnn_loss,
                                           param_groups, segmentation_inputs)
    from tdwss_torch.models.kpconv import ops as kp_ops
    from tdwss_torch.tools.kpconv_grads import (Selections, draw_spheres,
                                                grad_errors, kpconv_clouds,
                                                row0_takes_no_gradient,
                                                step_outputs)

    cfg = KPConvConfig()
    t = time.perf_counter()
    clouds = kpconv_clouds(scenes, cfg)
    sub_s = time.perf_counter() - t
    t = time.perf_counter()
    spheres = draw_spheres(clouds, cfg, KP_SPHERES)
    sample_s = time.perf_counter() - t
    t = time.perf_counter()
    limits = calibrate_neighbors(spheres, cfg)
    calib_s = time.perf_counter() - t
    pyr_s = []
    for _ in range(2):
        t = time.perf_counter()
        host = segmentation_inputs(spheres, cfg, neighbor_limits=limits)
        pyr_s.append(time.perf_counter() - t)
    exact = [int(v.sum()) for v in host.valids]
    host_exact = segmentation_inputs(spheres, cfg, capacities=exact,
                                     neighbor_limits=limits)
    log(f"KPConv: {len(scenes)} scenes grid-subsampled at "
        f"{cfg.first_subsampling_dl} m in {sub_s:.3f} s "
        f"({', '.join(str(c['points'].shape[0]) for c in clouds)} points); "
        f"{len(spheres)} spheres of {cfg.in_radius} m drawn in "
        f"{sample_s:.3f} s ("
        + ", ".join(str(s["points"].shape[0]) for s in spheres)
        + f" points); neighbour limits {limits} calibrated in {calib_s:.3f} s;"
        f" host pyramid (segmentation_inputs) {pyr_s[0]:.3f} s, again "
        f"{pyr_s[1]:.3f} s; layer rows (valid / capacity): " + ", ".join(
            f"{int(v.sum())}/{v.shape[0]}" for v in host.valids)
        + "; neighbour widths " + ", ".join(
            str(n.shape[1]) for n in host.neighbors))

    model = KPFCNN(cfg, seed=0, device=device)
    cpu_model = KPFCNN(cfg, seed=0, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    batch = host.to(device)
    cpu_batch = host.to("cpu")
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with torch.no_grad():
        model(batch, train=False)                 # warm-up
        ev[0].record()
        logits, _ = model(batch, train=False)
        ev[1].record()
    ev[1].synchronize()
    eval_ms = ev[0].elapsed_time(ev[1])
    if logits.shape != (host.valids[0].shape[0], cfg.num_classes) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"KPConv: bad eval logits {logits.shape}")
    log(f"KPConv: KPFCNN, {n_params} parameters; eval forward on the card "
        f"{eval_ms:.3f} ms (CUDA events), logits {tuple(logits.shape)}")

    def model_step(m, b):
        m.zero_grad(set_to_none=True)
        lo, auxes = m(b, train=True)
        loss = kpfcnn_loss(lo, b.labels, auxes, cfg)
        loss.backward()
        return (lo.detach().cpu(), float(loss.detach()),
                {n: p.grad.detach().cpu() for n, p in m.named_parameters()})

    state = copy.deepcopy(model.state_dict())
    cpu_state = copy.deepcopy(cpu_model.state_dict())
    t = time.perf_counter()
    tape = Selections()             # recording leaves the step as it is
    with tape.active():
        lo_c, loss_c, g_c = model_step(cpu_model, cpu_batch)
    cpu_s = time.perf_counter() - t
    lo_g, loss_g, g_g = model_step(model, batch)
    model.load_state_dict(state)
    cpu_model.load_state_dict(cpu_state)
    d_lo = (lo_g - lo_c).abs().max().item() / lo_c.abs().max().item()
    d_loss = abs(loss_g - loss_c) / abs(loss_c)
    worst, nan_params, failures = [], [], []
    for n in g_c:
        a, b = g_g[n], g_c[n]
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            failures.append(f"NaN sites of {n}'s gradient differ")
        fin = torch.isfinite(b)
        if torch.isnan(b).any():
            nan_params.append(n)
        if fin.any():
            ref = torch.linalg.vector_norm(b[fin]).item()
            worst.append((torch.linalg.vector_norm(a[fin] - b[fin]).item()
                          / max(ref, 1e-30),
                          (a[fin] - b[fin]).abs().max().item()
                          / max(b[fin].abs().max().item(), 1e-30), n))
    worst.sort(reverse=True)
    log(f"KPConv: one train step on the card vs the CPU ({cpu_s:.2f} s on "
        f"the CPU): logits max|d| / max|cpu| {d_lo:.3g} (limit "
        f"{KP_LOGITS_TOL}); loss {loss_g:.8f} vs {loss_c:.8f}, relative "
        f"{d_loss:.3g} (limit {KP_LOSS_RTOL}); gradients ||d|| / ||cpu|| "
        f"(and max|d| / max|cpu|) over {len(worst)} tensors, largest: "
        + ", ".join(f"{n} {r:.3g} ({m:.3g})" for r, m, n in worst[:3])
        + f" (limit {KP_GRAD_RTOL}); NaN gradients (the padding rows' zero "
        f"distance, as the reference) in {nan_params}")
    if d_lo > KP_LOGITS_TOL or d_loss > KP_LOSS_RTOL or \
            worst[0][0] > KP_GRAD_RTOL:
        failures.append("the card disagrees with the CPU")

    # the card's f32 step with the CPU's f32 selections, exact-size batch
    # first (the basis of the limit), then the padded one
    t = time.perf_counter()
    exact_tape = Selections()
    cpu_runs = {"exact": step_outputs(cfg, host_exact, "cpu", torch.float32,
                                      selections=exact_tape),
                "padded": (lo_c.double(), loss_c,
                           {n: g.double() for n, g in g_c.items()})}
    tapes = {"exact": exact_tape, "padded": tape}
    exact_cpu_s = time.perf_counter() - t
    for name, hb in (("exact", host_exact), ("padded", host)):
        sel = Selections(replay=tapes[name])
        lo_r, loss_r, g_r = step_outputs(cfg, hb, device, torch.float32,
                                         selections=sel)
        ref = cpu_runs[name]
        errs = grad_errors(g_r, ref[2])
        nan_same = all(torch.equal(torch.isnan(g_r[n]), torch.isnan(b))
                       for n, b in ref[2].items())
        log(f"KPConv: f32 step on the card with the CPU's f32 selections "
            f"replayed, {name} batch (the CPU's step {exact_cpu_s:.2f} s "
            f"for the exact one): logits max|d| / max|cpu| "
            f"{(lo_r - ref[0]).abs().max().item() / ref[0].abs().max().item():.3g}"
            f", loss relative {abs(loss_r - ref[1]) / abs(ref[1]):.3g}; "
            f"gradients ||d|| / ||cpu|| up to {errs[0][0]:.3g} (limit "
            f"{KP_REPLAY_RTOL}, from the exact-size readings), largest: "
            + ", ".join(f"{n} {a:.3g} ({m:.3g})" for a, m, n in errs[:3])
            + f"; NaN sites the same: {nan_same}; the card's own choices "
            f"that differ from the CPU's: " + ", ".join(
                f"{k} {sel.flips[k]} of {sel.entries[k]}"
                for k in sel.entries) + "; the CPU's max / min reductions "
            "that tie (split by the replay as by amax / amin): " + ", ".join(
                f"{k} {v}" for k, v in tapes[name].ties.items()))
        if errs[0][0] > KP_REPLAY_RTOL or not nan_same:
            failures.append(f"the card's f32 step with the CPU's "
                            f"selections disagrees on the {name} batch")
    del cpu_runs, tapes, tape, exact_tape

    t = time.perf_counter()
    ref64 = step_outputs(cfg, host, "cpu", torch.float64)
    cpu64_s = time.perf_counter() - t
    for label, take in (("clean", None), ("fault", row0_takes_no_gradient)):
        lo64, loss64, g64 = step_outputs(cfg, host, device, torch.float64,
                                         take=take)
        errs = grad_errors(g64, ref64[2])
        d64 = max((lo64 - ref64[0]).abs().max().item()
                  / ref64[0].abs().max().item(),
                  abs(loss64 - ref64[1]) / abs(ref64[1]), errs[0][0])
        nan_same = all(torch.equal(torch.isnan(g64[n]), torch.isnan(b))
                       for n, b in ref64[2].items())
        log(f"KPConv: f64 step ({label}) on the card vs the CPU "
            f"({cpu64_s:.2f} s on the CPU): logits, loss and gradients "
            f"relative up to {d64:.3g} (limit {KP_F64_RTOL}), largest "
            f"gradients: " + ", ".join(f"{n} {r:.3g} ({m:.3g})"
                                       for r, m, n in errs[:3])
            + f"; NaN sites the same: {nan_same}")
        if label == "clean" and (d64 > KP_F64_RTOL or not nan_same):
            failures.append("the f64 step disagrees with the CPU's")
        if label == "fault" and not d64 > KP_F64_RTOL:
            failures.append("the backward-only fault was not caught")
    _, _, g32 = step_outputs(cfg, host, device, torch.float32,
                             take=row0_takes_no_gradient)
    r32 = grad_errors(g32, {n: b.double() for n, b in g_c.items()})[0]
    side = "above" if r32[0] > KP_GRAD_RTOL else "within"
    log(f"KPConv: the same fault in f32: gradients ||d|| / ||cpu|| up to "
        f"{r32[0]:.3g} ({r32[2]}): {side} the f32 limit {KP_GRAD_RTOL}")
    del ref64, g32

    def shadow_reads_row0(x, idx, fill):
        n = x.shape[0]
        safe = torch.where((idx >= 0) & (idx < n), idx, 0)
        return x[safe.long()]

    saved = kp_ops._take_fill
    kp_ops._take_fill = shadow_reads_row0
    try:
        with torch.no_grad():
            faulty, _ = model(batch, train=True)
    finally:
        kp_ops._take_fill = saved
    model.load_state_dict(state)
    with torch.no_grad():
        clean, _ = cpu_model(cpu_batch, train=True)
    cpu_model.load_state_dict(cpu_state)
    d_fault = ((faulty.cpu() - clean).abs().max().item()
               / clean.abs().max().item())
    log(f"KPConv: planted fault (a shadow neighbour read as row 0): logits "
        f"max|d| / max|cpu| {d_fault:.3g} against the limit "
        f"{KP_LOGITS_TOL}")
    if not d_fault > KP_LOGITS_TOL:
        failures.append("the planted fault was not caught")
    del cpu_model, cpu_batch

    ebatch = host_exact.to(device)
    opt = torch.optim.Adam(param_groups(model, KP_LR), betas=(0.9, 0.999),
                           eps=1e-8)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def train_one():
        opt.zero_grad(set_to_none=True)
        lo, auxes = model(ebatch, train=True)
        loss = kpfcnn_loss(lo, ebatch.labels, auxes, cfg)
        loss.backward()
        opt.step()
        return loss.detach()

    losses, step_ms = [], []
    for _ in range(KP_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        losses.append(train_one())
        ev[1].record()
        ev[1].synchronize()
        step_ms.append(ev[0].elapsed_time(ev[1]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in losses]
    unmoved = [n for n, p in model.named_parameters()
               if torch.equal(p.detach(), before[n])]
    syncs = list_syncs(train_one)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_one()
        torch.cuda.synchronize()
    # the host-side operations: each kernel's time counts once, under the
    # operation that launched it
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in ops) / 1e3
    log(f"KPConv: one warm step traced: kernels {dev_ms:.3f} ms in all "
        f"(beside the untraced step's {step_ms[-1]:.3f} ms), top "
        f"operations by self device time: " + ", ".join(
            f"{e.key} {e.self_device_time_total / 1e3:.3f} ms / {e.count}"
            for e in ops[:8]))
    log(f"KPConv: {KP_STEPS} Adam steps (lr {KP_LR}, deform group x"
        f"{cfg.deform_lr_factor}) on the spheres at their exact sizes "
        f"({', '.join(str(c) for c in exact)} rows): losses "
        f"{', '.join(f'{x:.6f}' for x in losses)}; device ms per step "
        f"(CUDA events) {', '.join(f'{x:.3f}' for x in step_ms)}; peak "
        f"device memory {peak:.2f} GiB; parameters that did not move: "
        f"{unmoved}; synchronising calls in a warm step: {len(syncs)} "
        f"sites: {json.dumps(syncs)}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        failures.append(f"the training loss is not finite and falling: "
                        f"{losses}")
    if unmoved:
        failures.append(f"parameters that did not move: {unmoved}")
    if syncs:
        failures.append("a warm KPFCNN step synchronises")
    if failures:
        raise AssertionError("KPConv: " + "; ".join(failures))


def phase_remat(scenes, device):
    """The bench UNet (m=32, block_reps 2, residual, 7 levels, bf16) with
    ``engine.remat: true`` on the bench batch: REMAT_STEPS training steps
    with the launch counts set to 0 just before and read just after,
    equal to the plans' routing with the body's forward counted twice
    (every launch on the tensor-core body); the same steps without remat
    from the same weights, the losses, the last step's gradients, the
    parameters and the running statistics bit for bit; peak memory and
    device ms per step of both.  Returns the remat run's launches."""
    import torch

    from tdwss_torch.engine.steps import make_optimizer, train_step
    from tdwss_torch.models.meta_arch import build_model
    from tdwss_torch.ops import windowed as W

    cfg = bench_config()
    cfg.engine.remat = True
    _, host, _ = plan_train_batch(cfg, scenes, "remat")
    batch = host.to(device)
    runs, want = {}, None
    for remat in (True, False):
        c = copy.deepcopy(cfg)
        c.engine.remat = remat
        model = build_model(c, seed=0, device=device)
        if model.pc_encoder.remat is not remat:
            raise AssertionError("engine.remat did not reach the encoder")
        if remat:
            fwd = expected_launches(model, host.plans, train=False)
            level0 = host.plans.levels[0].win
            fwd[W.K1 if level0.sub else W.K4] -= 1   # the stem is outside
            if level0.spill_order.entries:           # the body
                fwd[W.K8] -= 1
            per_step = expected_launches(model, host.plans, train=True)
            want = {k: (v + fwd[k]) * REMAT_STEPS
                    for k, v in per_step.items()}
        opt, sched = make_optimizer(c, model, STEPS_PER_EPOCH)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        W.reset_launches()
        losses, step_ms = [], []
        for _ in range(REMAT_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            loss, _ = train_step(c, model, opt, sched, batch)
            ev[1].record()
            ev[1].synchronize()
            step_ms.append(ev[0].elapsed_time(ev[1]))
            losses.append(loss.detach())
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = dict(W.launches)
        if remat:
            check_bodies("remat")
        runs[remat] = dict(
            losses=[float(x) for x in losses], ms=step_ms, peak=peak,
            launches=launches,
            grads={n: p.grad.detach().cpu()
                   for n, p in model.named_parameters()},
            state={k: v.detach().cpu()
                   for k, v in model.state_dict().items()})
        del model, opt, sched
    on, off = runs[True], runs[False]
    same = (on["losses"] == off["losses"]
            and all(torch.equal(on["grads"][n], off["grads"][n])
                    for n in off["grads"])
            and all(torch.equal(on["state"][k], off["state"][k])
                    for k in off["state"]))
    log(f"remat: {REMAT_STEPS} bf16 steps with engine.remat: losses "
        f"{on['losses']}, device ms per step (CUDA events) "
        f"{', '.join(f'{x:.3f}' for x in on['ms'])}, peak device memory "
        f"{on['peak']:.3f} GiB; without remat: losses {off['losses']}, "
        f"device ms per step {', '.join(f'{x:.3f}' for x in off['ms'])}, "
        f"peak {off['peak']:.3f} GiB; losses, last gradients, parameters "
        f"and running statistics bit-identical: {same}")
    log(f"remat: launches in {REMAT_STEPS} steps {on['launches']}; the "
        f"plans' routing with the body's forward twice {want}; without "
        f"remat {off['launches']}")
    if on["launches"] != want or not on["launches"][W.K1]:
        raise AssertionError(f"remat: launches differ from the plans' "
                             f"routing with the body twice: "
                             f"{on['launches']} vs {want}")
    if not same:
        raise AssertionError("remat: the steps differ from the steps "
                             "without remat")
    return on["launches"]


OFFLINE_RES = 256
OFFLINE_MAX_BOXES = 64             # pointcloud_data.max_boxes
OFFLINE_CENTER = (0.25, -0.5, 0.1)  # the prep 'center' stored with the scenes
GSS_IOU = 0.75                     # generate_proposals' NMS threshold
PROJ_VIEWS_TOL = 1e-5              # of max|cpu views|
PROJ_GRAD_TOL = 1e-4               # of each CPU gradient's max
MASK_TOL = 1e-5                    # of max|cpu mask|
MASK_IMAGES = 8
BOX_VIEWS = 3
BOX_RADIUS, BOX_NSAMPLE = 4.0, 3
BOX_CPU_POINTS = 40_000            # points of the boxes held against the CPU
BOX_SAMPLE_SEED = 0                # the seeded draw of those boxes
BOX_STRATA = 4                     # quartiles of proposal order and of size
FLIP_ULPS = 8                      # a flipped pair's |d2 - r^2| in ulps of r^2


def _rel_err(got, want):
    """max|got - want| / max|want| over two tensors (any devices)."""
    import torch

    g = got.detach().to("cpu", torch.float64)
    w = want.detach().to("cpu", torch.float64)
    return ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()


def box_sample(inside, budget, seed):
    """The boxes held against the CPU: a seeded sample of the boxes with
    points, stratified by proposal order and by size (BOX_STRATA
    quantiles of each), within ``budget`` points in all.  It starts with
    the largest box that fits the budget, then draws one box from each
    (order, size) cell in rounds, each a seeded pick among the cell's
    boxes that still fit, until no cell has one: the cells of the smaller
    sizes first (so that the large boxes do not take the budget before
    every stratum has its box), those of one size in a seeded order.
    Returns (indices in proposal order, points, the order and size strata
    they cover, the largest box that fits)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    boxes = [i for i, n in enumerate(inside) if n]
    by_size = sorted(boxes, key=lambda i: (inside[i], i))
    size_q = {i: r * BOX_STRATA // len(boxes) for r, i in enumerate(by_size)}
    order_q = {i: r * BOX_STRATA // len(boxes) for r, i in enumerate(boxes)}
    fits = [i for i in boxes if inside[i] <= budget]
    largest = max(fits, key=lambda i: (inside[i], -i))
    held, total = {largest}, inside[largest]
    cells = [(o, z) for z in range(BOX_STRATA)
             for o in rng.permutation(BOX_STRATA)]
    added = True
    while added:
        added = False
        for o, z in cells:
            members = [i for i in boxes
                       if (order_q[i], size_q[i]) == (o, z)
                       and i not in held and total + inside[i] <= budget]
            if members:
                i = members[int(rng.integers(len(members)))]
                held.add(i)
                total += inside[i]
                added = True
    held = sorted(held)
    return (held, total, sorted({order_q[i] for i in held}),
            sorted({size_q[i] for i in held}), largest)


def synthetic_images(n, size, seed):
    """``n`` white ``size``x``size`` images, each with one filled shape
    (a disc, a rectangle or a triangle) of a random dark colour."""
    import numpy as np

    rng = np.random.default_rng(seed)
    imgs = np.full((n, size, size, 3), 255, np.uint8)
    yy, xx = np.mgrid[:size, :size]
    for i in range(n):
        cy, cx = rng.integers(size // 3, 2 * size // 3, 2)
        r = int(rng.integers(size // 10, size // 4))
        if i % 3 == 0:
            shape = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        elif i % 3 == 1:
            shape = (abs(yy - cy) < r) & (abs(xx - cx) < 0.6 * r)
        else:
            shape = ((yy > cy - r) & (yy < cy + r)
                     & (abs(xx - cx) < (yy - cy + r) / 2))
        imgs[i][shape] = rng.integers(0, 200, 3)
    return imgs


def check_neighbours(label, card_in, cpu_in, res, radius, nsample, device):
    """The ball queries of one render's inputs, (coords (B, N, 2), feats
    (B, N, C), points_num (B,)) as each side made them, on the card and on
    the CPU: the rows whose indices differ, each explained by a flipped
    (pixel, support) pair whose squared distance lies within FLIP_ULPS
    ulps of radius**2 on either side.  Returns (card masks with the CPU's
    indices, CPU masks, the flipped rows as a (B, H * W) bool array)."""
    import numpy as np
    import torch

    from tdwss_torch.ops.point2mask import (canvas_coords,
                                            masks_from_neighbours,
                                            neighbours, pixel_samples)

    sides = {}
    for dev, (crds, fts, pn) in ((device, card_in), ("cpu", cpu_in)):
        c = torch.from_numpy(np.ascontiguousarray(crds, np.float32)).to(dev)
        n = torch.from_numpy(np.asarray(pn)).to(dev)
        sides[str(dev)] = (c, n, neighbours(c, res, n, radius, nsample),
                           torch.from_numpy(np.ascontiguousarray(
                               fts, np.float32)).to(dev))
    card, cpu = sides[str(device)], sides["cpu"]
    idx_card, idx_cpu = card[2].cpu().numpy(), cpu[2].numpy()
    rows = (idx_card != idx_cpu).any(-1)
    r2 = np.float32(radius * radius)
    ulp = np.spacing(r2)
    samples = pixel_samples(res, "cpu").numpy()
    worst, pairs = 0.0, 0
    for b, p in np.argwhere(rows):
        d2 = {}
        for key, side in (("card", card), ("cpu", cpu)):
            canvas = canvas_coords(side[0][b:b + 1], res)[0].cpu().numpy()
            dx = samples[p, 0] - canvas[:, 0]
            dy = (samples[p, 1] - canvas[:, 1]).astype(np.float64)
            d2[key] = (dy * dy + (dx * dx).astype(np.float64)).astype(
                np.float32)
        live = np.arange(canvas.shape[0]) < int(cpu[1][b])
        flips = live & ((d2["card"] <= r2) != (d2["cpu"] <= r2))
        if not flips.any():
            raise AssertionError(f"{label}: the indices of row ({b}, {p}) "
                                 f"differ with no flipped pair")
        off = np.abs(np.concatenate([d2["card"][flips], d2["cpu"][flips]])
                     - r2) / ulp
        worst, pairs = max(worst, float(off.max())), pairs + int(flips.sum())
    log(f"{label}: ball queries card vs CPU: {int(rows.sum())} of "
        f"{rows.size} rows differ, {pairs} flipped (pixel, support) pairs, "
        f"each within {worst:.1f} ulps of radius**2 = {float(r2)} (limit "
        f"{FLIP_ULPS})")
    if worst > FLIP_ULPS:
        raise AssertionError(f"{label}: a flipped pair lies {worst} ulps "
                             f"from the radius")
    replay = masks_from_neighbours(torch.from_numpy(idx_cpu).to(device),
                                   card[3], res)
    return replay, masks_from_neighbours(cpu[2], cpu[3], res), rows


def phase_offline(scenes, device):
    """GSS proposals, the box collate, the projector on the bench UNet's
    logits, ``Box2Mask`` and the pseudo-image mask pipeline, each against
    the CPU (see the module docstring, item 17).  Returns the launches of
    the eval forward."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from tdwss_torch import gss, native
    from tdwss_torch.convert import flax_to_state_dict
    from tdwss_torch.data.collate import train_collate
    from tdwss_torch.data.dataset import load_processed_dir
    from tdwss_torch.data.plans import attach_host_plans
    from tdwss_torch.engine.steps import eval_step
    from tdwss_torch.gss.eval import center_extent_to_corners
    from tdwss_torch.gss.search import _box_iou_3d
    from tdwss_torch.models.meta_arch import build_model
    from tdwss_torch.models.projector import (Projector, crop_rows,
                                              project_from_batch)
    from tdwss_torch.ops import windowed as W
    from tdwss_torch.ops.host_plan import reset_sticky_plans
    from tdwss_torch.ops.point2mask import (Box2Mask, Pixel2Mask,
                                            point2mask_module, render_inputs)
    from tdwss_torch.ops.pseudo_images import (PseudoImageConfig,
                                               extract_mask, filter_images,
                                               run_mask_pipeline)

    # 1. GSS on the first scene at its full point count
    native.require()
    timings = {}
    t = time.perf_counter()
    boxes = gss.generate_proposals(scenes[0].points,
                                   rng=np.random.default_rng(0),
                                   timings=timings)
    gss_s = time.perf_counter() - t
    iou = _box_iou_3d(boxes, boxes)
    np.fill_diagonal(iou, 0.0)
    log(f"offline: GSS on {scenes[0].name} ({scenes[0].points.shape[0]} "
        f"points) in {gss_s:.3f} s: normals {timings['normals']:.3f} s, "
        f"region growing {timings['region_grow']:.3f} s "
        f"({timings['regions']} regions), merging {timings['merge']:.3f} s "
        f"({timings['merged']} merged regions), boxes and NMS "
        f"{timings['nms']:.3f} s; {boxes.shape[0]} proposals, largest IoU "
        f"between two kept boxes {float(iou.max()):.4f} (limit {GSS_IOU})")
    if (boxes.shape[0] < 2 or not np.isfinite(boxes).all()
            or (boxes[:, 3:6] < 0).any()):
        raise AssertionError(f"offline: bad GSS boxes {boxes.shape}")
    if iou.max() > GSS_IOU:
        raise AssertionError("offline: two kept GSS boxes overlap beyond "
                             "the NMS threshold")

    # 2. the scenes and their boxes through the dataset and the collate
    cfg = bench_config()
    cfg.pointcloud_data.with_boxes = True
    cfg.pointcloud_data.max_boxes = OFFLINE_MAX_BOXES
    center = np.asarray(OFFLINE_CENTER, np.float32)
    work = tempfile.mkdtemp(prefix="chip_smoke_offline_")
    try:
        data_dir = os.path.join(work, "train_processed")
        box_dir = os.path.join(work, "proposals")
        os.makedirs(data_dir)
        os.makedirs(box_dir)
        for s in scenes:
            np.savez(os.path.join(data_dir, f"{s.name}.npz"),
                     points=s.points - center, colors=s.colors,
                     labels=s.labels, center=center)
            np.save(os.path.join(box_dir, f"{s.name}_prop.npy"), boxes)
        loaded = load_processed_dir(data_dir, box_path=box_dir)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"offline: {len(loaded)} scenes written as .npz (points less the "
        f"center {OFFLINE_CENTER}) with {scenes[0].name}'s proposals as "
        f"every scene's (GSS runs on one scene only, to keep the phase "
        f"short), loaded with with_boxes, max_boxes {OFFLINE_MAX_BOXES}")
    reset_sticky_plans()
    t = time.perf_counter()
    host = attach_host_plans(train_collate(loaded, cfg,
                                           np.random.default_rng(0)), cfg)
    host_s = time.perf_counter() - t
    b = host.to(device)
    if b.box is None or b.box.boxes.device.type != torch.device(device).type:
        raise AssertionError("offline: the batch lost its boxes on the way "
                             "to the card")
    n_boxes = int(host.box.valid.sum())
    log(f"offline: train batch with boxes (collate + plans) {host_s:.3f} "
        f"s; {n_boxes} valid boxes of {host.box.valid.size}")

    # 3. the bench UNet's eval forward, then the projector
    model = build_model(cfg, seed=0, device=device)
    W.reset_launches()
    logits = eval_step(model, b)
    torch.cuda.synchronize()
    launches = dict(W.launches)
    check_bodies("offline forward")
    want = expected_launches(model, host.plans, train=False)
    log(f"offline: launches in the eval forward {launches}; routed by the "
        f"plans {want}")
    if launches != want or not launches[W.K1]:
        raise AssertionError("offline: the forward's launches differ from "
                             "the plans' routing")
    del model
    rng = np.random.default_rng(0)
    weights = flax_to_state_dict({"matting": {"model": {
        "kernel": (rng.normal(size=(20, 2)) * 0.3).astype(np.float32),
        "bias": rng.normal(size=2).astype(np.float32)}}})

    def projector(dev):
        proj = Projector(20, 2, OFFLINE_RES, "HWZ", device=dev)
        proj.load_state_dict(weights)
        return proj

    def project(dev, batch, feats):
        proj = projector(dev)
        f = feats.detach().to(dev).requires_grad_(True)
        views = project_from_batch(batch, f, proj)
        views.sum().backward()
        m = proj.matting.model
        return views.detach(), {"Matting weight": m.weight.grad,
                                "Matting bias": m.bias.grad,
                                "point logits": f.grad}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    views, grads = project(device, b, logits)
    torch.cuda.synchronize()
    proj_ms = (time.perf_counter() - t) * 1e3
    proj_peak = torch.cuda.max_memory_allocated() / 2**30
    t = time.perf_counter()
    cpu_views, cpu_grads = project("cpu", host, logits.cpu())
    cpu_ms = (time.perf_counter() - t) * 1e3
    m_views = 3 * n_boxes
    if (tuple(views.shape) != (m_views, 2, OFFLINE_RES, OFFLINE_RES)
            or not torch.isfinite(views).all() or not views.abs().sum()):
        raise AssertionError(f"offline: bad views {tuple(views.shape)}")
    errs = {"views": _rel_err(views, cpu_views)}
    errs.update({k: _rel_err(grads[k], cpu_grads[k]) for k in grads})
    with torch.no_grad():
        eye = torch.eye(3, dtype=b.box.rot_inv.dtype, device=device)
        bad = b.replace(box=dataclasses.replace(
            b.box, rot_inv=eye.expand_as(b.box.rot_inv).contiguous()))
        bad_err = _rel_err(project_from_batch(bad, logits,
                                              projector(device)), cpu_views)
    log(f"offline: project_from_batch ({n_boxes} boxes, resolution "
        f"{OFFLINE_RES}, views HWZ) forward + backward on the card "
        f"{proj_ms:.1f} ms (host crop included), peak device memory "
        f"{proj_peak:.3f} GiB; on the CPU {cpu_ms:.1f} ms; card vs CPU, "
        f"max|d| / max|cpu|: " + ", ".join(f"{k} {v:.3g}"
                                            for k, v in errs.items())
        + f" (limits {PROJ_VIEWS_TOL} views, {PROJ_GRAD_TOL} gradients); "
        f"planted fault (the crop without rot_inv) {bad_err:.3g}")
    if errs["views"] > PROJ_VIEWS_TOL or any(
            v > PROJ_GRAD_TOL for k, v in errs.items() if k != "views"):
        raise AssertionError("offline: the projector on the card disagrees "
                             "with the CPU")
    if not bad_err > PROJ_VIEWS_TOL:
        raise AssertionError("offline: the planted crop fault was not "
                             "caught")

    # 4. Box2Mask on the first scene's points, logits and boxes
    sel = np.nonzero((host.coords[:, 3] == 0) & host.valid)[0]
    align, centers, rot_inv, offsets = host.box.transform_tuple()
    pc = (host.coords[sel, :3].astype(np.float64) - offsets[0]) \
        @ rot_inv[0] + centers[0]
    xyz = (np.concatenate([pc, np.ones((pc.shape[0], 1))], 1)
           @ align[0].T)[:, :3].astype(np.float32)[None]
    feats = logits[torch.from_numpy(sel).to(device)].cpu().numpy()[None]
    corners = center_extent_to_corners(boxes).astype(np.float32)[None]
    theta = (np.arange(BOX_VIEWS) * 2 * np.pi / BOX_VIEWS).astype(np.float32)
    phi = np.full(BOX_VIEWS, 0.35, np.float32)
    fronts = {str(dev): Box2Mask(radius=BOX_RADIUS, nsample=BOX_NSAMPLE,
                                 device=dev) for dev in (device, "cpu")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    masks = fronts[str(device)](xyz, feats, corners, OFFLINE_RES, theta, phi)
    torch.cuda.synchronize()
    box_ms = (time.perf_counter() - t) * 1e3
    box_peak = torch.cuda.max_memory_allocated() / 2**30
    if not torch.isfinite(masks).all() or masks.shape[1:] != (
            3, OFFLINE_RES, OFFLINE_RES):
        raise AssertionError(f"offline: bad Box2Mask masks "
                             f"{tuple(masks.shape)}")
    # The CPU's ball query scans (pixels x points in reach) pairs, minutes
    # for every box of the scene: a seeded sample of the boxes, spread
    # over proposal order and size, is held against the CPU, up to
    # BOX_CPU_POINTS points in all.
    inside = [int((np.all(xyz[0] <= c[3:6], -1)
                   & np.all(xyz[0] >= c[:3], -1)).sum())
              for c in corners[0]]
    held, total, orders, sizes, largest = box_sample(
        inside, BOX_CPU_POINTS, BOX_SAMPLE_SEED)
    log(f"offline Box2Mask: boxes held against the CPU (seed "
        f"{BOX_SAMPLE_SEED}, {BOX_STRATA} strata of proposal order x size, "
        f"{BOX_CPU_POINTS} points at most): {held} of "
        f"{sum(1 for n in inside if n)} with points, holding "
        f"{[inside[i] for i in held]} points ({total} in all); order "
        f"strata {orders}, size strata {sizes}; the largest box that fits, "
        f"{largest} ({inside[largest]} points), held: {largest in held}")
    if (len(orders) < BOX_STRATA or len(sizes) < BOX_STRATA
            or largest not in held):
        raise AssertionError("offline: the boxes held against the CPU are "
                             "not spread over the proposals")
    sub = corners[:, held]
    t = time.perf_counter()
    sub_masks = fronts[str(device)](xyz, feats, sub, OFFLINE_RES, theta, phi)
    torch.cuda.synchronize()
    sub_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    cpu_masks = fronts["cpu"](xyz, feats, sub, OFFLINE_RES, theta, phi)
    box_cpu_ms = (time.perf_counter() - t) * 1e3
    inputs = {k: render_inputs(*f.instances(xyz, feats, sub, theta,
                                            phi)[0], BOX_VIEWS)
              for k, f in fronts.items()}
    res = (OFFLINE_RES, OFFLINE_RES)
    replay, cpu_raw, flipped = check_neighbours(
        "offline Box2Mask", inputs[str(device)], inputs["cpu"], res,
        BOX_RADIUS, BOX_NSAMPLE, device)
    keep = torch.from_numpy(
        ~flipped.reshape(flipped.shape[0], *res))[:, None]
    box_err = _rel_err(sub_masks.cpu() * keep, cpu_masks * keep)
    replay_err = _rel_err(replay, cpu_raw)
    log(f"offline: Box2Mask ({xyz.shape[1]} points, {corners.shape[1]} "
        f"boxes holding {sorted(inside)} points, {masks.shape[0]} masks of "
        f"{OFFLINE_RES}x{OFFLINE_RES}, radius {BOX_RADIUS}, nsample "
        f"{BOX_NSAMPLE}) on the card {box_ms:.1f} ms (host crops "
        f"included), peak device memory {box_peak:.3f} GiB; boxes {held} "
        f"({total} points) on the card {sub_ms:.1f} ms, on the CPU "
        f"{box_cpu_ms:.1f} ms; their masks card vs CPU outside the flipped "
        f"rows {box_err:.3g}, with the CPU's indices {replay_err:.3g} "
        f"(limit {MASK_TOL})")
    if (sub_masks.shape != cpu_masks.shape
            or box_err > MASK_TOL or replay_err > MASK_TOL):
        raise AssertionError("offline: Box2Mask on the card disagrees with "
                             "the CPU")

    # 5. the pseudo-image mask pipeline
    pcfg = PseudoImageConfig()
    images = synthetic_images(MASK_IMAGES, pcfg.resolution, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    kept, blurred = run_mask_pipeline(images, pcfg, device=device)
    torch.cuda.synchronize()
    pipe_ms = (time.perf_counter() - t) * 1e3
    pipe_peak = torch.cuda.max_memory_allocated() / 2**30
    t = time.perf_counter()
    cpu_kept, cpu_blurred = run_mask_pipeline(images, pcfg, device="cpu")
    pipe_cpu_ms = (time.perf_counter() - t) * 1e3
    passed = filter_images(images, pcfg)
    raw = np.stack([extract_mask(images[i], pcfg.white_threshold)
                    for i in passed])
    raw[raw < 127] = 0
    raw[raw >= 128] = 255
    pix = Pixel2Mask(radius=pcfg.blur_radius, nsample=pcfg.blur_samples,
                     device="cpu").inputs(raw)
    replay, cpu_raw, flipped = check_neighbours(
        "offline mask pipeline", pix, pix, (pcfg.resolution,) * 2,
        pcfg.blur_radius, pcfg.blur_samples, device)
    same_kept = np.array_equal(kept, cpu_kept)
    pipe_err = math.inf
    if same_kept and len(kept):
        keep = torch.from_numpy(~flipped[np.isin(passed, kept)].reshape(
            len(kept), pcfg.resolution, pcfg.resolution))[..., None]
        pipe_err = _rel_err(torch.from_numpy(blurred) * keep,
                            torch.from_numpy(cpu_blurred) * keep)
    replay_err = _rel_err(replay, cpu_raw)
    log(f"offline: run_mask_pipeline ({MASK_IMAGES} images of "
        f"{pcfg.resolution}x{pcfg.resolution}, blur radius "
        f"{pcfg.blur_radius}, {pcfg.blur_samples} samples) on the card "
        f"{pipe_ms:.1f} ms, peak device memory {pipe_peak:.3f} GiB; on the "
        f"CPU {pipe_cpu_ms:.1f} ms; kept {len(kept)} images, the same as "
        f"the CPU: {same_kept}; masks card vs CPU outside the flipped rows "
        f"{pipe_err:.3g}, with the CPU's indices {replay_err:.3g} (limit "
        f"{MASK_TOL})")
    if (not same_kept or len(kept) == 0 or pipe_err > MASK_TOL
            or replay_err > MASK_TOL):
        raise AssertionError("offline: the mask pipeline on the card "
                             "disagrees with the CPU")

    # 6. each tool's host part (host clock) and device part (CUDA events,
    # on inputs already on the card) apart
    def device_ms(fn):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1])

    def on_card(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    rows_valid = np.nonzero(host.valid)[0]
    t = time.perf_counter()
    crop, rows = crop_rows(host.coords[rows_valid], host.box.concat_boxes(),
                           host.box.transform_tuple())
    crop_s = time.perf_counter() - t
    proj = projector(device)
    crop_t, idx_t = on_card(crop), on_card(rows_valid[rows])
    ones = torch.ones(crop.shape[0], dtype=torch.bool, device=device)
    proj_dev = [device_ms(lambda: proj(
        crop_t, logits.detach().requires_grad_(True)[idx_t], ones,
        n_boxes).sum().backward()) for _ in range(2)]
    t = time.perf_counter()
    box_in = render_inputs(*fronts[str(device)].instances(
        xyz, feats, corners, theta, phi)[0], BOX_VIEWS)
    box_host_s = time.perf_counter() - t
    box_t = (on_card(box_in[0], torch.float32),
             on_card(box_in[1], torch.float32), on_card(box_in[2]))
    box_dev = [device_ms(lambda: point2mask_module(
        *box_t[:2], res, box_t[2], radius=BOX_RADIUS, nsample=BOX_NSAMPLE))
        for _ in range(2)]
    t = time.perf_counter()
    passed = filter_images(images, pcfg)
    raw = np.stack([extract_mask(images[i], pcfg.white_threshold)
                    for i in passed])
    raw[raw < 127] = 0
    raw[raw >= 128] = 255
    pix = Pixel2Mask(radius=pcfg.blur_radius, nsample=pcfg.blur_samples,
                     device=device).inputs(raw)
    pix_host_s = time.perf_counter() - t
    pix_t = [on_card(a) for a in pix]
    pix_dev = [device_ms(lambda: point2mask_module(
        pix_t[0], pix_t[1], (pcfg.resolution,) * 2, pix_t[2],
        radius=pcfg.blur_radius, nsample=pcfg.blur_samples))
        for _ in range(2)]
    log(f"offline: host s / device ms (CUDA events, first and second "
        f"run): projector crop {crop_s:.3f} s ({crop.shape[0]} cropped "
        f"points) / forward + backward "
        f"{', '.join(f'{x:.1f}' for x in proj_dev)} ms; Box2Mask crops "
        f"{box_host_s:.3f} s ({box_in[0].shape[0]} instance views of "
        f"{box_in[0].shape[1]} points) / render "
        f"{', '.join(f'{x:.1f}' for x in box_dev)} ms; mask pipeline "
        f"filter + masks {pix_host_s:.3f} s / blur "
        f"{', '.join(f'{x:.1f}' for x in pix_dev)} ms")
    return launches


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
    rows += phase_spill(batch.plans, deep, m, device, gen)
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
        paths = {"validate": val_launches}
        paths["UNet"], _ = phase_train("UNet", cfg, *unet_batch, device,
                                       TRAIN_STEPS, full_checks=True)
        paths["Narrow"], _ = phase_train("Narrow", narrow_cfg, *narrow_batch,
                                         device, TRAIN_STEPS,
                                         full_checks=False)
        phase_unpool_times(narrow_batch[1].plans, n_planes, device, gen)
        del narrow_batch
        fcnet_batch = plan_train_batch(fcnet_cfg, scenes, "FCNet")
        paths["FCNet"], fcnet_cut = phase_train("FCNet", fcnet_cfg,
                                                *fcnet_batch, device, 1,
                                                full_checks=False)
        del fcnet_batch
        paths["Text"] = phase_text(scenes, device)
    paths["FCNet at its own size"] = phase_own_size(fcnet_cut)
    phase_profile(cfg, unet_batch[1], device, args.trace_dir)
    del unet_batch
    phase_pools(scenes, device, gen)
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
    paths["DP"] = phase_dp(device)
    paths["plans-free"] = phase_plans_free(scenes, device)
    paths["remat"] = phase_remat(scenes, device)
    phase_kpconv(scenes, device)
    paths["offline"] = phase_offline(scenes, device)
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
