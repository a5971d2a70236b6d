"""The training loop: ``tdwss_torch.engine.train.Trainer`` epochs.

Set-up (:func:`first_steps`) builds one ``Trainer`` on the cell's scenes
(no validation, no checkpoints, the configuration's ``seed`` the run's),
draws the model's weights from the seed on the card and puts them into
``trainer.model``, and runs epoch 1 through ``Trainer.run_epoch``: its
first steps are the ones the check reads
(:class:`portbench.reference.check.ProgramCapture`).  Epoch 2 follows in
set-up: it builds what epoch 1 did not (kernels, plan shapes, the
allocator's blocks for the batches that follow).  The window then calls
``run_epoch`` for epoch 3, 4, ... as ``Trainer.fit`` does, and ends at
the first epoch end after ``seconds``; each epoch ends with its mean
loss on the host, so the card is done.  A traced run measures one
untraced epoch (epoch 3) and traces the next.

Once the window has closed and the peak memory is read, the program is
freed and the reference runs the first steps again on the same scenes
and weights.
"""

from __future__ import annotations

import gc
import math
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from portbench import harness, trace
from portbench.reference import check, collate
from portbench.reference.model import draw_weights, param_spec, plan_capacities
from portbench.traffic.generate import generate
from portbench.work import count


def _log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def build_trainer(cell, seed: int, scenes, device):
    """The program's ``Trainer`` for ``cell`` with the weights drawn from
    ``seed``; (trainer, config dict, weights)."""
    from tdwss_torch.config import config_from_dict
    from tdwss_torch.data.synthetic import Scene
    from tdwss_torch.engine.train import Trainer

    cfgd = dict(cell.config["config"], seed=int(seed),
                training_name="portbench-" + cell.name)
    cfg = config_from_dict(cfgd)
    port_scenes = [Scene(points=s.points, colors=s.colors, labels=s.labels,
                         name=s.name) for s in scenes]
    trainer = Trainer(cfg, train_scenes=port_scenes, val_scenes=[],
                      use_checkpoints=False, verbose=False, device=device)
    spec = param_spec(cfgd["pointcloud_model"])
    weights = draw_weights(spec, seed, device)
    params = dict(trainer.model.named_parameters())
    theirs = {n: tuple(p.shape) for n, p in params.items()}
    ours = {n: tuple(leaf.shape) for n, leaf in spec.items()}
    if theirs != ours:
        raise ValueError(f"the model's parameters differ from the "
                         f"reference's: {sorted(set(theirs) ^ set(ours))} "
                         f"{[n for n in ours if theirs.get(n) != ours[n]]}")
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(weights[n])
    return trainer, cfgd, weights


def epoch_work(scenes, cfgd: dict, seed: int, epoch: int, device):
    """The frozen count's work of every step of ``epoch``."""
    ops = count.step_ops(cfgd["pointcloud_model"])
    caps = plan_capacities(cfgd)
    cp = check.collate_params(cfgd)
    dtype = cfgd["engine"].get("compute_dtype", "float32")
    total = {"conv": count.Work(), "unpool": count.Work()}
    for start in collate.epoch_starts(len(scenes), cp["batch_size"]):
        b = collate.train_batch(scenes, cp, seed, epoch, start)
        c = count.live_counts(torch.from_numpy(b.coords).to(device), caps)
        for k, w in count.step_work(ops, c, dtype).items():
            total[k].add(w)
    return total


def first_steps(cell, seed: int, device):
    """Set-up up to the checked steps, as a run takes them: the cell's
    scenes, its ``Trainer`` with the seed's weights, and epoch 1 with its
    first steps read; (scenes, trainer, config dict, weights, the
    program's :class:`~portbench.reference.check.Trajectory`)."""
    from tdwss_torch.utils.losses import Classification

    t = time.time()
    scenes = generate(cell.mix, seed)
    _log(f"set-up: traffic {time.time() - t:.3f} s")
    t = time.time()
    trainer, cfgd, weights = build_trainer(cell, seed, scenes, device)
    _log(f"set-up: Trainer (prewarm epochs {trainer.warmed_epochs}) and "
         f"weights {time.time() - t:.3f} s")
    bs = cfgd["pointcloud_data"]["batch_size"]
    if len(scenes) % bs:
        raise ValueError(f"{len(scenes)} scenes do not fill batches of {bs}")
    capture = check.ProgramCapture(trainer.model, trainer.optimizer, weights,
                                   int(cell.spec["check_steps"]),
                                   Classification)
    t = time.time()
    trainer.run_epoch(1)
    capture.close()
    _sync(device)
    _log(f"set-up: epoch 1 (the checked steps) {time.time() - t:.3f} s")
    return scenes, trainer, cfgd, weights, capture.result()


def run(cell, seed: int, seconds: float, traced: bool, device,
        started: float) -> dict:
    cuda = device.type == "cuda"
    scenes, trainer, cfgd, weights, program = first_steps(cell, seed, device)
    t = time.time()
    trainer.run_epoch(2)
    _sync(device)
    _log(f"set-up: epoch 2 (warm-up) {time.time() - t:.3f} s")
    # every epoch trains on every scene once
    points_per_epoch = sum(s.points.shape[0] for s in scenes)
    ctx = SimpleNamespace(cfg=trainer.cfg, scenes=trainer.train_scenes,
                          compute_dtype=cfgd["engine"].get("compute_dtype",
                                                           "float32"),
                          steps=0, trace=trace.Reduced(), work=None,
                          window_work=None, traced_steps=0, loader_epoch=1,
                          on_card=cuda)
    window_start = time.time()
    ctx.setup_s = window_start - started
    failed, epoch, epoch_s = 0, 3, []
    t0 = time.perf_counter()
    while True:
        loss = trainer.run_epoch(epoch)
        epoch_s.append(time.perf_counter() - t0 - sum(epoch_s))
        ctx.steps += trainer.spe
        failed += 0 if math.isfinite(loss) else trainer.spe
        epoch += 1
        if traced or time.perf_counter() - t0 >= seconds:
            break
    ctx.window_s = time.perf_counter() - t0
    ctx.points = points_per_epoch * len(epoch_s)
    ctx.epoch_s = epoch_s
    _log(f"window: epochs 3-{epoch - 1}, seconds each "
         f"{[round(x, 3) for x in epoch_s]}")
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        with trace.conv_ranges(trainer.model), \
                profile(activities=acts) as prof:
            loss = trainer.run_epoch(epoch)
        ctx.traced_steps = trainer.spe
        ctx.steps += trainer.spe
        failed += 0 if math.isfinite(loss) else trainer.spe
        ctx.trace = trace.reduce_events(prof)
        del prof
    ctx.peak_bytes = (torch.cuda.max_memory_allocated(device) if cuda else 0)
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"

    if traced:
        t = time.time()
        ctx.work = epoch_work(scenes, cfgd, seed, epoch, device)
        ctx.window_work = count.Work()
        for e in range(3, epoch):
            ctx.window_work.add(
                epoch_work(scenes, cfgd, seed, e, device)["conv"])
        _log(f"work of epochs 3-{epoch}: {time.time() - t:.3f} s")
        metrics = harness.read_metrics(cell.per_layer, ctx)
        _log(f"card: {_power_limit() if cuda else 'none'}")
    else:
        metrics = harness.read_metrics(cell.end_to_end, ctx)

    del trainer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = cell.spec["limits"]
    t = time.time()
    reference = check.reference_steps(scenes, cfgd, seed, weights,
                                      int(cell.spec["check_steps"]), device)
    _log(f"reference: {time.time() - t:.3f} s")
    values = check.readings(program, reference)
    _log(f"losses: program {program.losses} reference {reference.losses}")
    _log(f"readings: {values}")
    result = {
        "correct": check.judge(values, limits),
        "attempted": ctx.steps,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": int(ctx.peak_bytes)},
    }
    if traced:
        t = ctx.trace
        result["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = {"device_ops": [list(x) for x in t.top_ops],
                               "idle_gaps": [list(x) for x in t.idle_by_host]}
    result["checks"] = {k: {"value": values[k], "limit": limits[k]}
                        for k in limits}
    return result
