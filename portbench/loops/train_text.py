"""The training loop of a text cell: ``tdwss_torch.engine.train.Trainer``
epochs of ``MultiLabelContrastive``.

As :mod:`loops/train.py <portbench.loops.train>`: set-up builds one
``Trainer`` on the cell's rooms and their descriptions, draws every
leaf's weights from the seed on the card (the text tower's included) and
puts them into ``trainer.model``, runs epoch 1 (its first steps read by
:class:`portbench.reference.text_check.TextCapture`) and epoch 2; the
window runs epochs 3, 4, ... up to the first epoch end after
``seconds``; a traced run measures one untraced epoch and traces the
next, with the text tower's backward marked
(:mod:`portbench.trace_text`).  The ``ctx`` fields the shared readers
read (``train_points_per_s``, ``peak_gib``, ``setup_s``) mean what they
mean there.  After the window the program is freed and the text
reference runs the first steps again.
"""

from __future__ import annotations

import gc
import math
import time
from types import SimpleNamespace

import torch

from portbench import harness, trace, trace_text
from portbench.loops.train import _log, _power_limit, _sync
from portbench.reference import check, collate, text_check
from portbench.reference.model import draw_weights
from portbench.reference.text_model import fcn_planes, param_spec
from portbench.traffic.generate_text import generate_text
from portbench.work import count
from portbench.work.text import fcn_work, tower_work


def build_trainer(cell, seed: int, scenes, device):
    """The program's ``Trainer`` for ``cell`` with every leaf's weights
    drawn from ``seed``; (trainer, config dict, weights)."""
    from tdwss_torch.config import config_from_dict
    from tdwss_torch.data.synthetic import Scene
    from tdwss_torch.engine.train import Trainer

    cfgd = dict(cell.config["config"], seed=int(seed),
                training_name="portbench-" + cell.name)
    cfg = config_from_dict(cfgd)
    port_scenes = [Scene(points=s.points, colors=s.colors, labels=s.labels,
                         name=s.name, texts=list(s.texts)) for s in scenes]
    trainer = Trainer(cfg, train_scenes=port_scenes, val_scenes=[],
                      use_checkpoints=False, verbose=False, device=device)
    spec = param_spec(cfgd)
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


def program_losses():
    """The program's total loss of a training output, as its
    ``compute_loss`` adds it, and its mask of the slots that count."""
    from tdwss_torch.engine.steps import text_mask
    from tdwss_torch.utils.losses import Classification, TextContrastive

    def loss(output, batch):
        logits, (gfeats, tfeats, owners) = output
        return Classification(logits, batch.scene_label, batch.scene_mask) \
            + TextContrastive(gfeats, tfeats, owners,
                              text_mask=text_mask(batch.text),
                              scene_mask=batch.scene_mask)

    return loss, lambda batch: text_mask(batch.text)


def epoch_work(scenes, cfgd: dict, seed: int, epoch: int, device):
    """The frozen count's work of every step of ``epoch``: the FCN's
    convolutions, its unpools and joins, and the text tower."""
    caps = text_check.plan_capacities(cfgd)
    cp = check.collate_params(cfgd)
    dtype = cfgd["engine"].get("compute_dtype", "float32")
    rows = cp["batch_size"] * cfgd["text_data"]["cropped_texts"]
    tower = tower_work(cfgd["text_model"], rows,
                       sum(fcn_planes(cfgd["pointcloud_model"])))
    total = {"conv": count.Work(), "unpool": count.Work(),
             "tower": count.Work()}
    for start in collate.epoch_starts(len(scenes), cp["batch_size"]):
        b = collate.train_batch(scenes, cp, seed, epoch, start)
        c = count.live_counts(torch.from_numpy(b.coords).to(device), caps)
        for k, w in fcn_work(cfgd, c, dtype).items():
            total[k].add(w)
        total["tower"].add(tower)
    return total


def first_steps(cell, seed: int, device):
    """Set-up up to the checked steps, as a run takes them; (scenes,
    trainer, config dict, weights, the program's
    :class:`~portbench.reference.text_check.TextTrajectory`)."""
    t = time.time()
    scenes = generate_text(cell.mix, seed)
    _log(f"set-up: traffic {time.time() - t:.3f} s")
    t = time.time()
    trainer, cfgd, weights = build_trainer(cell, seed, scenes, device)
    _log(f"set-up: Trainer (prewarm epochs {trainer.warmed_epochs}) and "
         f"weights {time.time() - t:.3f} s")
    bs = cfgd["pointcloud_data"]["batch_size"]
    if len(scenes) % bs:
        raise ValueError(f"{len(scenes)} scenes do not fill batches of {bs}")
    capture = text_check.TextCapture(trainer.model, trainer.optimizer,
                                     weights, int(cell.spec["check_steps"]),
                                     *program_losses())
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
    points_per_epoch = sum(s.points.shape[0] for s in scenes)
    ctx = SimpleNamespace(cfg=trainer.cfg, scenes=trainer.train_scenes,
                          compute_dtype=cfgd["engine"].get("compute_dtype",
                                                           "float32"),
                          steps=0, trace=trace.Reduced(), work=None,
                          window_work=None, traced_steps=0, loader_epoch=1,
                          on_card=cuda, tower_device_s=0.0)
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
        with trace_text.tower_ranges(trainer.model), \
                profile(activities=acts) as prof:
            loss = trainer.run_epoch(epoch)
        ctx.traced_steps = trainer.spe
        ctx.steps += trainer.spe
        failed += 0 if math.isfinite(loss) else trainer.spe
        ctx.trace = trace.reduce_events(prof)
        ctx.tower_device_s = trace_text.tower_device_s(prof)
        del prof
    ctx.peak_bytes = (torch.cuda.max_memory_allocated(device) if cuda else 0)
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"

    if traced:
        t = time.time()
        ctx.work = epoch_work(scenes, cfgd, seed, epoch, device)
        ctx.window_work = count.Work()
        for e in range(3, epoch):
            w = epoch_work(scenes, cfgd, seed, e, device)
            ctx.window_work.add(w["conv"])
            ctx.window_work.add(w["tower"])
        _log(f"work of epochs 3-{epoch}: {time.time() - t:.3f} s; tower "
             f"device {ctx.tower_device_s:.4f} s of {ctx.trace.busy_s:.4f} "
             f"s busy")
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
    reference = text_check.reference_steps(
        scenes, cfgd, seed, weights, int(cell.spec["check_steps"]), device)
    _log(f"reference: {time.time() - t:.3f} s")
    values = text_check.readings(program, reference)
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
