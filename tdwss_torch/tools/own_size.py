"""Training steps of one config at its own batch: its ``batch_size``
scenes in its ``max_points``, on one card.

    python3 -m tdwss_torch.tools.own_size --config configs/<name>.yaml
        [--max-points M [M ...]]

Makes ``batch_size`` synthetic scenes (``make_dataset``, seed 7) of the
most points the cap admits (``max_points // batch_size``), plans one
training batch on the host (collate + plans + slim, timed), and runs
STEPS ``train_step``s of the config's model (seed 0, random weights) on
the card: per step the loss and the device seconds (ended by a
synchronise), the peak device memory, and the kernel launches counted
over the steps.  With several ``--max-points`` it runs the config at each
cap in turn (the scenes made anew for each) and reports a cap whose step
runs out of device memory as not fitting, with the peak reached.
``chip_smoke.py`` drives the same steps through :func:`run_steps` for the
config it holds at its own size.
"""

from __future__ import annotations

import argparse
import copy
import math
import time

import numpy as np
import torch

STEPS = 2


def plan_batch(cfg, scenes):
    """One training batch of ``cfg`` planned on the host: (planned,
    slimmed, seconds)."""
    from tdwss_torch.data.collate import train_collate
    from tdwss_torch.data.plans import attach_host_plans, slim_batch_for_train
    from tdwss_torch.ops.host_plan import reset_sticky_plans

    reset_sticky_plans()
    t = time.perf_counter()
    planned = attach_host_plans(
        train_collate(scenes, cfg, np.random.default_rng(0)), cfg)
    host = slim_batch_for_train(planned, cfg)
    return planned, host, time.perf_counter() - t


def run_steps(cfg, host):
    """STEPS training steps of ``cfg``'s model (seed 0) on the planned
    batch ``host``, on the card: the launch counts are set to 0 just
    before the first step and read just after the last.  Returns a dict:
    ``losses``,
    ``step_s`` (device seconds per step, each ended by a synchronise),
    ``peak_gib``, ``launches``, ``body_launches``, ``model``, ``batch``
    (on the card)."""
    from tdwss_torch.engine.steps import make_optimizer, train_step
    from tdwss_torch.models.meta_arch import build_model
    from tdwss_torch.ops import windowed as W

    batch = host.to("cuda")
    model = build_model(cfg, seed=0, device="cuda")
    opt, sched = make_optimizer(cfg, model, 100)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    W.reset_launches()
    losses, step_s = [], []
    for _ in range(STEPS):
        t = time.perf_counter()
        loss, _ = train_step(cfg, model, opt, sched, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(float(loss))
    return {"losses": losses, "step_s": step_s,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": dict(W.launches),
            "body_launches": dict(W.body_launches),
            "model": model, "batch": batch}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--max-points", type=int, nargs="+")
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tdwss_torch.config import load_config
    from tdwss_torch.data.synthetic import make_dataset

    base = load_config(args.config)
    n = base.pointcloud_data.batch_size
    for cap in args.max_points or [base.engine.max_points]:
        cfg = copy.deepcopy(base)
        cfg.engine.max_points = cap
        pps = cap // n
        t = time.perf_counter()
        scenes = make_dataset(n, num_points=pps, seed=7,
                              with_text=base.has_text)
        print(f"{args.config}, max_points {cap}: {n} scenes x {pps} points "
              f"({sum(s.points.shape[0] for s in scenes)} in all) in "
              f"{time.perf_counter() - t:.2f} s", flush=True)
        planned, host, host_s = plan_batch(cfg, scenes)
        rows = [f"{int(lvl.grid.valid.sum())}/{lvl.grid.valid.shape[0]}"
                for lvl in host.plans.levels]
        print(f"max_points {cap}: host plan (collate + plans + slim) "
              f"{host_s:.3f} s; level rows valid/capacity {rows}",
              flush=True)
        del planned, scenes
        out = None
        try:
            out = run_steps(cfg, host)
        except torch.cuda.OutOfMemoryError as e:
            print(f"max_points {cap}: does not fit (peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                  f"when it ran out): {str(e)[:300]}", flush=True)
        if out is None:
            del host
            torch.cuda.empty_cache()
            continue
        ok = all(math.isfinite(x) for x in out["losses"])
        print(f"max_points {cap}: {STEPS} steps, losses "
              f"{out['losses']} (finite: {ok}); device s per step "
              f"{', '.join(f'{s:.3f}' for s in out['step_s'])}; peak "
              f"device memory {out['peak_gib']:.2f} GiB; launches "
              f"{out['launches']}", flush=True)
        del out, host
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
