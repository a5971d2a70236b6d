"""Multi-view voting validation (twin of ``tdwss.engine.evaluate``).

For each of ``reps`` repetitions the val loader draws one random view per
scene; per-point logits are added into a global vote store on the device;
argmax over the votes gives the mIoU after each repetition.
"""

from __future__ import annotations

import time
from typing import List, Optional

import torch

from tdwss_torch.config import Config
from tdwss_torch.data.dataset import val_offsets
from tdwss_torch.data.loader import val_batches
from tdwss_torch.device import check_model_device, resolve_device
from tdwss_torch.engine.steps import accumulate_votes, eval_step
from tdwss_torch.utils import iou


def validate(cfg: Config, model, val_scenes, reps: Optional[int] = None,
             verbose: bool = True, device=None,
             timings: Optional[list] = None) -> List[float]:
    """Returns the mIoU after each voting repetition.

    Runs on ``cuda`` unless ``device`` says otherwise; ``model`` must
    already live there.  ``timings``, when given, receives one dict per
    repetition: host planning seconds (``plan_s``: collate + plans) and
    device seconds (``device_s``: transfer, forward and votes, ended by a
    synchronise).
    """
    dev = resolve_device(device)
    check_model_device(model, dev)
    reps = reps or cfg.pointcloud_data.val_reps
    offsets, labels = val_offsets(val_scenes)
    store = torch.zeros((int(offsets[-1]), 20), dtype=torch.float32,
                        device=dev)
    model.eval()
    ious = []
    for rep in range(1, reps + 1):
        plan_s = device_s = 0.0
        batches = val_batches(val_scenes, cfg, offsets, rep)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            plan_s += time.perf_counter() - t0
            if batch is None:
                break
            t0 = time.perf_counter()
            batch = batch.to(dev)
            logits = eval_step(model, batch)
            accumulate_votes(store, logits, batch.point_ids, batch.valid)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            device_s += time.perf_counter() - t0
        preds = store.argmax(dim=1).cpu().numpy()
        ious.append(iou.evaluate(preds, labels, verbose=verbose))
        if timings is not None:
            timings.append({"rep": rep, "plan_s": plan_s,
                            "device_s": device_s})
    return ious
