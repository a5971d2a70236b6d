"""Rank bodies of the data-parallel tests (``test_torch_port_dp*.py``)
and the runner that starts them.

:func:`run_ranks` starts ``world`` processes with the ``spawn`` start
method.  Each sets one intra-op thread, joins a gloo group whose
rendezvous is a ``FileStore`` in the test's directory (no TCP port for
the test workers to fight over), and runs one of the bodies below, which
read their inputs from and write their results to that directory with
``torch.save``.  The group has a timeout, and the runner kills every
rank still alive at its own deadline, so a hung collective fails its
test.  The ranks import the port only.
"""

import datetime
import os
import sys
import time
import traceback
import uuid

GROUP_TIMEOUT_S = 120


def _rank_main(body, rank, world, workdir, store, args):
    os.environ["OMP_NUM_THREADS"] = "1"
    # TensorBoard's import pulls in TensorFlow here (seconds per rank)
    sys.modules["torch.utils.tensorboard"] = None
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            globals()[body](rank, world, workdir, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"error_{body}_{rank}.txt"),
                  "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(body, world, workdir, *args, timeout=300):
    """Run ``body(rank, world, workdir, *args)`` on ``world`` gloo ranks;
    raises with the ranks' tracebacks if one fails or the deadline
    passes."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(str(workdir), f"store_{uuid.uuid4().hex}")
    procs = [ctx.Process(target=_rank_main,
                         args=(body, r, world, str(workdir), store, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [i for i, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    errors = []
    for r in range(world):
        path = os.path.join(str(workdir), f"error_{body}_{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    codes = [p.exitcode for p in procs]
    if hung or any(codes):
        raise AssertionError(f"{body}: ranks {hung} hung past {timeout} s, "
                             f"exit codes {codes}\n" + "\n".join(errors))


def _load(path):
    import torch

    return torch.load(path, map_location="cpu", weights_only=False)


def dp_steps(rank, world, workdir, steps, single):
    """``steps`` data-parallel steps from ``init.pt`` (config, state
    dict, steps per epoch) on ``batch<rank>.pt``; with ``single``, rank 0
    first runs the same steps on its batch in one process, from the same
    state.  Writes ``out<rank>.pt``."""
    import copy

    import torch
    import torch.distributed as dist

    from tdwss_torch.engine.steps import make_optimizer, train_step
    from tdwss_torch.models.meta_arch import build_model
    from tdwss_torch.parallel import dp

    init = _load(os.path.join(workdir, "init.pt"))
    batch = _load(os.path.join(workdir, f"batch{rank}.pt"))
    cfg = init["cfg"]
    model = build_model(cfg, device="cpu")
    model.load_state_dict(init["state"])
    out = {}
    if single and rank == 0:
        m1 = copy.deepcopy(model)
        opt, sched = make_optimizer(cfg, m1, init["spe"])
        out["single_losses"] = [
            float(train_step(cfg, m1, opt, sched, batch)[0])
            for _ in range(steps)]
        out["single_state"] = m1.state_dict()
    opt, sched = make_optimizer(cfg, model, init["spe"])
    dp.broadcast_state(model)
    out["losses"] = []
    for _ in range(steps):
        loss, _ = train_step(cfg, model, opt, sched, batch,
                             group=dist.group.WORLD)
        out["losses"].append(float(dp.average_scalars({"loss": loss})["loss"]))
    out["state"] = model.state_dict()
    torch.save(out, os.path.join(workdir, f"out{rank}.pt"))


def trainer_fit(rank, world, workdir, cfg, epochs, tag):
    """A ``Trainer`` of ``cfg`` on the synthetic train and val scenes of
    ``scenes.pt``, fitted to ``epochs`` in ``workdir`` with checkpoints;
    writes ``<tag><rank>.pt`` (history, start epoch, state dict)."""
    import torch

    from tdwss_torch.engine.train import Trainer

    scenes = _load(os.path.join(workdir, "scenes.pt"))
    os.chdir(workdir)
    t = Trainer(cfg, scenes["train"], scenes["val"], use_checkpoints=True,
                verbose=False, device="cpu")
    start = t.start_epoch
    history = t.fit(epochs)
    torch.save({"history": history, "start_epoch": start,
                "state": t.state_dict(), "device": str(t.device)},
               os.path.join(workdir, f"{tag}{rank}.pt"))
