"""Each cell end to end at a tiny size on the CPU with the reference
beside it (the look for a card skipped), the planted faults and the
control coming out as not correct under the cell's limits, and no JAX
and no JAX package loaded by a run."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.reference import check
from portbench.traffic.generate import generate
from _tiny import cells, tiny_cell, tiny_cells

SEED = 2**31 + 77


def _run(name, trace=False):
    torch.set_num_threads(2)
    harness.isolate_caches()
    return harness.run(tiny_cell(name), SEED, 0.5, trace,
                       torch.device("cpu"), time.time())


@pytest.mark.parametrize("name", tiny_cells())
def test_cell_runs_and_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) >= {"train_points_per_s", "setup_s"}
    for c in res["checks"].values():
        assert c["value"] < c["limit"] / 10


@pytest.mark.parametrize("name", tiny_cells())
def test_traced_run_reads_per_layer_metrics(name):
    res = _run(name, trace=True)
    assert res["correct"]
    # on the CPU the profiler sees no device: only the host-clock reader
    assert set(res["metrics"]) == {"loader_s_per_batch"}
    assert {"busy_s", "window_s"} <= set(res["device"])


def _wrap_train_step(monkeypatch, fault):
    import tdwss_torch.engine.train as train_mod

    real = train_mod.train_step

    def broken(cfg, model, optimizer, scheduler, batch, group=None):
        if fault == "state_unchanged":
            for g in optimizer.param_groups:
                g["lr"] = 0.0
        elif fault == "half_batch":
            mask = batch.scene_mask.clone()
            mask[mask.shape[0] // 2:] = False
            batch = batch.replace(scene_mask=mask)
        return real(cfg, model, optimizer, scheduler, batch, group=group)

    monkeypatch.setattr(train_mod, "train_step", broken)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
@pytest.mark.parametrize("name", tiny_cells())
def test_planted_fault_is_not_correct(monkeypatch, name, fault):
    _wrap_train_step(monkeypatch, fault)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", tiny_cells())
def test_control_is_not_correct(name):
    """The reference in fp8 put in the program's place."""
    cell = tiny_cell(name)
    cfgd = dict(cell.config["config"], seed=SEED)
    from portbench.reference.model import draw_weights, param_spec

    scenes = generate(cell.mix, SEED)
    w = draw_weights(param_spec(cfgd["pointcloud_model"]), SEED, "cpu")
    steps = cell.spec["check_steps"]
    ref = check.reference_steps(scenes, cfgd, SEED, w, steps, "cpu")
    fp8 = check.reference_steps(scenes, cfgd, SEED, w, steps, "cpu",
                                precision="fp8")
    again = check.reference_steps(scenes, cfgd, SEED, w, steps, "cpu")
    limits = cell.spec["limits"]
    assert check.judge(check.readings(again, ref), limits)
    assert not check.judge(check.readings(fp8, ref), limits)


def test_run_loads_no_jax():
    code = ("import sys, time, torch; sys.path.insert(0, 'portbench/tests');"
            "from _tiny import tiny_cell, cells;"
            "from portbench import harness;"
            "harness.isolate_caches(); torch.set_num_threads(2);"
            "r = harness.run(tiny_cell(cells()[0]), 3, 0.2, False,"
            " torch.device('cpu'), time.time());"
            "print(harness.forbidden_modules(), r['correct'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=harness.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


@pytest.mark.card
def test_cell_on_card():
    """A short run of every cell through ``run.py`` on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in cells():
        r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                            name, "--seed", str(SEED), "--seconds", "5",
                            "--trace", "0"], cwd=harness.ROOT,
                           capture_output=True, text=True, timeout=1200)
        assert r.returncode == 0, r.stderr[-3000:]
        assert json.loads(r.stdout.strip().splitlines()[-1])["correct"]
