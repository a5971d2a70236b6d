"""The port's ``Trainer`` data-parallel on gloo ranks on the CPU.

``configs/3DUNetWithText_scannet_subcloud_uppool_4chip.yaml`` (``mesh:
{data: 4}``, global batch 32) shrunk as the reference's
``tests/test_parallel.py::test_dp_trainer_end_to_end`` shrinks it
(SparseConvFCNetDirectUpPool at m=4, full_scale 64, VGG blocks, global
batch 8 = 2 per rank, 32 synthetic scenes of 600 points, scene-level
labels), on 4 ranks:

- two epochs: the mean loss finite and falling, every rank's parameters,
  buffers, optimiser state and step equal bit for bit, and rank 0's
  checkpoints on disk; a second ``Trainer`` on 4 ranks resumes at epoch
  3 with that state bit for bit, and a one-process ``Trainer``
  (``mesh.data: 1``) loads the same checkpoint.

``test_torch_port_dp_ref.py`` holds the first epoch against the
reference's DP ``Trainer``, and ``test_torch_port_dp_cli.py`` trains
through ``torchrun``.
"""

import dataclasses
import os

import numpy as np
import torch

from tests._torch_port_dp_workers import run_ranks
from tdwss_torch.config import load_config
from tdwss_torch.data.synthetic import make_dataset
from tdwss_torch.engine.train import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs",
                      "3DUNetWithText_scannet_subcloud_uppool_4chip.yaml")
WORLD = 4


def _overrides(name, **data):
    return dict(
        training_name=name, label="scene_level", epochs=2,
        pointcloud_data=dict(dict(scale=10, val_reps=1, batch_size=8),
                             **data),
        pointcloud_model={"name": "SparseConvFCNetDirectUpPool", "m": 4,
                          "full_scale": 64, "block_reps": 1,
                          "residual_blocks": False},
        engine={"max_points": 4096, "min_level_capacity": 256})


def _save_scenes(path, val=True):
    torch.save({"train": make_dataset(32, num_points=600, seed=21,
                                      with_text=False),
                "val": make_dataset(2, num_points=600, seed=121,
                                    with_text=False) if val else []},
               path / "scenes.pt")


def _results(path, tag):
    return [torch.load(path / f"{tag}{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _assert_equal(a, b, where=""):
    """Nested state dicts (tensors, numbers, lists) equal bit for bit."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_dp_trainer_two_epochs_resume_and_one_process_load(tmp_path,
                                                           monkeypatch):
    cfg = load_config(CONFIG, **_overrides("dp_port"))
    assert cfg.mesh.data == WORLD
    _save_scenes(tmp_path)
    run_ranks("trainer_fit", WORLD, tmp_path, cfg, 2, "fit")
    fit = _results(tmp_path, "fit")
    history = fit[0]["history"]
    assert len(history) == 2 and np.isfinite(history).all()
    assert history[1] < history[0], history
    for r in fit[1:]:
        assert r["history"] == history
        _assert_equal(fit[0]["state"], r["state"], "state")
    assert fit[0]["state"]["step"] == 2 * 4      # 32 scenes / batch 8
    ckpts = tmp_path / "exp" / "dp_port" / "checkpoints_torch"
    assert sorted(os.listdir(ckpts)) == ["epoch_1.pt", "epoch_2.pt"]
    assert (tmp_path / "exp" / "dp_port" / "scalars.jsonl").exists()

    run_ranks("trainer_fit", WORLD, tmp_path, cfg, 2, "resume")
    for r in _results(tmp_path, "resume"):
        assert r["start_epoch"] == 3 and r["history"] == []
        _assert_equal(fit[0]["state"], r["state"], "resumed")

    monkeypatch.chdir(tmp_path)
    one = dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh,
                                                            data=1))
    one.engine.prewarm_shapes = False
    scenes = torch.load(tmp_path / "scenes.pt", weights_only=False)
    t = Trainer(one, scenes["train"], scenes["val"], verbose=False,
                device="cpu")
    assert t.start_epoch == 3
    _assert_equal(fit[0]["state"], t.state_dict(), "one-process")
