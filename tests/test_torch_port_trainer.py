"""The port's ``Trainer`` on a tiny SparseConvFCNet (m=4, depth 2, 4
synthetic scenes of 4,000 points, batches of 2, f32) against the
reference's:

- two epochs from the same seeded parameters (carried over by
  ``flax_to_state_dict``): the mean losses within rtol 1e-4 (epoch 1's
  first step matches to 1e-5, as ``test_torch_port_train.py`` holds; the
  Adam updates that follow move a parameter by about lr * sign(g), and a
  gradient near zero may take the other sign), and the ``scalars.jsonl``
  tags and steps equal;
- a ``Trainer`` built where the first saved its checkpoints resumes at
  the next epoch with the saver's model, optimiser, schedule and step bit
  for bit, and its next epoch equals the saver's bit for bit;
- ``pretrain`` seeds the parameters and batch-norm buffers only (the
  optimiser and step stay fresh), and only on a fresh run;
- validation runs at epochs 1, 2, 4, 8, 16 and 32 and at no other;
- ``mesh.data > 1`` is refused.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_common import _random_variables
from tdwss.config import load_config as ref_load_config
from tdwss.data.synthetic import make_dataset as ref_make_dataset
from tdwss.engine import train as ref_train
from tdwss.engine.steps import TrainState
from tdwss.ops.host_plan import reset_sticky_plans as ref_reset
from tdwss_torch.config import load_config
from tdwss_torch.convert import flax_to_state_dict
from tdwss_torch.data.synthetic import make_dataset
from tdwss_torch.engine import train
from tdwss_torch.ops.host_plan import reset_sticky_plans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "smoke_cpu.yaml")
OVERRIDES = dict(training_name="trainer_parity", epochs=2)


def _tiny(cfg):
    cfg.pointcloud_model.depth = 2
    cfg.pointcloud_model.full_scale = 128
    cfg.pointcloud_data.scale = 10
    cfg.pointcloud_data.val_reps = 1
    cfg.engine.max_points = 8192
    cfg.engine.min_level_capacity = 256
    return cfg


def _scenes(make):
    return (make(4, num_points=4000, seed=31, with_text=False),
            make(1, num_points=4000, seed=131, with_text=False))


def _tags(path):
    with open(path) as f:
        return [(r["tag"], r["step"]) for r in map(json.loads, f)]


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference Trainer's two epochs from seeded parameters."""
    work = tmp_path_factory.mktemp("ref")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        cfg = _tiny(ref_load_config(CONFIG, plan_cache_batches=0,
                                    **OVERRIDES))
        ref_reset()
        t = ref_train.Trainer(cfg, *_scenes(ref_make_dataset),
                              use_checkpoints=False, verbose=False)
        rng = np.random.default_rng(4)
        params = _random_variables(jax.device_get(t.state.params), rng)
        stats = _random_variables(jax.device_get(t.state.batch_stats), rng)
        t.state = TrainState(params=params, batch_stats=stats,
                             opt_state=t.tx.init(params),
                             step=jnp.zeros((), jnp.int32))
        history = t.fit()
        tags = _tags(work / "exp" / cfg.training_name / "scalars.jsonl")
    finally:
        os.chdir(cwd)
    return dict(params=params, stats=stats, history=history, tags=tags)


def _port_cfg(**kw):
    cfg = _tiny(load_config(CONFIG, **OVERRIDES))
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _state_equal(a, b):
    """Two Trainer.state_dict()s equal bit for bit."""
    assert a["step"] == b["step"]
    assert a["scheduler"] == b["scheduler"]
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k, v in sa[i].items():
            assert torch.equal(v, sb[i][k]), (i, k)


@pytest.fixture(scope="module")
def port_run(ref_run, tmp_path_factory):
    work = tmp_path_factory.mktemp("port")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        reset_sticky_plans()
        t = train.Trainer(_port_cfg(), *_scenes(make_dataset),
                          verbose=False, device="cpu")
        t.model.load_state_dict(flax_to_state_dict(ref_run["params"],
                                                   ref_run["stats"]))
        history = t.fit()
    finally:
        os.chdir(cwd)
    return dict(trainer=t, history=history, work=work)


def test_two_epochs_match_reference(ref_run, port_run):
    np.testing.assert_allclose(port_run["history"], ref_run["history"],
                               rtol=1e-4)
    name = OVERRIDES["training_name"]
    tags = _tags(port_run["work"] / "exp" / name / "scalars.jsonl")
    assert tags == ref_run["tags"]
    assert tags == [("Train Loss", 1), ("Validation accuracy", 1),
                    ("Train Loss", 2), ("Validation accuracy", 2)]
    ckpts = sorted(os.listdir(port_run["work"] / "exp" / name
                              / "checkpoints_torch"))
    assert ckpts == ["epoch_1.pt", "epoch_2.pt"]


def test_resume_is_bit_for_bit(port_run, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    saver = train.Trainer(_port_cfg(), *_scenes(make_dataset),
                          verbose=False, device="cpu")
    assert saver.start_epoch == 1
    saver.model.load_state_dict(port_run["trainer"].model.state_dict())
    saver.fit(epochs=1)
    resumed = train.Trainer(_port_cfg(), *_scenes(make_dataset),
                            verbose=False, device="cpu")
    assert resumed.start_epoch == 2
    _state_equal(saver.state_dict(), resumed.state_dict())
    assert saver.run_epoch(2) == resumed.run_epoch(2)
    _state_equal(saver.state_dict(), resumed.state_dict())


def test_pretrain_seeds_parameters_and_buffers_only(port_run, tmp_path,
                                                    monkeypatch):
    monkeypatch.chdir(tmp_path)
    src = port_run["trainer"]
    ckpt_dir = str(port_run["work"] / "exp" / OVERRIDES["training_name"]
                   / "checkpoints_torch")
    cfg = _port_cfg(pretrain=ckpt_dir, training_name="finetune")
    t = train.Trainer(cfg, *_scenes(make_dataset), verbose=False,
                      device="cpu")
    assert t.start_epoch == 1 and t.step == 0
    assert not t.optimizer.state_dict()["state"]
    assert t.scheduler.last_epoch == 0
    sd = src.model.state_dict()
    buffers = {n for n, _ in src.model.named_buffers()}
    assert buffers and all("running_" in n for n in buffers)
    for k, v in t.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    # a resumed run keeps its own state: pretrain is not read
    t.fit(epochs=1)
    again = train.Trainer(cfg, *_scenes(make_dataset), verbose=False,
                          device="cpu")
    assert again.start_epoch == 2
    _state_equal(t.state_dict(), again.state_dict())


def test_validation_schedule(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    seen = []
    monkeypatch.setattr(train, "validate",
                        lambda cfg, model, scenes, **kw: seen.append(0)
                        or [0.5])
    monkeypatch.setattr(train.Trainer, "run_epoch", lambda self, e: 1.0)
    cfg = _port_cfg(epochs=33)
    cfg.engine.prewarm_shapes = False
    t = train.Trainer(cfg, *_scenes(make_dataset), use_checkpoints=False,
                      verbose=False, device="cpu")
    t.fit()
    tags = _tags(tmp_path / "exp" / cfg.training_name / "scalars.jsonl")
    val_epochs = [s for tag, s in tags if tag == "Validation accuracy"]
    assert val_epochs == [1, 2, 4, 8, 16, 32]
    assert len(seen) == 6 and 3 not in val_epochs
    assert [train.is_power2(n) for n in (0, 1, 3, 4, 6, 64)] == [
        False, True, False, True, False, True]


def test_mesh_data_refused():
    cfg = copy.deepcopy(_port_cfg())
    cfg.mesh.data = 4
    with pytest.raises(NotImplementedError, match="A.5"):
        train.Trainer(cfg, [], [], device="cpu")
