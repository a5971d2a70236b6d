"""The first data-parallel epoch of the port's ``Trainer`` against the
reference's DP ``Trainer``.

The shrunk 4-chip config of ``test_torch_port_dp_trainer.py`` in f32
with elastic deformation off: the reference ``Trainer`` on a 4-device
mesh (``tests/conftest.py`` gives 8 virtual CPU devices) fits one epoch
from its initial parameters, which the port's 4 gloo ranks load as a
``pretrain`` checkpoint (``flax_to_state_dict``); neither validates (no
val scenes), since only the loss is compared.  The first epoch's
mean loss agrees within rtol 1e-4 (the limit of the one-process parity
in ``test_torch_port_trainer.py``: the Adam updates after the first
step move a parameter by about lr * sign(g), and a gradient near zero
may take the other sign), and the ranks end equal bit for bit.
"""

import os

import jax
import numpy as np
import pytest
import torch

from tests._torch_port_dp_workers import run_ranks
from tests.test_torch_port_dp_trainer import (CONFIG, WORLD, _assert_equal,
                                              _overrides, _results,
                                              _save_scenes)
from tdwss.config import load_config as ref_load_config
from tdwss.data.synthetic import make_dataset as ref_make_dataset
from tdwss.engine import train as ref_train
from tdwss.ops.host_plan import reset_sticky_plans as ref_reset
from tdwss_torch.config import load_config
from tdwss_torch.convert import flax_to_state_dict

LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def ref_first_epoch(tmp_path_factory):
    """The reference DP Trainer's first epoch on a 4-device mesh, f32,
    and its initial parameters as a port pretrain checkpoint."""
    work = tmp_path_factory.mktemp("ref_dp")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        cfg = ref_load_config(CONFIG, plan_cache_batches=0,
                              **_overrides("dp_ref",
                                           elastic_deformation=False))
        cfg.engine.compute_dtype = "float32"
        ref_reset()
        t = ref_train.Trainer(
            cfg, ref_make_dataset(32, num_points=600, seed=21,
                                  with_text=False),
            [],                         # no validation: the loss alone
            use_checkpoints=False, verbose=False)
        assert len(t.mesh.devices) == WORLD
        pre = work / "pretrain"
        pre.mkdir()
        torch.save({"model": flax_to_state_dict(
            jax.device_get(t.state.params),
            jax.device_get(t.state.batch_stats))}, pre / "epoch_1.pt")
        history = t.fit(epochs=1)
        ref_reset()
    finally:
        os.chdir(cwd)
    return dict(pretrain=str(pre), loss=history[0])


def test_dp_trainer_first_epoch_matches_reference(ref_first_epoch,
                                                  tmp_path):
    cfg = load_config(CONFIG, **_overrides(
        "dp_pre", elastic_deformation=False),
        pretrain=ref_first_epoch["pretrain"])
    cfg.engine.compute_dtype = "float32"
    _save_scenes(tmp_path, val=False)
    run_ranks("trainer_fit", WORLD, tmp_path, cfg, 1, "pre")
    res = _results(tmp_path, "pre")
    assert res[0]["start_epoch"] == 1
    np.testing.assert_allclose(res[0]["history"][0], ref_first_epoch["loss"],
                               rtol=LOSS_RTOL)
    for r in res[1:]:
        _assert_equal(res[0]["state"], r["state"], "state")
