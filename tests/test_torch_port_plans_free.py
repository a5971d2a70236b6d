"""The plans-free branch (``engine.host_plans: false``): MultiLabel
through the device voxelizer and planner against the reference's
(``test_torch_port_plans_free_ops.py`` holds the voxelizer and planner
themselves).

- MultiLabel over a small SparseConvFCNet and a small SparseConvUNet,
  f32, parameters and batch-norm statistics seeded and carried over by
  ``flax_to_state_dict``, on batches without host plans:
  - the eval logits against the reference's plans-free forward within
    1e-5 (rtol and atol);
  - one training step against ``make_train_step``: the loss within rtol
    1e-5, every gradient (Adam's first moment / 0.1) and the running
    statistics within 1e-4;
  - the port's plans-free logits against its own host-planned logits on
    the same points within 1e-5, and no kernel entry point called on the
    plans-free path;
  - the loader's ``host_plans: false`` train batches equal to the
    reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_common import _random_variables, count_route_calls
from tdwss.config import (Config, EngineConfig, LossConfig,
                          PointcloudDataConfig, PointcloudModelConfig)
from tdwss.data.collate import train_collate as ref_train_collate
from tdwss.data.collate import val_collate as ref_val_collate
from tdwss.data.dataset import val_offsets as ref_val_offsets
from tdwss.data.loader import train_batches as ref_train_batches
from tdwss.data.synthetic import make_dataset as ref_make_dataset
from tdwss.engine.steps import (TrainState, make_eval_step,
                                make_train_step)
from tdwss.engine.steps import make_optimizer as ref_make_optimizer
from tdwss.models import build_model as ref_build_model
from tdwss.ops.sparse_conv import force_einsum
from tdwss_torch import config as pc
from tdwss_torch.convert import flax_to_state_dict, state_dict_to_flax
from tdwss_torch.data.collate import train_collate, val_collate
from tdwss_torch.data.dataset import val_offsets
from tdwss_torch.data.loader import train_batches
from tdwss_torch.data.plans import attach_host_plans
from tdwss_torch.data.synthetic import make_dataset
from tdwss_torch.engine.steps import make_optimizer, train_step
from tdwss_torch.models.meta_arch import build_model
from tdwss_torch.ops.host_plan import reset_sticky_plans

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-5
F32_TOL = dict(rtol=1e-4, atol=1e-4)
SPE = 100
KERNELS = ["windowed_matmul_sub", "windowed_matmul", "windowed_bwd_gather",
           "windowed_bwd_sub", "windowed_dw_sub", "windowed_dw"]


_MODELS = {
    "fcnet": dict(name="SparseConvFCNet", m=4, full_scale=128,
                  block_reps=1, depth=3),
    "unet": dict(name="SparseConvUNet", m=4, full_scale=4096,
                 block_reps=1, residual_blocks=True),
}
_SCALE = {"fcnet": 10, "unet": 20}


def _cfgs(kind, host_plans=False):
    data = dict(scale=_SCALE[kind], val_reps=1, batch_size=2,
                elastic_deformation=False)
    engine = dict(max_points=8192, min_level_capacity=256,
                  host_plans=host_plans, collate_workers=1)
    ref = Config(model_name="MultiLabel",
                 pointcloud_data=PointcloudDataConfig(**data),
                 pointcloud_model=PointcloudModelConfig(**_MODELS[kind]),
                 loss=LossConfig(Classification=True),
                 engine=EngineConfig(**engine, plan_cache_batches=0))
    port = pc.Config(model_name="MultiLabel",
                     pointcloud_data=pc.PointcloudDataConfig(**data),
                     pointcloud_model=pc.PointcloudModelConfig(
                         **_MODELS[kind]),
                     loss=pc.LossConfig(Classification=True),
                     engine=pc.EngineConfig(**engine))
    return ref, port


def _leaves(tree, prefix=()):
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


@pytest.fixture(scope="module", params=["fcnet", "unet"])
def case(request):
    """The reference's plans-free eval logits and one train step of a
    seeded MultiLabel, and the port's batches of the same points."""
    kind = request.param
    ref_cfg, port_cfg = _cfgs(kind)
    ref_scenes = ref_make_dataset(2, num_points=3000, seed=105,
                                  with_text=False)
    scenes = make_dataset(2, num_points=3000, seed=105, with_text=False)
    seq = np.random.SeedSequence([0, 7777, 1, 0])
    ref_val = ref_val_collate(ref_scenes, ref_cfg,
                              np.random.default_rng(seq),
                              ref_val_offsets(ref_scenes)[0], [0, 1], None,
                              num_scenes=2)
    port_val = val_collate(scenes, port_cfg, np.random.default_rng(seq),
                           val_offsets(scenes)[0], [0, 1], num_scenes=2)
    ref_train = ref_train_collate(ref_scenes, ref_cfg,
                                  np.random.default_rng(6))
    port_train = train_collate(scenes, port_cfg, np.random.default_rng(6))
    model = ref_build_model(ref_cfg)
    ref_tb = jax.tree_util.tree_map(jnp.asarray, ref_train)
    with force_einsum():
        shapes = jax.eval_shape(
            lambda r, b: model.init(r, b, istrain=True),
            jax.random.PRNGKey(0), ref_tb)
    rng = np.random.default_rng(3)
    params = _random_variables(shapes["params"], rng)
    stats = _random_variables(shapes["batch_stats"], rng)
    logits = jax.jit(make_eval_step(model))(
        params, stats, jax.tree_util.tree_map(jnp.asarray, ref_val))
    tx = ref_make_optimizer(ref_cfg, SPE)
    state = TrainState(params=params, batch_stats=stats,
                       opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    new_state, aux = jax.jit(make_train_step(ref_cfg, model, tx))(
        state, ref_tb)
    return dict(
        kind=kind, port_cfg=port_cfg, params=params, stats=stats,
        port_val=port_val.to("cpu"), port_train=port_train.to("cpu"),
        logits=np.asarray(logits), loss=float(aux["loss"]),
        grads=dict(_leaves(jax.tree_util.tree_map(
            lambda m: np.asarray(m) / 0.1, new_state.opt_state[0].mu))),
        new_stats=dict(_leaves(jax.device_get(new_state.batch_stats))),
        scenes=scenes)


def _port_model(case, cfg=None):
    model = build_model(cfg or case["port_cfg"], device="cpu")
    model.load_state_dict(flax_to_state_dict(case["params"], case["stats"]))
    return model


def test_plans_free_logits_match_reference(case, monkeypatch):
    calls = count_route_calls(monkeypatch, KERNELS)
    assert case["port_val"].plans is None
    with torch.no_grad():
        got = _port_model(case)(case["port_val"]).numpy()
    np.testing.assert_allclose(got, case["logits"], **LOGIT_TOL)
    assert not any(calls.values()), calls


def test_plans_free_train_step_matches_reference(case, monkeypatch):
    calls = count_route_calls(monkeypatch, KERNELS)
    model = _port_model(case)
    opt, sched = make_optimizer(case["port_cfg"], model, SPE)
    loss, _ = train_step(case["port_cfg"], model, opt, sched,
                         case["port_train"])
    assert not any(calls.values()), calls
    np.testing.assert_allclose(float(loss), case["loss"], rtol=LOSS_RTOL)
    grads, _ = state_dict_to_flax(
        {n: p.grad for n, p in model.named_parameters()})
    _, stats = state_dict_to_flax(model.state_dict())
    for got, want in ((dict(_leaves(grads)), case["grads"]),
                      (dict(_leaves(stats)), case["new_stats"])):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **F32_TOL,
                                       err_msg=str(k))


def test_plans_free_logits_match_host_planned(case):
    _, host_cfg = _cfgs(case["kind"], host_plans=True)
    reset_sticky_plans()
    planned = attach_host_plans(case["port_val"], host_cfg).to("cpu")
    reset_sticky_plans()
    model = _port_model(case)
    with torch.no_grad():
        free = model(case["port_val"]).numpy()
        host = model(planned).numpy()
    np.testing.assert_allclose(free, host, **LOGIT_TOL)


def test_plans_free_loader_batches_match_reference(case):
    ref_cfg, port_cfg = _cfgs(case["kind"])
    ref_scenes = ref_make_dataset(6, num_points=1500, seed=9,
                                  with_text=False)
    scenes = make_dataset(6, num_points=1500, seed=9, with_text=False)
    ref_out = list(ref_train_batches(ref_scenes, ref_cfg, 1,
                                     prefetch=False))
    port_out = list(train_batches(scenes, port_cfg, 1, prefetch=False))
    assert len(port_out) == len(ref_out) == 3
    for want, got in zip(ref_out, port_out):
        assert got.plans is None and got.vox_feats is None
        for f in dataclasses.fields(want):
            a = getattr(want, f.name)
            if f.name == "text" or a is None:
                continue
            np.testing.assert_array_equal(np.asarray(getattr(got, f.name)),
                                          np.asarray(a), err_msg=f.name)
