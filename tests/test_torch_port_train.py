"""One training step of the small model against the reference's
``make_train_step``.

MultiLabel over SparseConvUNet at the slice tests' size (m=8, 7 levels,
2 scenes x 3,000 points, ``max_points`` 8192, f32), the scene-level
Classification loss and Adam with the StepLR schedule.  The same numpy
rng gives both packages the same ``train_collate`` batch; parameters
and batch-norm statistics are seeded numpy values, loaded into the port
through ``flax_to_state_dict`` and read back through
``state_dict_to_flax``.  The port's step runs on the K2 route (every
width of this model is at most 128) and, with the K2 width gate
lowered to 0, on the K3 route.  Tolerances:

- loss: f32, rtol = 1e-5;
- every parameter gradient: rtol = atol = 1e-4 (the reference's is read
  back from Adam's first moment, ``mu / (1 - b1)``);
- batch-norm running statistics after the step: rtol = atol = 1e-4;
- parameter updates: Adam's first update is ``-lr * g / (|g| + eps)``,
  about ``-lr * sign(g)``, so where ``|g_ref| > 1e-4`` (far above the
  gradients' agreement) the updates must agree within 1e-6 (1e-3 of lr);
  elsewhere a sign of a gradient near zero may differ, and the updates
  must agree within 2 * lr, and in sign wherever the two gradients
  agree in sign.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_common import (_cfgs, _random_variables,
                                      count_route_calls)
from tdwss.data.collate import train_collate as ref_train_collate
from tdwss.data.plans import attach_host_plans as ref_attach
from tdwss.data.plans import slim_batch_for_train as ref_slim
from tdwss.data.synthetic import make_dataset as ref_make_dataset
from tdwss.engine.steps import TrainState, make_train_step
from tdwss.engine.steps import make_optimizer as ref_make_optimizer
from tdwss.models import build_model as ref_build_model
from tdwss.ops.host_plan import reset_sticky_plans as ref_reset
from tdwss.ops.sparse_conv import force_einsum
from tdwss_torch.convert import flax_to_state_dict, state_dict_to_flax
from tdwss_torch.data.collate import train_collate
from tdwss_torch.data.plans import attach_host_plans, slim_batch_for_train
from tdwss_torch.data.synthetic import make_dataset
from tdwss_torch.engine.steps import make_optimizer, train_step
from tdwss_torch.models.meta_arch import build_model
from tdwss_torch.ops import sparse_conv as port_sc
from tdwss_torch.ops.host_plan import reset_sticky_plans

LOSS_RTOL = 1e-5
F32_TOL = dict(rtol=1e-4, atol=1e-4)
STEPS_PER_EPOCH = 100


def _leaves(tree, prefix=()):
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


@pytest.fixture(scope="module")
def step():
    ref_cfg, port_cfg = _cfgs("float32")
    ref_scenes = ref_make_dataset(2, num_points=3000, seed=103,
                                  with_text=False)
    scenes = make_dataset(2, num_points=3000, seed=103, with_text=False)
    ref_reset()
    ref_b = ref_slim(ref_attach(ref_train_collate(
        ref_scenes, ref_cfg, np.random.default_rng(5)), ref_cfg), ref_cfg)
    reset_sticky_plans()
    port_b = slim_batch_for_train(attach_host_plans(train_collate(
        scenes, port_cfg, np.random.default_rng(5)), port_cfg), port_cfg)
    ref_bj = jax.tree_util.tree_map(jnp.asarray, ref_b)
    model = ref_build_model(ref_cfg)
    with force_einsum():
        shapes = jax.eval_shape(
            lambda r, b: model.init(r, b, istrain=True),
            jax.random.PRNGKey(0), ref_bj)
    rng = np.random.default_rng(1)
    params = _random_variables(shapes["params"], rng)
    stats = _random_variables(shapes["batch_stats"], rng)
    tx = ref_make_optimizer(ref_cfg, STEPS_PER_EPOCH)
    state = TrainState(params=params, batch_stats=stats,
                       opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    new_state, aux = jax.jit(make_train_step(ref_cfg, model, tx))(
        state, ref_bj)
    mu = new_state.opt_state[0].mu
    return dict(port_cfg=port_cfg, port_b=port_b.to("cpu"), params=params,
                stats=stats, loss=float(aux["loss"]),
                grads=jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                             mu),
                new_params=jax.device_get(new_state.params),
                new_stats=jax.device_get(new_state.batch_stats))


def _port_step(step):
    model = build_model(step["port_cfg"], device="cpu")
    model.load_state_dict(flax_to_state_dict(step["params"], step["stats"]))
    opt, sched = make_optimizer(step["port_cfg"], model, STEPS_PER_EPOCH)
    loss, aux = train_step(step["port_cfg"], model, opt, sched,
                           step["port_b"])
    grads, _ = state_dict_to_flax(
        {n: p.grad for n, p in model.named_parameters()})
    params, stats = state_dict_to_flax(model.state_dict())
    return loss, aux, grads, params, stats, sched


@pytest.mark.parametrize("route", ["k2", "k3"])
def test_train_step_matches_reference(step, route, monkeypatch):
    calls = count_route_calls(monkeypatch, ["windowed_bwd_gather",
                                            "windowed_dw_sub"])
    if route == "k3":
        monkeypatch.setattr(port_sc, "_GATHER_MAX_C", 0)
    loss, aux, grads, params, stats, sched = _port_step(step)
    if route == "k2":
        assert calls["windowed_bwd_gather"] > 0
        assert calls["windowed_dw_sub"] == 0
    else:
        assert calls == {"windowed_bwd_gather": 0,
                         "windowed_dw_sub": calls["windowed_dw_sub"]}
        assert calls["windowed_dw_sub"] > 0
    assert torch.isfinite(loss) and float(aux["cls_loss"]) == float(loss)
    np.testing.assert_allclose(float(loss), step["loss"], rtol=LOSS_RTOL)

    ref_grads = dict(_leaves(step["grads"]))
    got = dict(_leaves(grads))
    assert got.keys() == ref_grads.keys()
    for path, g in got.items():
        np.testing.assert_allclose(g, ref_grads[path], **F32_TOL,
                                   err_msg="/".join(path))
    ref_stats = dict(_leaves(step["new_stats"]))
    got_stats = dict(_leaves(stats))
    assert got_stats.keys() == ref_stats.keys()
    for path, s in got_stats.items():
        np.testing.assert_allclose(s, ref_stats[path], **F32_TOL,
                                   err_msg="/".join(path))

    lr = step["port_cfg"].lr
    old = dict(_leaves(step["params"]))
    ref_new = dict(_leaves(step["new_params"]))
    for path, p in dict(_leaves(params)).items():
        d_port, d_ref = p - old[path], ref_new[path] - old[path]
        clear = np.abs(ref_grads[path]) > 1e-4
        diff = np.abs(d_port - d_ref)
        assert diff[clear].max(initial=0.0) <= 1e-6, "/".join(path)
        assert diff.max(initial=0.0) <= 2 * lr, "/".join(path)
        same_sign = np.sign(got[path]) == np.sign(ref_grads[path])
        np.testing.assert_array_equal(np.sign(d_port)[same_sign],
                                      np.sign(d_ref)[same_sign],
                                      err_msg="/".join(path))
    assert sched.get_last_lr() == [lr]      # step 1 is still epoch 0
