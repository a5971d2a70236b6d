"""``engine.remat``: the encoder body under ``torch.utils.checkpoint``
against the reference's ``nn.remat`` step and against the port's own
step without remat.

``configs/smoke_cpu.yaml`` with ``engine.remat: true`` (MultiLabel over
SparseConvFCNet, m=4, depth 3, f32) on 2 synthetic scenes of 3,000
points through both packages' ``train_collate`` with the same numpy rng;
seeded parameters and batch-norm statistics go in through
``flax_to_state_dict``.  Tolerances:

- against the reference's remat step (``make_train_step`` with
  ``engine.remat``): those of ``test_torch_port_fcn_train.py``, the loss
  rtol = 1e-5, every parameter gradient and the running statistics
  rtol = atol = 1e-4;
- against the port's step without remat on the same route: bit for bit
  (loss, gradients, updated parameters, running statistics): the
  recomputed forward feeds the same backward, and batch norm updates its
  running statistics in the first forward only.

The body's forward runs twice per step under remat: the windowed unpool
(``_identity_apply``) is called three times per unpool (two forwards, one
backward) where the plain step calls it twice.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_common import _random_variables, count_route_calls
from tdwss.config import load_config as ref_load_config
from tdwss.data.collate import train_collate as ref_train_collate
from tdwss.data.plans import attach_host_plans as ref_attach
from tdwss.data.plans import slim_batch_for_train as ref_slim
from tdwss.data.synthetic import make_dataset as ref_make_dataset
from tdwss.engine.steps import TrainState, make_train_step
from tdwss.engine.steps import make_optimizer as ref_make_optimizer
from tdwss.models import build_model as ref_build_model
from tdwss.ops.host_plan import reset_sticky_plans as ref_reset
from tdwss.ops.sparse_conv import force_einsum
from tdwss_torch.config import load_config
from tdwss_torch.convert import flax_to_state_dict, state_dict_to_flax
from tdwss_torch.data.collate import train_collate
from tdwss_torch.data.plans import attach_host_plans, slim_batch_for_train
from tdwss_torch.data.synthetic import make_dataset
from tdwss_torch.engine.steps import make_optimizer, train_step
from tdwss_torch.models.meta_arch import build_model
from tdwss_torch.ops import sparse_conv as port_sc
from tdwss_torch.ops.host_plan import reset_sticky_plans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "smoke_cpu.yaml")
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
    ref_cfg, port_cfg = ref_load_config(SMOKE), load_config(SMOKE)
    ref_cfg.engine.plan_cache_batches = 0
    ref_cfg.engine.collate_workers = 1
    ref_cfg.engine.remat = True
    port_cfg.engine.remat = True
    ref_scenes = ref_make_dataset(2, num_points=3000, seed=105,
                                  with_text=False)
    scenes = make_dataset(2, num_points=3000, seed=105, with_text=False)
    ref_reset()
    ref_b = ref_slim(ref_attach(ref_train_collate(
        ref_scenes, ref_cfg, np.random.default_rng(7)), ref_cfg), ref_cfg)
    reset_sticky_plans()
    port_b = slim_batch_for_train(attach_host_plans(train_collate(
        scenes, port_cfg, np.random.default_rng(7)), port_cfg), port_cfg)
    ref_bj = jax.tree_util.tree_map(jnp.asarray, ref_b)
    model = ref_build_model(ref_cfg)
    with force_einsum():
        shapes = jax.eval_shape(
            lambda r, b: model.init(r, b, istrain=True),
            jax.random.PRNGKey(0), ref_bj)
    rng = np.random.default_rng(3)
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
                new_stats=jax.device_get(new_state.batch_stats))


def _port_step(step, remat):
    cfg = step["port_cfg"]
    cfg.engine.remat = remat
    model = build_model(cfg, device="cpu")
    assert model.pc_encoder.remat is remat
    model.load_state_dict(flax_to_state_dict(step["params"], step["stats"]))
    opt, sched = make_optimizer(cfg, model, STEPS_PER_EPOCH)
    loss, _ = train_step(cfg, model, opt, sched, step["port_b"])
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return loss, grads, {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("route", ["k2", "k6"])
def test_remat_step_matches_reference_and_plain_step(step, route,
                                                     monkeypatch):
    if route == "k6":
        monkeypatch.setattr(port_sc, "_GATHER_MAX_C", 0)
    levels = step["port_b"].plans.levels
    n_unpool = sum(lvl.wg_up is not None and lvl.wg_down is not None
                   for lvl in levels[:-1])
    assert n_unpool > 0
    calls = count_route_calls(monkeypatch, ["_identity_apply"])
    loss, grads, state = _port_step(step, remat=True)
    assert calls["_identity_apply"] == 3 * n_unpool
    calls["_identity_apply"] = 0
    loss0, grads0, state0 = _port_step(step, remat=False)
    assert calls["_identity_apply"] == 2 * n_unpool

    # bit for bit against the port's own step without remat
    assert float(loss) == float(loss0)
    for n in grads0:
        assert torch.equal(grads[n], grads0[n]), n
    for k in state0:
        assert torch.equal(state[k], state0[k]), k

    # against the reference's remat step
    np.testing.assert_allclose(float(loss), step["loss"], rtol=LOSS_RTOL)
    got_grads, _ = state_dict_to_flax(grads)
    _, got_stats = state_dict_to_flax(state)
    for got, want in ((got_grads, step["grads"]),
                      (got_stats, step["new_stats"])):
        got, want = dict(_leaves(got)), dict(_leaves(want))
        assert got.keys() == want.keys()
        for path, g in got.items():
            np.testing.assert_allclose(g, want[path], **F32_TOL,
                                       err_msg="/".join(path))


def test_no_remat_outside_autograd(step):
    """Without gradients (eval, validation) the body runs once."""
    cfg = step["port_cfg"]
    cfg.engine.remat = True
    model = build_model(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(step["params"], step["stats"]))
    with torch.no_grad():
        a = model(step["port_b"], istrain=True, train=False)[0]
    cfg.engine.remat = False
    plain = build_model(cfg, device="cpu")
    plain.load_state_dict(flax_to_state_dict(step["params"], step["stats"]))
    with torch.no_grad():
        b = plain(step["port_b"], istrain=True, train=False)[0]
    assert torch.equal(a, b)
