"""One f32 training step of ``FullySupervised`` (the pseudo-label round)
against the reference's ``make_train_step``.

``configs/smoke_cpu_pseudo.yaml`` (SparseConvFCNet, m=4, depth 3,
2 scenes, ``max_points`` 16,384) loaded by each package's own loader, on
2 synthetic scenes of 3,000 points whose pseudo labels are drawn from a
numpy rng (-100 at a fifth of the points).  The loss is the scene-level
Classification over the per-scene mean of the point logits plus the
point cross-entropy on the pseudo labels; its backward runs through
``devoxelize_seg``'s run sums.  Parameters and batch-norm statistics are
seeded numpy values carried into the port through ``flax_to_state_dict``
and read back through ``state_dict_to_flax``.  Tolerances as in
``test_torch_port_train.py``: loss rtol 1e-5, every gradient and every
batch-norm statistic after the step rtol = atol = 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_common import _random_variables
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
from tdwss_torch.models.meta_arch import FullySupervised, build_model
from tdwss_torch.ops.host_plan import reset_sticky_plans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "smoke_cpu_pseudo.yaml")
LOSS_RTOL = 1e-5
F32_TOL = dict(rtol=1e-4, atol=1e-4)
STEPS_PER_EPOCH = 100


def _leaves(tree, prefix=()):
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _with_pseudo(scenes, seed):
    rng = np.random.default_rng(seed)
    for s in scenes:
        lab = rng.integers(0, 20, s.points.shape[0]).astype(np.int32)
        lab[rng.random(lab.shape[0]) < 0.2] = -100
        s.pseudo_labels = lab
    return scenes


@pytest.fixture(scope="module")
def step():
    ref_cfg = ref_load_config(CONFIG, plan_cache_batches=0)
    port_cfg = load_config(CONFIG)
    assert port_cfg.label == "pseudo"
    assert port_cfg.model_name == "FullySupervised"
    ref_scenes = _with_pseudo(ref_make_dataset(2, num_points=3000, seed=103,
                                               with_text=False), 9)
    scenes = _with_pseudo(make_dataset(2, num_points=3000, seed=103,
                                       with_text=False), 9)
    ref_reset()
    ref_b = ref_slim(ref_attach(ref_train_collate(
        ref_scenes, ref_cfg, np.random.default_rng(5)), ref_cfg), ref_cfg)
    reset_sticky_plans()
    port_b = slim_batch_for_train(attach_host_plans(train_collate(
        scenes, port_cfg, np.random.default_rng(5)), port_cfg), port_cfg)
    np.testing.assert_array_equal(np.asarray(port_b.point_label),
                                  np.asarray(ref_b.point_label))
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
                stats=stats, aux={k: float(v) for k, v in aux.items()},
                grads=jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                             mu),
                new_stats=jax.device_get(new_state.batch_stats))


def test_fully_supervised_step_matches_reference(step):
    model = build_model(step["port_cfg"], device="cpu")
    assert isinstance(model, FullySupervised)
    model.load_state_dict(flax_to_state_dict(step["params"], step["stats"]))
    opt, sched = make_optimizer(step["port_cfg"], model, STEPS_PER_EPOCH)
    loss, aux = train_step(step["port_cfg"], model, opt, sched,
                           step["port_b"])
    assert torch.isfinite(loss)
    assert set(aux) == set(step["aux"]) == {"loss", "cls_loss", "point_loss"}
    for key, ref in step["aux"].items():
        np.testing.assert_allclose(float(aux[key]), ref, rtol=LOSS_RTOL,
                                   err_msg=key)
    grads, _ = state_dict_to_flax(
        {n: p.grad for n, p in model.named_parameters()})
    ref_grads = dict(_leaves(step["grads"]))
    got = dict(_leaves(grads))
    assert got.keys() == ref_grads.keys()
    for path, g in got.items():
        np.testing.assert_allclose(g, ref_grads[path], **F32_TOL,
                                   err_msg="/".join(path))
    _, stats = state_dict_to_flax(model.state_dict())
    ref_stats = dict(_leaves(step["new_stats"]))
    got_stats = dict(_leaves(stats))
    assert got_stats.keys() == ref_stats.keys()
    for path, s in got_stats.items():
        np.testing.assert_allclose(s, ref_stats[path], **F32_TOL,
                                   err_msg="/".join(path))


def test_fully_supervised_tree_converts_both_ways(step):
    """``convert.py`` carries FullySupervised's tree (``pc_encoder`` +
    ``linear``, as MultiLabel's) both ways without loss."""
    model = build_model(step["port_cfg"], device="cpu")
    sd = flax_to_state_dict(step["params"], step["stats"])
    model.load_state_dict(sd)
    params, stats = state_dict_to_flax(model.state_dict())
    for tree, ref in ((params, step["params"]), (stats, step["stats"])):
        got, want = dict(_leaves(tree)), dict(_leaves(ref))
        assert got.keys() == want.keys()
        for path, v in got.items():
            assert v.tobytes() == want[path].tobytes(), "/".join(path)
