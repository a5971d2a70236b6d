"""The port's data-parallel step (``tdwss_torch.parallel.dp``) on gloo
ranks on the CPU, against the reference's ``make_dp_train_step``.

MultiLabel over a small SparseConvFCNet (m=4, depth 2, f32, host plans,
batches of 2 scenes of 600 points, elastic deformation off), its
parameters drawn by the reference's ``init_state`` and carried over by
``flax_to_state_dict``:

- two *different* batches, one per rank, on 2 ranks against the
  reference's step on a 2-device mesh with the two batches stacked, two
  steps each: the losses within rtol 1e-5, the parameters after the two
  steps within rtol 1e-4, atol 1e-6 (``tests/test_parallel.py``'s
  limits), the batch-norm running statistics within 1e-5, and the two
  ranks' parameters and statistics equal bit for bit;
- the same batch on both ranks equals the one-process port step bit for
  bit (the mean of equal values is exact), as
  ``test_dp_step_matches_single_device`` holds the reference's;
- ``train_batches(shard=(rank, world))`` over all ranks gives the
  reference's ``dp_train_batches`` groups: the non-plan leaves equal,
  the plans equal to the reference's unharmonised batch at position
  ``k * world + rank`` (each batch planned from a fresh sticky
  registry on both sides), and the incomplete last group dropped.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_dp_workers import run_ranks
from tdwss.config import (Config, EngineConfig, LossConfig,
                          PointcloudDataConfig, PointcloudModelConfig)
from tdwss.data.collate import train_collate as ref_train_collate
from tdwss.data.loader import train_batches as ref_train_batches
from tdwss.data.plans import attach_host_plans as ref_attach
from tdwss.data.synthetic import make_dataset as ref_make_dataset
from tdwss.engine.steps import init_state, make_optimizer as ref_make_opt
from tdwss.models import build_model as ref_build_model
from tdwss.ops.host_plan import reset_sticky_plans as ref_reset
from tdwss.parallel.dp import (dp_train_batches, make_dp_train_step,
                               make_mesh, shard_batch, stack_batches)
from tdwss_torch import config as pc
from tdwss_torch.convert import flax_to_state_dict, state_dict_to_flax
from tdwss_torch.data.collate import train_collate
from tdwss_torch.data.loader import train_batches
from tdwss_torch.data.plans import attach_host_plans
from tdwss_torch.data.synthetic import make_dataset
from tdwss_torch.ops.host_plan import reset_sticky_plans

WORLD = 2
STEPS = 2
SPE = 4
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
STATS_TOL = dict(rtol=1e-5, atol=1e-5)

_MODEL = dict(name="SparseConvFCNet", m=4, full_scale=64, block_reps=1,
              depth=2)
_DATA = dict(scale=10, batch_size=2, elastic_deformation=False)
_ENGINE = dict(max_points=1024, min_level_capacity=256)


def _ref_cfg(**data):
    return Config(
        model_name="MultiLabel",
        pointcloud_data=PointcloudDataConfig(**dict(_DATA, **data)),
        pointcloud_model=PointcloudModelConfig(**_MODEL),
        loss=LossConfig(Classification=True),
        engine=EngineConfig(**_ENGINE, plan_cache_batches=0,
                            collate_workers=1))


def _port_cfg(**data):
    return pc.Config(
        model_name="MultiLabel",
        pointcloud_data=pc.PointcloudDataConfig(**dict(_DATA, **data)),
        pointcloud_model=pc.PointcloudModelConfig(**_MODEL),
        loss=pc.LossConfig(Classification=True),
        engine=pc.EngineConfig(**_ENGINE, collate_workers=1))


def _leaves(tree, prefix=()):
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _batches(n):
    """n planned batches of different scenes in each package, each from
    a fresh sticky registry and the same numpy rng."""
    ref_cfg, port_cfg = _ref_cfg(), _port_cfg()
    ref_out, port_out = [], []
    for i in range(n):
        ref_reset()
        ref_out.append(ref_attach(ref_train_collate(
            ref_make_dataset(2, num_points=600, seed=50 + i,
                             with_text=False),
            ref_cfg, np.random.default_rng(10 + i)), ref_cfg))
        reset_sticky_plans()
        port_out.append(attach_host_plans(train_collate(
            make_dataset(2, num_points=600, seed=50 + i, with_text=False),
            port_cfg, np.random.default_rng(10 + i)), port_cfg).to("cpu"))
    ref_reset()
    reset_sticky_plans()
    return ref_out, port_out


@pytest.fixture(scope="module")
def ref_dp():
    """The reference's two DP steps on a 2-device mesh, two batches."""
    ref_cfg = _ref_cfg()
    ref_b, port_b = _batches(WORLD)
    model = ref_build_model(ref_cfg)
    tx = ref_make_opt(ref_cfg, SPE)
    state0 = init_state(ref_cfg, model, tx,
                        jax.tree_util.tree_map(jnp.asarray, ref_b[0]))
    mesh = make_mesh(WORLD)
    stacked = shard_batch(stack_batches(ref_b), mesh)
    step = make_dp_train_step(ref_cfg, model, tx, mesh)
    state, losses = state0, []
    for _ in range(STEPS):
        state, aux = step(state, stacked)
        losses.append(float(aux["loss"]))
    return dict(
        port_b=port_b, losses=losses,
        init=flax_to_state_dict(jax.device_get(state0.params),
                                jax.device_get(state0.batch_stats)),
        params=dict(_leaves(jax.device_get(state.params))),
        stats=dict(_leaves(jax.device_get(state.batch_stats))))


def _save_inputs(tmp_path, init, batches):
    torch.save({"cfg": _port_cfg(), "state": init, "spe": SPE},
               tmp_path / "init.pt")
    for r, b in enumerate(batches):
        torch.save(b, tmp_path / f"batch{r}.pt")


def _outs(tmp_path):
    return [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _assert_states_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_dp_step_matches_reference_mesh(ref_dp, tmp_path):
    _save_inputs(tmp_path, ref_dp["init"], ref_dp["port_b"])
    run_ranks("dp_steps", WORLD, tmp_path, STEPS, False)
    outs = _outs(tmp_path)
    for o in outs[1:]:
        _assert_states_equal(outs[0]["state"], o["state"])
        assert o["losses"] == outs[0]["losses"]
    np.testing.assert_allclose(outs[0]["losses"], ref_dp["losses"],
                               rtol=LOSS_RTOL)
    params, stats = state_dict_to_flax(outs[0]["state"])
    got_p, got_s = dict(_leaves(params)), dict(_leaves(stats))
    assert got_p.keys() == ref_dp["params"].keys()
    assert got_s.keys() == ref_dp["stats"].keys()
    init_p = dict(_leaves(state_dict_to_flax(ref_dp["init"])[0]))
    for k, want in ref_dp["params"].items():
        np.testing.assert_allclose(got_p[k], want, **PARAM_TOL,
                                   err_msg=str(k))
    assert any(not np.array_equal(want, init_p[k])
               for k, want in ref_dp["params"].items())
    for k, want in ref_dp["stats"].items():
        np.testing.assert_allclose(got_s[k], want, **STATS_TOL,
                                   err_msg=str(k))


def test_dp_step_same_batch_equals_one_process_step(ref_dp, tmp_path):
    same = [ref_dp["port_b"][0]] * WORLD
    _save_inputs(tmp_path, ref_dp["init"], same)
    run_ranks("dp_steps", WORLD, tmp_path, STEPS, True)
    outs = _outs(tmp_path)
    assert outs[0]["losses"] == outs[0]["single_losses"]
    _assert_states_equal(outs[0]["state"], outs[0]["single_state"])
    _assert_states_equal(outs[0]["state"], outs[1]["state"])


def _plain(batch):
    """The non-plan leaves of a batch as numpy arrays."""
    skip = {"plans", "text"}
    return {f.name: np.asarray(getattr(batch, f.name))
            for f in dataclasses.fields(batch)
            if f.name not in skip and getattr(batch, f.name) is not None}


def _plan_arrays(plans):
    """Every array leaf of a plan tree, by path (either package)."""
    out = {}

    def walk(obj, path):
        if obj is None or isinstance(obj, (int, float, str)):
            return
        if isinstance(obj, (np.ndarray, np.generic, jax.Array,
                            torch.Tensor)):
            out[path] = np.asarray(obj)
        elif isinstance(obj, (tuple, list)):
            for i, v in enumerate(obj):
                walk(v, path + (i,))
        elif dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                if f.name != "spill_order":        # port-only field
                    walk(getattr(obj, f.name), path + (f.name,))

    walk(plans, ())
    return out


def _fresh_each(gen, reset):
    """The items of ``gen``, each built from a fresh sticky registry."""
    out = []
    while True:
        reset()
        item = next(gen, None)
        if item is None:
            return out
        out.append(item)


def test_sharded_train_batches_equal_reference_dp_groups():
    world, epoch = 2, 1
    ref_cfg, port_cfg = _ref_cfg(), _port_cfg()
    ref_scenes = ref_make_dataset(14, num_points=600, seed=7,
                                  with_text=False)
    scenes = make_dataset(14, num_points=600, seed=7, with_text=False)
    # 14 scenes, 2 per rank: 7 batches, so 3 groups of 2 and 1 dropped
    groups = list(dp_train_batches(ref_scenes, ref_cfg, epoch, world))
    assert len(groups) == 3
    flat = _fresh_each(iter(ref_train_batches(ref_scenes, ref_cfg, epoch,
                                              prefetch=False)), ref_reset)
    assert len(flat) == 7
    for r in range(world):
        mine = _fresh_each(iter(train_batches(
            scenes, port_cfg, epoch, prefetch=False, shard=(r, world))),
            reset_sticky_plans)
        assert len(mine) == len(groups)
        for k, batch in enumerate(mine):
            want = jax.tree_util.tree_map(lambda x: np.asarray(x)[r],
                                          groups[k])
            got = _plain(batch)
            assert got.keys() == _plain(want).keys()
            for name, value in _plain(want).items():
                np.testing.assert_array_equal(got[name], value,
                                              err_msg=name)
            ref_plans = _plan_arrays(flat[k * world + r].plans)
            port_plans = _plan_arrays(batch.plans)
            assert port_plans.keys() == ref_plans.keys()
            for path, value in ref_plans.items():
                np.testing.assert_array_equal(port_plans[path], value,
                                              err_msg=str(path))
    ref_reset()
    reset_sticky_plans()
