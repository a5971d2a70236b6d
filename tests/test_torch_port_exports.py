"""The port's package surface against the reference's: every name that
``tdwss/{ops,models,engine,parallel}/__init__.py`` exports has a
counterpart under the same name in ``tdwss_torch.<package>``, a function,
a class or an equal constant where the reference's is one (not the
submodule that an export of the same name shadows), and the port's own
module where the reference's is a registering import; the names left out
on purpose are listed below with the reason.  Then the minimal flow of
the package's public exports (voxelize -> build_plans -> subm_conv_apply
-> devoxelize -> segment_mean_by_batch) on the CPU against the
reference's on the same points.
"""

import ast
import importlib
import inspect
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("ops", "models", "engine", "parallel")

# ROADMAP.md section A, "left out on purpose"
LEFT_OUT = {
    ("engine", "TrainState"): "XLA/jit machinery: the port's steps are "
    "plain functions (engine.train_step, engine.eval_step)",
    ("engine", "make_train_step"): "XLA/jit machinery (engine.train_step)",
    ("engine", "make_eval_step"): "XLA/jit machinery (engine.eval_step)",
    ("parallel", "make_dp_train_step"): "one jitted step over a device "
    "mesh; each rank of the port steps on its own batch and "
    "average_gradients keeps the replicas equal",
    ("parallel", "make_mesh"): "a jit device mesh: torch.distributed "
    "groups take its place",
    ("parallel", "shard_batch"): "jit needs one stacked shape across "
    "devices; each rank plans its own batch",
    ("parallel", "stack_batches"): "jit needs one stacked shape across "
    "devices; each rank plans its own batch",
}
# the port's counterparts of the left-out names, exported under their own
PORT_OWN = {"engine": ("train_step", "eval_step"),
            "parallel": ("dp_device", "average_gradients",
                         "average_batch_stats", "average_scalars",
                         "broadcast_state")}


def _exports(pkg):
    """The names bound by the ``from ... import`` statements of the
    reference's ``tdwss/<pkg>/__init__.py``."""
    with open(os.path.join(REPO, "tdwss", pkg, "__init__.py")) as f:
        tree = ast.parse(f.read())
    return [a.asname or a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for a in node.names]


CASES = [(pkg, name) for pkg in PACKAGES for name in _exports(pkg)]


def test_every_package_exports_something():
    assert {pkg for pkg, _ in CASES} == set(PACKAGES)
    assert len(CASES) >= 19 + 13 + 5 + 4
    assert all(key in CASES for key in LEFT_OUT)


@pytest.mark.parametrize("pkg,name", CASES,
                         ids=[f"{p}.{n}" for p, n in CASES])
def test_export_has_its_counterpart(pkg, name):
    ref = getattr(importlib.import_module(f"tdwss.{pkg}"), name)
    port_pkg = importlib.import_module(f"tdwss_torch.{pkg}")
    if (pkg, name) in LEFT_OUT:
        assert not hasattr(port_pkg, name), LEFT_OUT[(pkg, name)]
        return
    got = getattr(port_pkg, name)
    if isinstance(ref, types.ModuleType):
        # a registering import: the port's module of the same name
        assert got is importlib.import_module(f"tdwss_torch.{pkg}.{name}")
        return
    assert not isinstance(got, types.ModuleType), f"{pkg}.{name} is a module"
    if inspect.isclass(ref) or inspect.isfunction(ref):
        assert inspect.isclass(got) == inspect.isclass(ref)
        assert callable(got) and got.__name__ == ref.__name__
        assert got.__module__.startswith("tdwss_torch.")
    else:
        assert got == ref, f"{pkg}.{name}: {got!r} != {ref!r}"


@pytest.mark.parametrize("pkg", sorted(PORT_OWN))
def test_port_exports_its_own_counterparts(pkg):
    port_pkg = importlib.import_module(f"tdwss_torch.{pkg}")
    for name in PORT_OWN[pkg]:
        obj = getattr(port_pkg, name)
        assert inspect.isfunction(obj), name
        assert obj.__module__.startswith(f"tdwss_torch.{pkg}.")


def test_minimal_flow_matches_the_reference():
    """SKILL.md's minimal flow through the public exports, in both
    packages on the same points: the grid and the rulebooks equal, the
    subm conv, the devoxelized features and the per-scene means within
    1e-5 (f32; the reference's sums run in another order)."""
    from tdwss.ops import build_plans as r_build_plans
    from tdwss.ops import devoxelize as r_devoxelize
    from tdwss.ops import segment_mean_by_batch as r_segment_mean
    from tdwss.ops import subm_conv_apply as r_subm
    from tdwss.ops import voxelize as r_voxelize
    from tdwss.ops.plan import level_capacities as r_capacities
    from tdwss_torch.ops import (build_plans, devoxelize,
                                 segment_mean_by_batch, subm_conv_apply,
                                 voxelize)
    from tdwss_torch.ops.plan import level_capacities

    rng = np.random.default_rng(0)
    n = 4096
    coords = np.concatenate([rng.integers(0, 64, (n, 3)),
                             rng.integers(0, 2, (n, 1))], 1).astype(np.int32)
    feats = rng.normal(size=(n, 3)).astype(np.float32)
    w = rng.normal(size=(27, 3, 8)).astype(np.float32)

    grid, vf, p2v = voxelize(torch.from_numpy(coords),
                             torch.from_numpy(feats),
                             torch.ones(n, dtype=torch.bool), n)
    plans = build_plans(grid, 3, level_capacities(n, 3))
    h = subm_conv_apply(vf, plans.levels[0].subm_rb, torch.from_numpy(w))
    pts = devoxelize(h, p2v)
    means = segment_mean_by_batch(h, grid.coords[:, 3], 2, grid.valid)

    rgrid, rvf, rp2v = r_voxelize(jnp.asarray(coords), jnp.asarray(feats),
                                  jnp.ones(n, bool), n)
    rplans = r_build_plans(rgrid, 3, r_capacities(n, 3))
    rh = r_subm(rvf, rplans.levels[0].subm_rb, jnp.asarray(w))
    rpts = r_devoxelize(rh, rp2v)
    rmeans = r_segment_mean(rh, rgrid.coords[:, 3], 2, rgrid.valid)

    assert int(grid.num_valid) == int(rgrid.num_valid) > 0
    assert tuple(h.shape) == tuple(rh.shape) == (n, 8)
    np.testing.assert_array_equal(p2v.numpy(), np.asarray(rp2v))
    for lvl, rlvl in zip(plans.levels, rplans.levels):
        np.testing.assert_array_equal(lvl.subm_rb.numpy(),
                                      np.asarray(rlvl.subm_rb))
    for got, want in ((vf, rvf), (h, rh), (pts, rpts), (means, rmeans)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
