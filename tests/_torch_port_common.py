"""Shared set-up of the slice tests (test_torch_port_*.py): the
reference and port configurations, one planned val batch in each package,
seeded flax variables for MultiLabel over SparseConvUNet, reference plans
as port plan objects, and a call counter for the conv routes' kernel
entry points; and each test process's thread cap."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from threadpoolctl import threadpool_limits

from tdwss.config import (Config, EngineConfig, PointcloudDataConfig,
                          PointcloudModelConfig)
from tdwss.data.collate import val_collate as ref_val_collate
from tdwss.data.dataset import val_offsets as ref_val_offsets
from tdwss.data.plans import attach_host_plans as ref_attach
from tdwss.data.synthetic import make_dataset as ref_make_dataset
from tdwss.engine.steps import make_eval_step
from tdwss.models import build_model as ref_build_model
from tdwss.ops.host_plan import reset_sticky_plans as ref_reset
from tdwss.ops.sparse_conv import force_einsum
from tdwss_torch import config as pc
from tdwss_torch.convert import flax_to_state_dict
from tdwss_torch.data.collate import val_collate
from tdwss_torch.data.dataset import val_offsets
from tdwss_torch.data.plans import attach_host_plans
from tdwss_torch.data.synthetic import make_dataset
from tdwss_torch.models.meta_arch import build_model
from tdwss_torch.ops import sparse_conv as port_sc
from tdwss_torch.ops.host_plan import reset_sticky_plans
from tdwss_torch.ops.plan import Windowed27, with_spill_order

F32_TOL = dict(rtol=1e-4, atol=1e-4)


def _cap_threads():
    """Each test process's share of the host's cores, max(1, cores //
    workers) with ``workers`` the xdist worker count (1 outside xdist):
    torch's intra-op threads and numpy's BLAS pool now, and
    ``OMP_NUM_THREADS`` for the processes it starts.  Every xdist worker
    collects this module before its first test.  With a thread per core
    in every worker, the workers' pools outnumber the cores several times
    over, and the suite's seconds measure waiting for a core rather than
    work."""
    cores = len(os.sched_getaffinity(0))
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = max(1, cores // workers)
    torch.set_num_threads(n)
    threadpool_limits(n)
    os.environ["OMP_NUM_THREADS"] = str(n)


_cap_threads()


def _cfgs(dtype):
    kw = dict(model=dict(name="SparseConvUNet", m=8, full_scale=4096,
                         block_reps=2, residual_blocks=True),
              data=dict(scale=20, val_reps=2, batch_size=2),
              engine=dict(max_points=8192, min_level_capacity=256,
                          compute_dtype=dtype))
    ref = Config(model_name="MultiLabel",
                 pointcloud_data=PointcloudDataConfig(**kw["data"]),
                 pointcloud_model=PointcloudModelConfig(**kw["model"]),
                 engine=EngineConfig(**kw["engine"], plan_cache_batches=0,
                                     collate_workers=1))
    port = pc.Config(model_name="MultiLabel",
                     pointcloud_data=pc.PointcloudDataConfig(**kw["data"]),
                     pointcloud_model=pc.PointcloudModelConfig(**kw["model"]),
                     engine=pc.EngineConfig(**kw["engine"]))
    return ref, port


def _random_variables(tree, rng):
    """Seeded numpy values for every flax variable of ``tree`` (shapes
    from ``jax.eval_shape``): He-normal kernels, and batch-norm scale,
    bias and running statistics away from their trivial init values."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _random_variables(value, rng)
            continue
        shape = value.shape
        if key == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            arr = rng.normal(size=shape) * (2.0 / fan_in) ** 0.5
        elif key in ("scale", "var"):
            arr = rng.uniform(0.6, 1.4, shape)
        else:                                   # bias, mean
            arr = rng.normal(scale=0.2, size=shape)
        out[key] = np.asarray(arr, np.float32)
    return out


def make_setup():
    ref_cfg, port_cfg = _cfgs("float32")
    ref_scenes = ref_make_dataset(2, num_points=3000, seed=103,
                                  with_text=False)
    scenes = make_dataset(2, num_points=3000, seed=103, with_text=False)
    seq = np.random.SeedSequence([0, 7777, 1, 0])
    ref_reset()
    ref_b = ref_attach(ref_val_collate(
        ref_scenes, ref_cfg, np.random.default_rng(seq),
        ref_val_offsets(ref_scenes)[0], [0, 1], None, num_scenes=2), ref_cfg)
    reset_sticky_plans()
    port_b = attach_host_plans(val_collate(
        scenes, port_cfg, np.random.default_rng(seq), val_offsets(scenes)[0],
        [0, 1], num_scenes=2), port_cfg)
    ref_bj = jax.tree_util.tree_map(jnp.asarray, ref_b)
    model = ref_build_model(ref_cfg)
    with force_einsum():
        shapes = jax.eval_shape(
            lambda r, b: model.init(r, b, istrain=False),
            jax.random.PRNGKey(0), ref_bj)
    rng = np.random.default_rng(0)
    params = _random_variables(shapes["params"], rng)
    stats = _random_variables(shapes["batch_stats"], rng)
    return dict(ref_b=ref_bj, port_b=port_b.to("cpu"), params=params,
                stats=stats)


def _forward(setup, dtype):
    ref_cfg, port_cfg = _cfgs(dtype)
    ref_model = ref_build_model(ref_cfg)
    ref = jax.jit(make_eval_step(ref_model))(setup["params"], setup["stats"],
                                            setup["ref_b"])
    port = build_model(port_cfg, device="cpu")
    port.load_state_dict(flax_to_state_dict(setup["params"], setup["stats"]))
    out = port(setup["port_b"])
    return np.asarray(ref, np.float32), out.detach().numpy()




def port_plan_of(ref_obj, cls):
    """A reference plan dataclass as the port's ``cls``, on the CPU (with
    the port-only spill order built as the host planner builds it)."""
    return with_spill_order(cls(**{f.name: getattr(ref_obj, f.name)
                                   for f in dataclasses.fields(cls)
                                   if hasattr(ref_obj, f.name)})).to("cpu")


def tiers_only(ref_obj, **tiers):
    """The reference plan ``ref_obj`` as a port ``Windowed27`` that keeps
    only the given spill tiers (the others empty), its spill order built
    again."""
    keep = dict(res_ovf=np.zeros((0, 3), np.int32), res_tile=None,
                res_hent=None, res_htile=None, res_tent=None, res_ttap=None,
                res_tperm=None)
    keep.update(tiers)
    pw = port_plan_of(ref_obj, Windowed27)
    return with_spill_order(pw.replace(spill_order=None, **keep))


def count_route_calls(monkeypatch, names):
    """Wrap the named kernel entry points of the port's conv routes so
    each call is counted (on the CPU the wrappers count no launches)."""
    calls = {name: 0 for name in names}
    for name in names:
        fn = getattr(port_sc, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(port_sc, name, counted)
    return calls
