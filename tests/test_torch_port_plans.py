"""(c) The port's host planner gives the reference's batches byte for byte.

Two small synthetic scenes go through ``val_collate`` and
``attach_host_plans`` in both packages, once through the native C++
planner (each package builds and loads its own copy) and once through the
numpy reference paths.  Every array of the batch and its plans must be
equal, dtype included; the port's one extra plan field, ``spill_order``,
is held by ``tests/test_torch_port_spill.py``.  Both sticky-shape registries are reset first; the
reference plan cache is a train-loader feature and is not involved.
"""

import dataclasses

import numpy as np
import pytest

import tdwss.native as ref_native
from tdwss.config import (Config, EngineConfig, PointcloudDataConfig,
                          PointcloudModelConfig)
from tdwss.data.collate import val_collate as ref_val_collate
from tdwss.data.dataset import val_offsets as ref_val_offsets
from tdwss.data.plans import attach_host_plans as ref_attach
from tdwss.data.synthetic import make_dataset as ref_make_dataset
from tdwss.ops.host_plan import reset_sticky_plans as ref_reset
from tdwss_torch import config as pc
from tdwss_torch import native as port_native
from tdwss_torch.data.collate import val_collate
from tdwss_torch.data.dataset import val_offsets
from tdwss_torch.data.plans import attach_host_plans
from tdwss_torch.data.synthetic import make_dataset
from tdwss_torch.ops.host_plan import reset_sticky_plans


def _cfgs():
    kw = dict(model=dict(name="SparseConvUNet", m=8, full_scale=4096,
                         block_reps=2, residual_blocks=True),
              data=dict(scale=20, val_reps=2, batch_size=2),
              engine=dict(max_points=8192, min_level_capacity=256))
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


def _leaves(obj, prefix=""):
    """(path, value) over every array / scalar leaf of a batch or plan."""
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{prefix}.{f.name}")
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, obj


def _assert_same(ref, port):
    ref_l = dict(_leaves(ref))
    # the port-only spill order of each windowed plan (grouping of the
    # spill entries by owner) has no reference counterpart
    port_l = {k: v for k, v in _leaves(port) if ".spill_order" not in k}
    # val batches carry no boxes
    assert ref_l[".box"] is None
    assert set(ref_l) == set(port_l), set(ref_l) ^ set(port_l)
    for key, rv in ref_l.items():
        pv = port_l[key]
        if rv is None or isinstance(rv, (int, str, tuple)):
            assert rv == pv, key
            continue
        rv, pv = np.asarray(rv), np.asarray(pv)
        assert rv.dtype == pv.dtype, (key, rv.dtype, pv.dtype)
        assert rv.shape == pv.shape, (key, rv.shape, pv.shape)
        assert rv.tobytes() == pv.tobytes(), key


@pytest.mark.parametrize("planner", ["native", "numpy"])
def test_plans_byte_identical(planner, monkeypatch):
    if planner == "native":
        assert ref_native.available() and port_native.available(), (
            port_native.last_error())
    else:
        monkeypatch.setattr(ref_native, "_load", lambda: None)
        monkeypatch.setattr(port_native, "_enabled", False)
    ref_cfg, port_cfg = _cfgs()
    ref_scenes = ref_make_dataset(2, num_points=3000, seed=41,
                                  with_text=False)
    scenes = make_dataset(2, num_points=3000, seed=41, with_text=False)
    ref_off, ref_labels = ref_val_offsets(ref_scenes)
    off, labels = val_offsets(scenes)
    np.testing.assert_array_equal(ref_off, off)
    np.testing.assert_array_equal(ref_labels, labels)
    ref_reset()
    reset_sticky_plans()
    for rep in (1, 2):                      # the registry ratchets on
        seq = np.random.SeedSequence([0, 7777, rep, 0])
        ref_b = ref_attach(ref_val_collate(
            ref_scenes, ref_cfg, np.random.default_rng(seq), ref_off,
            [0, 1], None, num_scenes=2), ref_cfg)
        port_b = attach_host_plans(val_collate(
            scenes, port_cfg, np.random.default_rng(seq), off, [0, 1],
            num_scenes=2), port_cfg)
        assert any(lvl.win is not None for lvl in port_b.plans.levels)
        assert any(lvl.wg_down is not None for lvl in port_b.plans.levels)
        _assert_same(ref_b, port_b)


def test_native_disabled_context():
    with port_native.disabled():
        assert not port_native.available()
    assert port_native.available()
