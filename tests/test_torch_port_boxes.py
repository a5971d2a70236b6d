"""Proposal boxes in the port's train batch, against the reference's.

- ``train_collate`` with ``with_boxes`` at one seed (scenes with more
  proposals than ``max_boxes``, one without any, one with ``center`` and
  ``align``): every array of the batch and of its ``BoxBatch`` equal
  byte for byte, ``concat_boxes()`` and ``transform_tuple()`` equal, and
  no extra draw from ``rng`` (the next draw equal on both sides);
- without ``with_boxes`` the batch carries no box;
- ``PointBatch.to`` (plain and non-blocking) carries the box as tensors,
  and ``concat_boxes`` / ``transform_tuple`` read them back equal;
- ``slim_batch_for_train`` keeps the box, as the reference's does;
- the prefetching train loader, to the CPU device, yields the box of the
  reference loader's batch (plan cache off), array for array;
- ``max_boxes`` is read from a YAML file and defaults to 64.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests._torch_port_common import _cfgs
from tdwss.data import loader as ref_loader
from tdwss.data.collate import train_collate as ref_collate
from tdwss.data.plans import slim_batch_for_train as ref_slim
from tdwss.data.synthetic import make_dataset as ref_make_dataset
from tdwss.ops.host_plan import reset_sticky_plans as ref_reset
from tdwss_torch.config import PointcloudDataConfig, load_config
from tdwss_torch.data import loader
from tdwss_torch.data.collate import train_collate
from tdwss_torch.data.plans import attach_host_plans, slim_batch_for_train
from tdwss_torch.data.synthetic import make_dataset
from tdwss_torch.ops.host_plan import reset_sticky_plans

MAX_BOXES = 4


def _with_boxes(scenes, rng_seed):
    """Scene 0: 6 proposals (over max_boxes), centre and align; scene 1:
    none; scene 2: 2 proposals."""
    rng = np.random.default_rng(rng_seed)
    out = []
    for i, s in enumerate(scenes):
        lo, hi = s.points.min(0), s.points.max(0)
        k = (6, 0, 2)[i % 3]
        boxes = np.concatenate([rng.uniform(lo, hi, (k, 3)),
                                rng.uniform(0.2, 2.0, (k, 3)),
                                rng.uniform(0, 1, (k, 1))], 1)
        kw = dict(boxes=boxes.astype(np.float32) if k else None)
        if i == 0:
            kw.update(center=rng.normal(size=3).astype(np.float32),
                      align=np.eye(4, dtype=np.float32)
                      + rng.normal(scale=0.01, size=(4, 4)).astype(np.float32))
        out.append(dataclasses.replace(s, **kw))
    return out


@pytest.fixture(scope="module")
def setup():
    ref_cfg, cfg = _cfgs("float32")
    ref_cfg = dataclasses.replace(ref_cfg, pointcloud_data=dataclasses.replace(
        ref_cfg.pointcloud_data, batch_size=3, with_boxes=True,
        max_boxes=MAX_BOXES))
    cfg = dataclasses.replace(cfg, pointcloud_data=dataclasses.replace(
        cfg.pointcloud_data, batch_size=3, with_boxes=True,
        max_boxes=MAX_BOXES))
    ref_scenes = _with_boxes(ref_make_dataset(3, num_points=2500, seed=5,
                                              with_text=False), 1)
    scenes = _with_boxes(make_dataset(3, num_points=2500, seed=5,
                                      with_text=False), 1)
    return ref_cfg, cfg, ref_scenes, scenes


def _arrays(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), (np.ndarray, torch.Tensor))}


def _host(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_same_boxes(ref_box, box):
    ref_a, a = _arrays(ref_box), _arrays(box)
    assert set(ref_a) == set(a) == {"boxes", "valid", "align", "center",
                                    "rot_inv", "offset"}
    for k, rv in ref_a.items():
        rv, pv = np.asarray(rv), _host(a[k])
        assert (rv.dtype, rv.shape) == (pv.dtype, pv.shape), k
        assert rv.tobytes() == pv.tobytes(), k
    assert ref_box.concat_boxes().tobytes() == box.concat_boxes().tobytes()
    for rv, pv in zip(ref_box.transform_tuple(), box.transform_tuple()):
        assert np.asarray(rv).tobytes() == np.asarray(pv).tobytes()


def test_train_collate_boxes_equal_the_reference(setup):
    ref_cfg, cfg, ref_scenes, scenes = setup
    ref_rng, rng = np.random.default_rng(3), np.random.default_rng(3)
    ref_b = ref_collate(ref_scenes, ref_cfg, ref_rng)
    b = train_collate(scenes, cfg, rng)
    assert ref_rng.random() == rng.random()          # no extra draw
    for k, rv in _arrays(ref_b).items():
        assert np.asarray(rv).tobytes() == _host(getattr(b, k)).tobytes(), k
    assert_same_boxes(ref_b.box, b.box)
    assert b.box.valid.sum(1).tolist() == [MAX_BOXES, 0, 2]
    assert b.box.concat_boxes().shape == (MAX_BOXES + 2, 7)
    assert not np.array_equal(b.box.align[0], np.eye(4))
    np.testing.assert_array_equal(b.box.align[1], np.eye(4))


def test_no_box_without_with_boxes(setup):
    _, cfg, _, scenes = setup
    off = dataclasses.replace(cfg, pointcloud_data=dataclasses.replace(
        cfg.pointcloud_data, with_boxes=False))
    assert train_collate(scenes, off, np.random.default_rng(0)).box is None


@pytest.mark.parametrize("non_blocking", [False, True])
def test_box_survives_to_and_slim(setup, non_blocking):
    ref_cfg, cfg, ref_scenes, scenes = setup
    ref_b = ref_collate(ref_scenes, ref_cfg, np.random.default_rng(4))
    b = train_collate(scenes, cfg, np.random.default_rng(4))
    moved = b.to("cpu", non_blocking=non_blocking)
    assert isinstance(moved.box.boxes, torch.Tensor)
    assert any(t is moved.box.rot_inv for t in moved.tensors())
    assert_same_boxes(ref_b.box, moved.box)
    planned = attach_host_plans(b, cfg)
    slim = slim_batch_for_train(planned, cfg)
    assert slim.box is planned.box is b.box
    assert ref_slim(ref_b.replace(plans=0), ref_cfg).box is ref_b.box


def test_loader_carries_the_box(setup):
    ref_cfg, cfg, ref_scenes, scenes = setup
    ref_reset()
    ref_bs = list(ref_loader.train_batches(ref_scenes, ref_cfg, 1))
    reset_sticky_plans()
    bs = list(loader.train_batches(scenes, cfg, 1, to_device="cpu"))
    assert len(ref_bs) == len(bs) == 1
    assert isinstance(bs[0].box.boxes, torch.Tensor)
    assert_same_boxes(ref_bs[0].box, bs[0].box)


def test_max_boxes_config(tmp_path):
    assert PointcloudDataConfig().max_boxes == 64
    path = tmp_path / "boxes.yaml"
    path.write_text("training_name: boxes\nmodel_name: MultiLabel\n"
                    "pointcloud_data:\n  with_boxes: true\n  max_boxes: 7\n")
    cfg = load_config(str(path))
    assert cfg.pointcloud_data.with_boxes and cfg.pointcloud_data.max_boxes == 7
