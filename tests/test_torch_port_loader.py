"""The port's train loader against the reference's.

- ``train_batches`` over epochs 1 and 2 (reference with
  ``plan_cache_batches=0`` and one collate worker on both sides): every
  array and every plan leaf equal byte for byte (the port's spill order,
  which the reference lacks, aside), and ``CollateStats`` equal, on
  scenes that overflow ``max_points``;
- after ``warm_plan_shapes``, 4 collate workers give the same batches
  as 1, byte for byte;
- an exception in a collate worker or in the prefetch thread is raised
  in the consumer, after the batches before it;
- drop_last and ``steps_per_epoch``; prefetching onto the CPU device
  yields tensors.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests._torch_port_common import _cfgs
from tdwss.data import loader as ref_loader
from tdwss.data.collate import CollateStats as RefStats
from tdwss.data.synthetic import make_dataset as ref_make_dataset
from tdwss.ops.host_plan import reset_sticky_plans as ref_reset
from tdwss_torch.data import loader
from tdwss_torch.data.collate import CollateStats
from tdwss_torch.data.synthetic import make_dataset
from tdwss_torch.ops.host_plan import reset_sticky_plans

NUM_SCENES, POINTS = 5, 5000          # 2 x 5,000 points > max_points 8192


def _leaves(obj, prefix=""):
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{prefix}.{f.name}")
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, obj


def _value(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return v


def assert_same_batch(ref, port, ref_only=("box",)):
    """Every leaf equal; against the reference (``ref_only`` given), the
    port's spill order, which the reference lacks, aside."""
    ref_l = dict(_leaves(ref))
    port_l = {k: v for k, v in _leaves(port)
              if not (ref_only and ".spill_order" in k)}
    for key in ref_only:
        assert ref_l.pop(f".{key}", None) is None
    assert set(ref_l) == set(port_l), set(ref_l) ^ set(port_l)
    for key, rv in ref_l.items():
        pv = _value(port_l[key])
        if rv is None or isinstance(rv, (int, str, tuple)):
            assert rv == pv, key
            continue
        rv, pv = np.asarray(rv), np.asarray(pv)
        assert (rv.dtype, rv.shape) == (pv.dtype, pv.shape), key
        assert rv.tobytes() == pv.tobytes(), key


def _configs(workers=1):
    ref_cfg, port_cfg = _cfgs("float32")
    port_cfg.engine.collate_workers = workers
    return ref_cfg, port_cfg


@pytest.fixture(scope="module")
def scenes():
    return (ref_make_dataset(NUM_SCENES, num_points=POINTS, seed=21,
                             with_text=False),
            make_dataset(NUM_SCENES, num_points=POINTS, seed=21,
                         with_text=False))


def test_train_batches_match_reference(scenes):
    ref_scenes, port_scenes = scenes
    ref_cfg, port_cfg = _configs()
    assert ref_cfg.engine.plan_cache_batches == 0
    assert ref_cfg.engine.collate_workers == 1
    ref_reset()
    reset_sticky_plans()
    n = 0
    for epoch in (1, 2):
        ref_stats, stats = RefStats(), CollateStats()
        ref_bs = list(ref_loader.train_batches(ref_scenes, ref_cfg, epoch,
                                               ref_stats))
        port_bs = list(loader.train_batches(port_scenes, port_cfg, epoch,
                                            stats))
        assert len(ref_bs) == len(port_bs) == NUM_SCENES // 2
        for rb, pb in zip(ref_bs, port_bs):
            assert pb.plans is not None
            assert_same_batch(rb, pb)
            n += 1
        assert (stats.total_points, stats.dropped_points) == (
            ref_stats.total_points, ref_stats.dropped_points)
        assert stats.dropped_points > 0
    assert n == 4


def test_four_workers_equal_one_after_warm_up(scenes):
    _, port_scenes = scenes
    _, one = _configs(1)
    _, four = _configs(4)
    reset_sticky_plans()
    loader.warm_plan_shapes(port_scenes, one, epochs=(1, 2))
    for epoch in (1, 2):
        s1, s4 = CollateStats(), CollateStats()
        a = list(loader.train_batches(port_scenes, one, epoch, s1))
        b = list(loader.train_batches(port_scenes, four, epoch, s4))
        assert len(a) == len(b) == NUM_SCENES // 2
        for x, y in zip(a, b):
            assert_same_batch(x, y, ref_only=())
        assert (s1.total_points, s1.dropped_points) == (
            s4.total_points, s4.dropped_points)


@pytest.mark.parametrize("workers", [1, 4])
def test_worker_exception_reraises(scenes, workers, monkeypatch):
    _, port_scenes = scenes
    _, cfg = _configs(workers)
    cfg.pointcloud_data.batch_size = 1
    calls = {"n": 0}
    real = loader.train_collate

    def failing(sel, *a, **kw):
        calls["n"] += 1
        if sel[0] is port_scenes[2]:
            raise RuntimeError("collate failed")
        return real(sel, *a, **kw)

    monkeypatch.setattr(loader, "train_collate", failing)
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 1]))
    position = int(np.nonzero(rng.permutation(NUM_SCENES) == 2)[0][0])
    got = []
    with pytest.raises(RuntimeError, match="collate failed"):
        for batch in loader.train_batches(port_scenes, cfg, 1):
            got.append(batch)
    assert len(got) == position


def test_prefetch_thread_exception_reraises():
    def gen():
        yield 1
        raise ValueError("plan failed")

    it = loader._prefetch(gen())
    assert next(it) == 1
    with pytest.raises(ValueError, match="plan failed"):
        next(it)


def test_drop_last_and_steps_per_epoch(scenes):
    _, port_scenes = scenes
    _, cfg = _configs()
    cfg.pointcloud_data.batch_size = 2
    assert loader.steps_per_epoch(NUM_SCENES, 2) == 2
    assert loader.steps_per_epoch(1, 2) == 0
    batches = list(loader.train_batches(port_scenes, cfg, 3,
                                        to_device="cpu"))
    assert len(batches) == 2                  # the fifth scene is dropped
    for b in batches:
        assert isinstance(b.valid, torch.Tensor)
        assert b.num_scenes == 2
