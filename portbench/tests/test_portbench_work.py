"""The frozen work counter against a brute-force neighbour count, and
the same work for one batch whether the program plans on the host or on
the device."""

import itertools

import numpy as np
import pytest
import torch

from portbench.reference import collate
from portbench.reference.check import collate_params
from portbench.reference.model import plan_capacities
from portbench.reference.voxels import build_levels, subm_pairs
from portbench.traffic.generate import generate
from portbench.work import count
from _tiny import tiny_cell, tiny_cells


def _brute(coords):
    """Live (voxel, tap) pairs of a 3x3x3 submanifold conv, by a set."""
    live = {tuple(c) for c in coords.tolist()}
    return sum((x + dx, y + dy, z + dz, b) in live
               for x, y, z, b in live
               for dx, dy, dz in itertools.product((-1, 0, 1), repeat=3))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pairs_match_brute_force(seed):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.integers(0, 12, (600, 3)),
                          rng.integers(0, 2, (600, 1))], axis=1)
    caps = [10**6] * 3
    levels, downs, pv = build_levels(torch.from_numpy(pts), caps)
    c = count.live_counts(torch.from_numpy(pts), caps)
    for lvl, level in enumerate(levels):
        assert c.voxels[lvl] == len({tuple(p) for p in
                                     level.coords.tolist()})
        assert c.pairs[lvl] == _brute(level.coords.numpy())
        tap_pairs = subm_pairs(level)
        for k, (o, i) in enumerate(tap_pairs):
            dx, dy, dz = k // 9 - 1, k // 3 % 3 - 1, k % 3 - 1
            off = torch.tensor([dx, dy, dz, 0])
            assert torch.equal(level.coords[i], level.coords[o] + off)
    assert c.children == [levels[i].size for i in range(2)]
    # points map onto their voxel
    assert torch.equal(levels[0].coords[pv], torch.from_numpy(pts).long())


def test_capacity_drops_the_largest_keys():
    pts = torch.tensor([[i, 0, 0, b] for b in range(2) for i in range(5)])
    levels, _, pv = build_levels(pts, [7, 7])
    assert levels[0].size == 7
    assert (pv >= 0).sum() == 7 and bool((pv[-3:] < 0).all())


def test_work_counts_passes():
    op = count.Op("c", "subm", 0, 32, 64, 27)
    c = count.Counts(voxels=[100], pairs=[900], children=[])
    w = count.op_work(op, c, "bfloat16")
    assert w.flops == 3 * 2 * 900 * 32 * 64
    stem = count.op_work(count.Op("s", "stem", 0, 3, 32, 27), c, "bfloat16")
    assert stem.flops == 2 * 2 * 900 * 3 * 32


@pytest.mark.parametrize("name", tiny_cells())
def test_same_work_with_and_without_host_plans(name):
    """The count from the benchmark's own voxels equals the live entries
    of the program's rulebooks, planned on the host and on the device."""
    from tdwss_torch.config import config_from_dict
    from tdwss_torch.data.collate import train_collate
    from tdwss_torch.data.plans import attach_host_plans
    from tdwss_torch.data.synthetic import Scene
    from tdwss_torch.ops.host_plan import build_subm_rulebook_np
    from tdwss_torch.ops.plan import build_plans
    from tdwss_torch.ops.voxelize import voxelize

    cell = tiny_cell(name)
    cfgd = dict(cell.config["config"], seed=5)
    raw = generate(cell.mix, 5)
    caps = plan_capacities(cfgd)
    b = collate.train_batch(raw, collate_params(cfgd), 5, 1, 0)
    ours = count.live_counts(torch.from_numpy(b.coords), caps)

    cfg = config_from_dict(dict(cfgd, engine=dict(cfgd["engine"],
                                                  slim_device_plans=False)))
    order = np.random.default_rng(np.random.SeedSequence([5, 1])).permutation(
        len(raw))
    sel = [Scene(points=raw[i].points, colors=raw[i].colors,
                 labels=raw[i].labels, name=raw[i].name)
           for i in order[:cfgd["pointcloud_data"]["batch_size"]]]
    batch = train_collate(sel, cfg, np.random.default_rng(
        np.random.SeedSequence([5, 1, 0])))
    host = attach_host_plans(batch, cfg, slim=False).plans
    coords = torch.from_numpy(np.asarray(batch.coords))
    grid, _, _ = voxelize(coords, None, torch.from_numpy(batch.valid),
                          caps[0])
    dev = build_plans(grid, len(caps), caps)
    # the host planner's windowed levels carry no global rulebook: its
    # own rulebook function runs over each level's grid
    host_pairs = [int((build_subm_rulebook_np(lv.grid) >= 0).sum())
                  for lv in host.levels]
    dev_pairs = [int((lv.subm_rb >= 0).sum()) for lv in dev.levels]
    assert host_pairs == dev_pairs == ours.pairs
    for plans in (host, dev):
        assert [int(np.asarray(lv.grid.valid).sum())
                for lv in plans.levels] == ours.voxels
