"""The experimental brick engine: the port's ``build_brick_plan`` and
``brick_subm_conv`` against the reference's on the CPU.

The plans are byte-identical field by field; the conv agrees with the
reference's in f32 (rtol = atol = 1e-5, every row) and in bf16
(max|d| <= 2^-7 max|ref|), with the port's own windowed/rulebook
``subm_conv_apply`` (1e-4 at the valid rows, as the reference's own
test holds its brick conv), and its gradients with ``jax.grad`` of the
reference (f32, rtol = atol = 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdwss.ops.experimental import brick_plan as ref_bp
from tdwss.ops.experimental.brick_conv import \
    brick_subm_conv as ref_brick_subm_conv
from tdwss.ops.host_plan import voxelize_np as ref_voxelize_np
from tdwss_torch import config as pc
from tdwss_torch.data.collate import train_collate
from tdwss_torch.data.synthetic import make_dataset
from tdwss_torch.ops.experimental import brick_plan as bp
from tdwss_torch.ops.experimental.brick_conv import (brick_subm_conv,
                                                     plan_to)
from tdwss_torch.ops.host_plan import build_subm_rulebook_np, voxelize_np
from tdwss_torch.ops.sparse_conv import subm_conv_apply

FIELDS = ("cell2vox", "vox2cell", "neighbors", "brick_coords",
          "brick_valid", "num_bricks", "size")


def _random_coords(rng, n=2000, size=48, batches=3, invalid_frac=0.1):
    """``tests/test_host_plan.py``'s recipe: three scenes in a cube of
    ``size`` cells, about ``invalid_frac`` of the points invalid."""
    coords = np.concatenate(
        [rng.integers(0, size, (n, 3)), rng.integers(0, batches, (n, 1))],
        axis=1).astype(np.int32)
    valid = rng.random(n) > invalid_frac
    return coords, valid


def _synthetic_coords():
    """The points of a 2-scene synthetic training batch (scale 20)."""
    cfg = pc.Config(pointcloud_data=pc.PointcloudDataConfig(scale=20),
                    pointcloud_model=pc.PointcloudModelConfig(
                        name="SparseConvUNet", m=8, full_scale=4096),
                    engine=pc.EngineConfig(max_points=8192))
    scenes = make_dataset(2, num_points=3000, seed=103, with_text=False)
    batch = train_collate(scenes, cfg, np.random.default_rng(0))
    return np.asarray(batch.coords), np.asarray(batch.valid)


def _grids(which):
    """(port grid, reference grid) of the same points."""
    if which == "random":
        coords, valid = _random_coords(np.random.default_rng(0))
    else:
        coords, valid = _synthetic_coords()
    cap = coords.shape[0]
    grid, _, _ = voxelize_np(coords, None, valid, cap)
    ref_grid, _, _ = ref_voxelize_np(coords, None, valid, cap)
    return grid, ref_grid


def _assert_same_plan(plan, ref):
    for f in FIELDS:
        a, b = getattr(plan, f), getattr(ref, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert a.tobytes() == b.tobytes(), f
        else:
            assert type(a) is type(b) and a == b, f


@pytest.fixture
def clear_registries():
    bp.reset_brick_caps()
    ref_bp._BRICK_REGISTRY.clear()
    yield
    bp.reset_brick_caps()
    ref_bp._BRICK_REGISTRY.clear()


def test_neighbor_offsets_are_the_reference_array():
    assert bp._NEIGHBOR_OFFSETS.dtype == ref_bp._NEIGHBOR_OFFSETS.dtype
    assert (bp._NEIGHBOR_OFFSETS.tobytes()
            == ref_bp._NEIGHBOR_OFFSETS.tobytes())
    # x slowest: the first nine offsets have dx = -1
    assert (bp._NEIGHBOR_OFFSETS[:9, 0] == -1).all()


@pytest.mark.parametrize("which", ["random", "synthetic"])
@pytest.mark.parametrize("mode", ["explicit", "sticky", "too_small"])
def test_brick_plan_byte_identical(which, mode, clear_registries):
    grid, ref_grid = _grids(which)
    if mode == "sticky":
        plans = [bp.build_brick_plan(grid)]
        refs = [ref_bp.build_brick_plan(ref_grid)]
        # a second level of the same V with fewer bricks keeps the cap
        keep = np.asarray(grid.coords)[:, 3] == 0
        grid2 = grid.replace(valid=np.asarray(grid.valid) & keep)
        ref2 = ref_grid.replace(valid=np.asarray(ref_grid.valid) & keep)
        plans.append(bp.build_brick_plan(grid2))
        refs.append(ref_bp.build_brick_plan(ref2))
        assert plans[1].num_bricks < plans[0].num_bricks
        assert plans[1].cell2vox.shape == plans[0].cell2vox.shape
        assert bp._BRICK_REGISTRY == ref_bp._BRICK_REGISTRY
    else:
        probe = ref_bp.build_brick_plan(ref_grid, brick_cap=1 << 20)
        cap = (probe.num_bricks + 100 if mode == "explicit"
               else probe.num_bricks // 2)
        plans = [bp.build_brick_plan(grid, brick_cap=cap)]
        refs = [ref_bp.build_brick_plan(ref_grid, brick_cap=cap)]
    for plan, ref in zip(plans, refs):
        _assert_same_plan(plan, ref)
    s3 = plans[0].size ** 3
    valid = np.asarray(grid.valid)
    dropped = valid & (plans[0].vox2cell == plans[0].cell2vox.shape[0] * s3)
    assert dropped.any() == (mode == "too_small")


def _conv_case(brick_cap, cin=6, cout=5, n=1200):
    """The reference test's conv case (``tests/test_host_plan.py``): a
    random grid with invalid rows, seeded features and weights."""
    rng = np.random.default_rng(3)
    coords, valid = _random_coords(rng, n=n, size=40, invalid_frac=0.08)
    grid, _, _ = voxelize_np(coords, None, valid, n)
    ref_grid, _, _ = ref_voxelize_np(coords, None, valid, n)
    plan = bp.build_brick_plan(grid, brick_cap=brick_cap)
    ref_plan = ref_bp.build_brick_plan(ref_grid, brick_cap=brick_cap)
    ref_plan = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x,
        ref_plan)
    vf = rng.normal(size=(n, cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)
         ).astype(np.float32)
    return grid, plan, ref_plan, vf, w


# a cap that keeps every brick, and one that drops some voxels
CAPS = [2048, 160]


@pytest.mark.parametrize("brick_cap", CAPS)
def test_brick_conv_f32_equals_reference(brick_cap):
    grid, plan, ref_plan, vf, w = _conv_case(brick_cap)
    out = brick_subm_conv(torch.from_numpy(vf), plan, torch.from_numpy(w))
    ref = np.asarray(ref_brick_subm_conv(jnp.asarray(vf), ref_plan,
                                         jnp.asarray(w)))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    # dropped and invalid rows are zero
    valid = np.asarray(grid.valid)
    absent = plan.vox2cell == plan.cell2vox.size
    assert (absent & valid).any() == (brick_cap == 160)
    assert (~valid).any() and absent[~valid].all()
    assert not out.numpy()[absent].any()
    # the plan on the device form gives the same values
    out2 = brick_subm_conv(torch.from_numpy(vf), plan_to(plan, "cpu"),
                           torch.from_numpy(w))
    assert torch.equal(out, out2)


def test_brick_conv_equals_port_subm_conv():
    grid, plan, _, vf, w = _conv_case(2048)
    rb = torch.from_numpy(build_subm_rulebook_np(grid, 3))
    out = brick_subm_conv(torch.from_numpy(vf), plan, torch.from_numpy(w))
    ref = subm_conv_apply(torch.from_numpy(vf), rb, torch.from_numpy(w))
    rows = np.asarray(grid.valid)
    np.testing.assert_allclose(out.numpy()[rows], ref.numpy()[rows],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("brick_cap", CAPS)
def test_brick_conv_bf16_equals_reference(brick_cap):
    _, plan, ref_plan, vf, w = _conv_case(brick_cap, cin=16, cout=16)
    x = torch.from_numpy(vf).to(torch.bfloat16)
    out = brick_subm_conv(x, plan, torch.from_numpy(w))
    ref = np.asarray(ref_brick_subm_conv(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), ref_plan,
        jnp.asarray(w)).astype(jnp.float32))
    assert out.dtype == torch.bfloat16
    d = np.abs(out.float().numpy() - ref).max()
    assert d <= 2.0 ** -7 * np.abs(ref).max()


@pytest.mark.parametrize("brick_cap", CAPS)
def test_brick_conv_gradients_equal_jax_grad(brick_cap):
    _, plan, ref_plan, vf, w = _conv_case(brick_cap)
    g = np.random.default_rng(5).normal(
        size=(vf.shape[0], w.shape[2])).astype(np.float32)

    def ref_loss(x, wt):
        return jnp.sum(ref_brick_subm_conv(x, ref_plan, wt) * jnp.asarray(g))

    rdx, rdw = jax.grad(ref_loss, argnums=(0, 1))(jnp.asarray(vf),
                                                  jnp.asarray(w))
    x = torch.from_numpy(vf).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    brick_subm_conv(x, plan, wt).backward(torch.from_numpy(g))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(rdx), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(rdw), rtol=1e-4,
                               atol=1e-4)
    assert np.abs(np.asarray(rdx)).max() > 0
