"""The device voxelizer and planner of the plans-free branch
(``engine.host_plans: false``) against the reference's on the same
points: ``coords`` (keys, query keys, the stable sort, the search, the
kernel offsets), ``voxelize`` in its three modes (with and without
overflow), ``build_subm_rulebook``, ``downsample_level`` (and its
refusal of filter != stride) and ``build_plans``: integers equal,
features within 1e-6.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdwss_torch.ops import coords as tc
from tdwss_torch.ops import plan as tp

# tdwss.ops and tdwss_torch.ops re-export functions under these modules'
# names
tv = importlib.import_module("tdwss_torch.ops.voxelize")
rc = importlib.import_module("tdwss.ops.coords")
rp = importlib.import_module("tdwss.ops.plan")
rv = importlib.import_module("tdwss.ops.voxelize")

FEAT_TOL = 1e-6


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                      else x)


def _points(n=3000, extent=20, seed=0):
    rng = np.random.default_rng(seed)
    coords = np.concatenate([rng.integers(0, extent, (n, 3)),
                             rng.integers(0, 2, (n, 1))], 1).astype(np.int32)
    valid = rng.random(n) < 0.9
    feats = rng.normal(size=(n, 3)).astype(np.float32)
    return coords, feats, valid


def _grid_equal(ref, port):
    for f in ("coords", "key_hi", "key_lo", "valid", "counts", "num_valid"):
        np.testing.assert_array_equal(_np(getattr(port, f)),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)


def test_coords_match_reference():
    coords, _, valid = _points()
    coords[:7] = [[4095, 0, 1, 0], [0, 4095, 2, 1], [3, 3, 4095, 1],
                  [5, 5, 5, 0], [5, 5, 5, 0], [5, 5, 5, 0], [1, 2, 3, 1]]
    q = coords + np.random.default_rng(1).integers(-2, 3, coords.shape
                                                   ).astype(np.int32)
    q[:, 3] = coords[:, 3]
    jc, jv, jq = jnp.asarray(coords), jnp.asarray(valid), jnp.asarray(q)
    c, v, qq = map(torch.from_numpy, (coords, valid, q))
    for ref, port in ((rc.make_keys(jc, jv), tc.make_keys(c, v)),
                      (rc.make_query_keys(jq, jv),
                       tc.make_query_keys(qq, v))):
        for a, b in zip(ref, port):
            np.testing.assert_array_equal(_np(b), np.asarray(a))
    hi, lo = rc.make_keys(jc, jv)
    idx = jnp.arange(coords.shape[0], dtype=jnp.int32)
    ref_sorted = rc.sort_by_keys(hi, lo, idx, jc[:, 0])
    port_sorted = tc.sort_by_keys(*tc.make_keys(c, v),
                                  torch.arange(coords.shape[0],
                                               dtype=torch.int32), c[:, 0])
    for a, b in zip(ref_sorted, port_sorted):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    qh, ql = rc.make_query_keys(jq, jv)
    np.testing.assert_array_equal(
        _np(tc.lookup_sorted(port_sorted[0], port_sorted[1],
                             *tc.make_query_keys(qq, v))),
        np.asarray(rc.lookup_sorted(ref_sorted[0], ref_sorted[1], qh, ql)))
    for size in (2, 3, 4):
        np.testing.assert_array_equal(tc.kernel_offsets(size),
                                      rc.kernel_offsets(size))


@pytest.mark.parametrize("mode", ["mean", "sum", "first"])
@pytest.mark.parametrize("capacity", [4096, 1000])
def test_voxelize_matches_reference(mode, capacity):
    coords, feats, valid = _points()
    g, f, p = rv.voxelize(jnp.asarray(coords), jnp.asarray(feats),
                          jnp.asarray(valid), capacity, mode=mode)
    tg, tf, tp_ = tv.voxelize(torch.from_numpy(coords),
                              torch.from_numpy(feats),
                              torch.from_numpy(valid), capacity, mode=mode)
    _grid_equal(g, tg)
    assert int(g.num_valid) > 1000          # the small capacity overflows
    np.testing.assert_array_equal(_np(tp_), np.asarray(p))
    np.testing.assert_allclose(_np(tf), np.asarray(f), rtol=0,
                               atol=FEAT_TOL)


def test_rulebooks_and_plans_match_reference():
    coords, feats, valid = _points(extent=40)
    g, _, _ = rv.voxelize(jnp.asarray(coords), jnp.asarray(feats),
                          jnp.asarray(valid), 4096)
    tg, _, _ = tv.voxelize(torch.from_numpy(coords),
                           torch.from_numpy(feats),
                           torch.from_numpy(valid), 4096)
    np.testing.assert_array_equal(_np(tp.build_subm_rulebook(tg)),
                                  np.asarray(rp.build_subm_rulebook(g)))
    ref_down = rp.downsample_level(g, 1024, 2, 2)
    port_down = tp.downsample_level(tg, 1024, 2, 2)
    _grid_equal(ref_down[0], port_down[0])
    for a, b in zip(ref_down[1:], port_down[1:]):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    with pytest.raises(NotImplementedError):
        tp.downsample_level(tg, 1024, 3, 2)
    caps = rp.level_capacities(4096, 4, 2, 256)
    ref_plans = rp.build_plans(g, 4, caps)
    port_plans = tp.build_plans(tg, 4, caps)
    assert port_plans.downsample == ref_plans.downsample
    for a, b in zip(ref_plans.levels, port_plans.levels):
        _grid_equal(a.grid, b.grid)
        for f in ("subm_rb", "parent", "child_offset", "down_rb"):
            if getattr(a, f) is None:
                assert getattr(b, f) is None
            else:
                np.testing.assert_array_equal(_np(getattr(b, f)),
                                              np.asarray(getattr(a, f)),
                                              err_msg=f)
