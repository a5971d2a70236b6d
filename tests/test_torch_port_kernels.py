"""Port kernels K1/K4 and the windowed conv routes against the reference.

(a) The plain versions of K1 (``windowed_matmul_sub``) and K4
    (``windowed_matmul``) against the Pallas kernels in interpret mode, on
    the inputs ``tests/test_sparse_conv.py`` builds (sentinel locals, the
    27-tap form at nwin 9 and 3, the cross-domain WindowedGather form).
    float32, rtol = atol = 1e-5: the same f32 products summed in another
    order.
(b) The spill tiers and ``subm_conv_apply`` / ``wg_conv_apply`` /
    ``wg_unpool_apply`` against the reference on the CPU (Pallas off, its
    einsum route) for the same host-built plans.  The spill tiers: K8's
    plain version (``_spill_add``) on a plan that keeps the heavy tier,
    the compact list or a tile tier alone, then all of them, against the
    reference's ``_res_heavy_apply``, ``_res_ovf_apply``,
    ``_res_tile_apply`` and ``_res_all_apply``.  float32, rtol = atol =
    1e-4: the reference's spill tiers sum through one-hot matmuls and
    prefix sums, K8 each owner's entries in entry order, so the summation
    order differs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_common import tiers_only
from tdwss.ops import sparse_conv as ref_sc
from tdwss.ops.host_plan import (build_plans_np, build_windowed_gather,
                                 build_windowed_subm27, reset_sticky_plans,
                                 voxelize_np)
from tdwss.ops.pallas_subm import (pad_w9, windowed_matmul,
                                   windowed_matmul_sub)
from tdwss_torch.ops import plan as port_plan
from tdwss_torch.ops import sparse_conv as port_sc
from tdwss_torch.ops import windowed as port_win

TOL = dict(rtol=1e-5, atol=1e-5)
CONV_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.mark.parametrize("nwin", [9, 3])
def test_k4_plain_matches_pallas_w27(nwin):
    rng = np.random.default_rng(11)
    v, tile, window, c, cout = 64, 16, 24, 12, 8
    tiles = v // tile
    feats = rng.normal(size=(v, c)).astype(np.float32)
    rb_local = rng.integers(0, window + 1, size=(v, 27)).astype(np.int32)
    w = rng.normal(size=(27, c, cout)).astype(np.float32)
    starts = (rng.integers(0, (v - window) // 8 + 1, size=(tiles * nwin,))
              * 8).astype(np.int32)
    ref = windowed_matmul(jnp.asarray(feats), jnp.asarray(starts),
                          jnp.asarray(rb_local.T), pad_w9(jnp.asarray(w)),
                          window=window, tile=tile, interpret=True)
    out = port_win.windowed_matmul(_t(feats), _t(starts), _t(rb_local.T),
                                   _t(w), window=window, tile=tile)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # the transposed view of a (V, K) array is accepted as well
    out_t = port_win.windowed_matmul(_t(feats), _t(starts),
                                     _t(rb_local).t(), _t(w),
                                     window=window, tile=tile)
    np.testing.assert_array_equal(out_t.numpy(), out.numpy())


def test_k4_plain_matches_pallas_cross_domain():
    rng = np.random.default_rng(12)
    v_src, v_out, tile, window, c, cout, k = 64, 32, 8, 24, 12, 8, 8
    tiles = v_out // tile
    src = rng.normal(size=(v_src, c)).astype(np.float32)
    starts = (rng.integers(0, (v_src - window) // 8 + 1, size=(tiles,))
              * 8).astype(np.int32)
    rb_local = rng.integers(0, window + 1, size=(v_out, k)).astype(np.int32)
    w = rng.normal(size=(k, c, cout)).astype(np.float32)
    ref = windowed_matmul(jnp.asarray(src), jnp.asarray(starts),
                          jnp.asarray(rb_local.T), pad_w9(jnp.asarray(w)),
                          window=window, tile=tile, interpret=True)
    out = port_win.windowed_matmul(_t(src), _t(starts), _t(rb_local.T),
                                   _t(w), window=window, tile=tile)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("form", ["w27", "cross_domain"])
def test_k1_plain_matches_pallas(form):
    rng = np.random.default_rng(13)
    if form == "w27":
        v_src = v_out = 128
        tile, window, sub, swk, c, cout, k, nwin = 32, 48, 8, 16, 12, 8, 27, 9
    else:
        v_src, v_out = 128, 64
        tile, window, sub, swk, c, cout, k, nwin = 16, 48, 8, 16, 12, 8, 8, 2
    tiles = v_out // tile
    nsub = tile // sub
    src = rng.normal(size=(v_src, c)).astype(np.float32)
    starts = (rng.integers(0, (v_src - window) // 8 + 1,
                           size=(tiles, nwin)) * 8).astype(np.int32)
    sub_off = (rng.integers(0, (window - swk) // 8 + 1,
                            size=(tiles * nsub, nwin)) * 8).astype(np.int32)
    rb_sub = rng.integers(0, swk + 1, size=(v_out, k)).astype(np.int32)
    w = rng.normal(size=(k, c, cout)).astype(np.float32)
    ref = windowed_matmul_sub(
        jnp.asarray(src), jnp.asarray(starts.reshape(-1)),
        jnp.asarray(sub_off.reshape(-1)), jnp.asarray(rb_sub.T),
        pad_w9(jnp.asarray(w)), window=window, tile=tile, sub=sub,
        subwin=swk, interpret=True)
    out = port_win.windowed_matmul_sub(
        _t(src), _t(starts.reshape(-1)), _t(sub_off.reshape(-1)),
        _t(rb_sub.T), _t(w), window=window, tile=tile, sub=sub, subwin=swk)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_kernel_wrappers_validate_arguments():
    x = torch.zeros(64, 4)
    starts = torch.zeros(4 * 9, dtype=torch.int32)
    rb = torch.zeros(27, 64, dtype=torch.int32)
    w = torch.zeros(27, 4, 8)
    with pytest.raises(ValueError):                      # tile must divide
        port_win.windowed_matmul(x, starts, rb, w, window=24, tile=24)
    with pytest.raises(ValueError):                      # w's C mismatch
        port_win.windowed_matmul(x, starts, rb, torch.zeros(27, 5, 8),
                                 window=24, tile=16)
    with pytest.raises(TypeError):                       # int32 locals
        port_win.windowed_matmul(x, starts, rb.long(), w, window=24,
                                 tile=16)


# --------------------------------------------------------------------------
# (b) spill tiers and conv routes over host-built plans
# --------------------------------------------------------------------------


def _scene(seed, n=4096, size=20, batches=2):
    rng = np.random.default_rng(seed)
    coords = np.concatenate(
        [rng.integers(0, size, (n, 3)), rng.integers(0, batches, (n, 1))],
        axis=1).astype(np.int32)
    valid = rng.random(n) > 0.05
    return coords, valid


def _port(ref_obj, cls):
    # the port-only spill order is built as the host planner builds it
    kw = {f.name: getattr(ref_obj, f.name) for f in dataclasses.fields(cls)
          if hasattr(ref_obj, f.name)}
    return port_plan.with_spill_order(cls(**kw)).to("cpu")


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def plans():
    """Reference host plans at two geometries of the 27-tap windows
    (sub form, and flat with a narrow window so spills land in every
    tier) plus the cross-level windowed gathers of level 0."""
    reset_sticky_plans()
    coords, valid = _scene(3)
    n = coords.shape[0]
    grid, _, _ = voxelize_np(coords, None, valid, n)
    caps = (n, n // 2)
    full = build_plans_np(grid, 2, caps, fused=False)
    rb = np.asarray(full.levels[0].subm_rb)
    win_sub = build_windowed_subm27(rb, grid, tile=512, window=640, sub=128,
                                    subwin=224)
    win_flat = build_windowed_subm27(rb, grid, tile=512, window=96)
    lvl = full.levels[0]
    return dict(rb=rb, v=n, vc=caps[1], win_sub=win_sub, win_flat=win_flat,
                wg_down=lvl.wg_down, wg_up=lvl.wg_up,
                wg_down_flat=build_windowed_gather(
                    np.asarray(lvl.down_rb), v_src=n, tile=256, group_mod=2,
                    window=128),
                wg_up_flat=build_windowed_gather(
                    _rb_up(full), v_src=caps[1], tile=512, window=128))


def _rb_up(full):
    from tdwss.ops.host_plan import parent_rulebook

    lvl = full.levels[0]
    vc = lvl.down_rb.shape[0]
    return parent_rulebook(np.asarray(lvl.parent), np.asarray(lvl.child_offset),
                           vc, 8)


def test_plans_cover_every_spill_tier(plans):
    v = plans["v"]
    assert plans["win_sub"].sub and not plans["win_flat"].sub
    spills = plans["win_flat"].res_hent[:, 0] < v
    assert spills.sum() > 0
    assert plans["wg_down"] is not None and plans["wg_down_flat"].sub == 0


@pytest.mark.parametrize("key", ["win_sub", "win_flat"])
def test_subm_conv_apply_matches_reference(plans, key):
    rng = np.random.default_rng(21)
    v = plans["v"]
    feats = rng.normal(size=(v, 6)).astype(np.float32)
    w = rng.normal(size=(27, 6, 5)).astype(np.float32)
    win = plans[key]
    ref = ref_sc.subm_conv_apply(jnp.asarray(feats), jnp.asarray(plans["rb"]),
                                 jnp.asarray(w), _jnp(win))
    plain = ref_sc.subm_conv_apply(jnp.asarray(feats),
                                   jnp.asarray(plans["rb"]), jnp.asarray(w))
    out = port_sc.subm_conv_apply(_t(feats), _t(plans["rb"]), _t(w),
                                  _port(win, port_plan.Windowed27))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **CONV_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(plain), **CONV_TOL)
    # the port's rulebook route is the same function
    out_rb = port_sc.subm_conv_apply(_t(feats), _t(plans["rb"]), _t(w))
    np.testing.assert_allclose(out_rb.numpy(), np.asarray(plain), **CONV_TOL)


@pytest.mark.parametrize("flat", [False, True])
def test_wg_conv_and_unpool_match_reference(plans, flat):
    rng = np.random.default_rng(22)
    v, vc = plans["v"], plans["vc"]
    down = plans["wg_down_flat" if flat else "wg_down"]
    up = plans["wg_up_flat" if flat else "wg_up"]
    fine = rng.normal(size=(v, 6)).astype(np.float32)
    coarse = rng.normal(size=(vc, 7)).astype(np.float32)
    w_dn = rng.normal(size=(8, 6, 7)).astype(np.float32)
    w_up = rng.normal(size=(8, 7, 6)).astype(np.float32)
    pd, pu = (_port(down, port_plan.WindowedGather),
              _port(up, port_plan.WindowedGather))
    cases = [
        (ref_sc.wg_conv_apply(jnp.asarray(fine), jnp.asarray(w_dn),
                              _jnp(down), _jnp(up)),
         port_sc.wg_conv_apply(_t(fine), _t(w_dn), pd, pu)),
        (ref_sc.wg_conv_apply(jnp.asarray(coarse), jnp.asarray(w_up),
                              _jnp(up), _jnp(down)),
         port_sc.wg_conv_apply(_t(coarse), _t(w_up), pu, pd)),
        (ref_sc.wg_unpool_apply(jnp.asarray(coarse), _jnp(up), _jnp(down)),
         port_sc.wg_unpool_apply(_t(coarse), pu, pd)),
    ]
    for ref, out in cases:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **CONV_TOL)


def test_spill_tiers_match_reference(plans):
    """K8's plain version (``_spill_add``) on a plan that keeps one tier,
    then all of them, against the reference's function of that tier on
    the same spill arrays."""
    rng = np.random.default_rng(23)
    win = plans["win_flat"]
    v = plans["v"]
    c, cout = 6, 5
    feats = rng.normal(size=(v, c)).astype(np.float32)
    w2d = rng.normal(size=(27 * c, cout)).astype(np.float32)
    fj, wj, ft = jnp.asarray(feats), jnp.asarray(w2d), _t(feats)
    w3 = _t(w2d).reshape(27, c, cout)

    def spill_add(pw):
        return port_sc._spill_add(ft, pw, w3, torch.zeros((v, cout)))

    assert (win.res_hent[:, 0] < v).sum() > 0
    # heavy tier, its spill order read from the owner-chunked rows and
    # from the tap-chunked companion
    ref = ref_sc._res_heavy_apply(fj, jnp.asarray(win.res_hent),
                                  jnp.asarray(win.res_htile), wj, cout, v,
                                  v // 512, jnp.asarray(win.res_tent),
                                  jnp.asarray(win.res_ttap),
                                  jnp.asarray(win.res_tperm))
    heavy = dict(res_tent=win.res_tent, res_ttap=win.res_ttap,
                 res_tperm=win.res_tperm)
    for tiers in (dict(heavy, res_hent=win.res_hent,
                       res_htile=win.res_htile), heavy):
        out = spill_add(tiers_only(win, **tiers))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **CONV_TOL)
    # compact overflow list: the whole spill set in one v-sorted list
    ent = win.res_hent[win.res_hent[:, 0] < v]
    ent = ent[np.argsort(ent[:, 0], kind="stable")]
    owners, counts = np.unique(ent[:, 0], return_counts=True)
    ref = ref_sc._res_ovf_apply(fj, jnp.asarray(ent), jnp.asarray(owners),
                                jnp.asarray(counts), wj, cout)
    out = spill_add(tiers_only(win, res_ovf=ent, ovf_v=owners,
                                ovf_count=counts))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **CONV_TOL)
    # tile-grouped tier (T2, R, 3) [local, tap, src], pad local == 512
    r = 8
    tiles = v // 512
    res_tile = np.zeros((tiles, r, 3), np.int32)
    res_tile[..., 0] = 512
    res_tile[..., 2] = v
    for t in range(tiles):
        rows = ent[(ent[:, 0] // 512) == t][:r]
        res_tile[t, :len(rows), 0] = rows[:, 0] % 512
        res_tile[t, :len(rows), 1:] = rows[:, 1:]
    ref = ref_sc._res_tile_apply(fj, jnp.asarray(res_tile), wj, cout, v)
    out = spill_add(tiers_only(win, res_tile=res_tile))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **CONV_TOL)
    # all tiers together
    rtile_ref = ref_sc._pack_rtile(_jnp(win))
    ref = ref_sc._res_all_apply(fj, rtile_ref, jnp.asarray(win.res_ovf),
                                jnp.asarray(win.ovf_v),
                                jnp.asarray(win.ovf_count), wj, cout)
    out = spill_add(_port(win, port_plan.Windowed27))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **CONV_TOL)


def test_rulebook_routes_match_reference(plans):
    """Strided conv, deconv and unpool without windowed metadata."""
    from tdwss.ops.host_plan import downsample_level_np

    rng = np.random.default_rng(24)
    coords, valid = _scene(3)
    n = coords.shape[0]
    grid, _, _ = voxelize_np(coords, None, valid, n)
    _, parent, child, down_rb = downsample_level_np(grid, n // 2, 2, 2)
    fine = rng.normal(size=(n, 4)).astype(np.float32)
    coarse = rng.normal(size=(n // 2, 3)).astype(np.float32)
    w_dn = rng.normal(size=(8, 4, 3)).astype(np.float32)
    w_up = rng.normal(size=(8, 3, 4)).astype(np.float32)
    fv = np.asarray(grid.valid)
    np.testing.assert_allclose(
        port_sc.strided_conv_apply(_t(fine), _t(down_rb), _t(w_dn)).numpy(),
        np.asarray(ref_sc.strided_conv_apply(
            jnp.asarray(fine), jnp.asarray(down_rb), jnp.asarray(w_dn))),
        **CONV_TOL)
    np.testing.assert_allclose(
        port_sc.deconv_apply(_t(coarse), _t(parent), _t(child), _t(w_up),
                             _t(fv)).numpy(),
        np.asarray(ref_sc.deconv_apply(
            jnp.asarray(coarse), jnp.asarray(parent), jnp.asarray(child),
            jnp.asarray(w_up), jnp.asarray(fv))), **CONV_TOL)
    np.testing.assert_array_equal(
        port_sc.unpool(_t(coarse), _t(parent), _t(fv)).numpy(),
        np.asarray(ref_sc.unpool(jnp.asarray(coarse), jnp.asarray(parent),
                                 jnp.asarray(fv))))
