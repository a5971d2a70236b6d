"""Gradients of the port's windowed cross-level conv, and the spill tiers'
dW, against the reference.

(b) ``wg_conv_apply`` (strided conv and deconv) on real host-built
    transposed-rulebook plans, through the port's autograd on the K2
    route (``flip_taps=False``, B-side spill dW swapped) and on the K3
    route (F-side dW, K1 on the cotangent over the B side), against
    ``jax.grad`` through the reference with its Pallas route forced on the
    CPU (interpret mode), as ``tests/test_sparse_conv.py:811-852`` does.
    float32, rtol = atol = 2e-4 (summation order).
(c) The spill tiers' dW: K9's plain version (``_spill_dw``) in the
    three orientations on a plan whose heavy tier is populated, against
    the reference's ``_res_all_dw`` (every tier, the heavy one through
    its tap-chunked companion) and, on the heavy tier alone, against its
    ``_res_heavy_dw`` entry by entry; and on a plan whose only tier is a
    tile-grouped one (which the reference planners never fill), against
    the reference's ``_res_tile_dw`` where it honours ``tap_flip`` and
    against its ``_res_ovf_dw`` of the same entries as a compact list in
    every orientation.  float32, rtol = atol = 1e-4 (summation order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_common import (count_route_calls, port_plan_of,
                                      tiers_only)
from tdwss.ops import pallas_subm as ps
from tdwss.ops import sparse_conv as ref_sc
from tdwss.ops.host_plan import (build_subm_rulebook_np,
                                 build_windowed_gather,
                                 build_windowed_subm27, downsample_level_np,
                                 parent_rulebook, reset_sticky_plans,
                                 voxelize_np)
from tdwss_torch.ops import plan as port_plan
from tdwss_torch.ops import sparse_conv as port_sc

GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
DW_TOL = dict(rtol=1e-4, atol=1e-4)
PALLAS_FNS = ("windowed_bwd_gather", "windowed_matmul_sub", "windowed_matmul",
              "windowed_dw_sub", "windowed_dw")


@pytest.fixture(scope="module")
def wg_plans():
    reset_sticky_plans()
    rng = np.random.default_rng(19)
    n, nc = 2048, 1024
    coords = np.concatenate([rng.integers(0, 32, (n, 3)),
                             rng.integers(0, 3, (n, 1))], 1).astype(np.int32)
    valid = rng.random(n) > 0.05
    grid, _, _ = voxelize_np(coords, None, valid, n)
    _, parent, child_off, down_rb = downsample_level_np(grid, nc, 2, 2)
    wgd = build_windowed_gather(down_rb, v_src=n, tile=256, group_mod=2,
                                res_cap=8 * n, sub=64, subwin=64)
    wgu = build_windowed_gather(parent_rulebook(parent, child_off, nc, 8),
                                v_src=nc, tile=256, res_cap=8 * n, sub=64,
                                subwin=64)
    reset_sticky_plans()
    return dict(n=n, nc=nc, valid=np.asarray(grid.valid), down=wgd, up=wgu)


def _force_reference_pallas(monkeypatch):
    monkeypatch.setattr(
        ref_sc, "_use_pallas_wg",
        lambda v_src, v_out, tiles, window, k, c, cout, nwin=1:
        tiles > 0 and v_out % tiles == 0 and window % 8 == 0
        and v_src % 8 == 0)
    for name in PALLAS_FNS:
        monkeypatch.setattr(ps, name, functools.partial(
            getattr(ps, name), interpret=True))


def _wg_grads(p, direction, seed, cin, cout):
    rng = np.random.default_rng(seed)
    fwd, bwd, v_in, v_out = ((p["down"], p["up"], p["n"], p["nc"])
                             if direction == "strided"
                             else (p["up"], p["down"], p["nc"], p["n"]))
    feats = rng.normal(size=(v_in, cin)).astype(np.float32)
    w = (rng.normal(size=(8, cin, cout)) * 0.3).astype(np.float32)
    r = rng.normal(size=(v_out, cout)).astype(np.float32)
    jm = jax.tree_util.tree_map
    fj, bj = jm(jnp.asarray, fwd), jm(jnp.asarray, bwd)
    ref = jax.grad(lambda f, w_: jnp.sum(
        ref_sc.wg_conv_apply(f, w_, fj, bj) * r), argnums=(0, 1))(
        jnp.asarray(feats), jnp.asarray(w))
    ft = torch.tensor(feats, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    port_sc.wg_conv_apply(
        ft, wt, port_plan_of(fwd, port_plan.WindowedGather),
        port_plan_of(bwd, port_plan.WindowedGather)).backward(torch.from_numpy(r))
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(ref[0]),
                               **GRAD_TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(ref[1]),
                               **GRAD_TOL)


def test_wg_plans_are_sub_form_with_spills(wg_plans):
    for key, v_out in (("down", wg_plans["nc"]), ("up", wg_plans["n"])):
        plan = wg_plans[key]
        assert plan.sub == 64 and plan.rb_local.shape[0] == v_out
        assert (plan.res_ovf[:, 0] < v_out).sum() > 0


@pytest.mark.parametrize("direction", ["strided", "deconv"])
def test_wg_k2_route_gradients_match_reference(wg_plans, monkeypatch,
                                               direction):
    _force_reference_pallas(monkeypatch)
    calls = count_route_calls(monkeypatch, ["windowed_bwd_gather",
                                       "windowed_dw_sub"])
    _wg_grads(wg_plans, direction, 51, 8, 8)
    assert calls == {"windowed_bwd_gather": 1, "windowed_dw_sub": 0}


def test_wg_k3_route_gradients_match_reference(wg_plans, monkeypatch):
    _force_reference_pallas(monkeypatch)
    monkeypatch.setenv("TDWSS_NO_GATHER_BWD", "1")
    monkeypatch.setattr(port_sc, "_GATHER_MAX_C", 0)
    calls = count_route_calls(monkeypatch, ["windowed_bwd_gather",
                                       "windowed_dw_sub",
                                       "windowed_matmul_sub"])
    _wg_grads(wg_plans, "strided", 52, 6, 10)
    assert calls == {"windowed_bwd_gather": 0, "windowed_dw_sub": 1,
                     "windowed_matmul_sub": 2}       # forward + dfeats


# --------------------------------------------------------------------------
# (c) the spill tiers' dW
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def heavy_plan():
    """A flat 27-tap plan with a narrow window: the heavy tier (and its
    tap-chunked companion) is populated."""
    reset_sticky_plans()
    rng = np.random.default_rng(3)
    n = 4096
    coords = np.concatenate([rng.integers(0, 20, (n, 3)),
                             rng.integers(0, 2, (n, 1))], 1).astype(np.int32)
    valid = rng.random(n) > 0.05
    grid, _, _ = voxelize_np(coords, None, valid, n)
    rb = build_subm_rulebook_np(grid, 3)
    win = build_windowed_subm27(rb, grid, tile=512, window=96)
    reset_sticky_plans()
    return win, n


def _spill_dw(feats, dout, pw, flip, tap_flip):
    """K9's plain version (``_spill_dw``) onto a zero dW -> (K*C, Cout)."""
    k, c, cout = pw.rb_local.shape[1], feats.shape[1], dout.shape[1]
    dw = port_sc._spill_dw(feats, dout, pw, torch.zeros((k, c, cout)),
                           flip, tap_flip)
    return dw.reshape(k * c, cout)


@pytest.mark.parametrize("flip,tap_flip", [(False, True), (True, True),
                                           (True, False)])
def test_spill_dw_tiers_match_reference(heavy_plan, flip, tap_flip):
    win, v = heavy_plan
    assert (win.res_hent[:, 0] < v).sum() > 0 and win.res_tent.shape[0]
    rng = np.random.default_rng(24)
    c, cout = 6, 5
    feats = rng.normal(size=(v, c)).astype(np.float32)
    dout = rng.normal(size=(v, cout)).astype(np.float32)
    ft, dt = torch.from_numpy(feats), torch.from_numpy(dout)
    rt_ref = ref_sc._pack_rtile(jax.tree_util.tree_map(jnp.asarray, win))
    ref = ref_sc._res_all_dw(jnp.asarray(feats), rt_ref,
                             jnp.asarray(win.res_ovf), jnp.asarray(dout),
                             flip=flip, tap_flip=tap_flip)
    out = _spill_dw(ft, dt, port_plan_of(win, port_plan.Windowed27), flip,
                    tap_flip)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **DW_TOL)
    # the heavy tier alone, against the reference's entry-by-entry form
    # (no tap-chunked companion)
    ref_h = ref_sc._res_heavy_dw(jnp.asarray(feats),
                                 jnp.asarray(win.res_hent),
                                 jnp.asarray(dout), flip=flip,
                                 tap_flip=tap_flip)
    out_h = _spill_dw(ft, dt, tiers_only(win, res_hent=win.res_hent,
                                          res_htile=win.res_htile),
                      flip, tap_flip)
    np.testing.assert_allclose(out_h.numpy(), np.asarray(ref_h), **DW_TOL)


@pytest.mark.parametrize("flip,tap_flip", [(False, True), (True, True),
                                           (True, False)])
def test_tile_tier_dw_equals_compact_list_dw(heavy_plan, flip, tap_flip):
    """K9 on a plan whose only tier is a tile-grouped one (T2, R, 3)
    [local, tap, src] against the reference's ``_res_tile_dw``, and
    against its compact-list dW (``_res_ovf_dw``) of the same entries in
    every orientation: the reference's ``_res_tile_dw`` flips the taps
    whenever ``flip`` is set, ignoring ``tap_flip`` (the port honours it,
    as its other tiers do), so with ``tap_flip=False`` only the compact
    list's dW states the case."""
    win, v = heavy_plan
    ent = win.res_hent[win.res_hent[:, 0] < v]
    r = 8
    tiles = v // 512
    res_tile = np.zeros((tiles, r, 3), np.int32)
    res_tile[..., 0] = 512
    res_tile[..., 2] = v
    kept = []
    for t in range(tiles):
        rows = ent[(ent[:, 0] // 512) == t][:r]
        res_tile[t, :len(rows), 0] = rows[:, 0] % 512
        res_tile[t, :len(rows), 1:] = rows[:, 1:]
        kept.append(rows)
    kept = np.concatenate(kept)
    assert len(kept) > 0
    rng = np.random.default_rng(25)
    feats = torch.from_numpy(rng.normal(size=(v, 4)).astype(np.float32))
    dout = torch.from_numpy(rng.normal(size=(v, 3)).astype(np.float32))
    out = _spill_dw(feats, dout, tiers_only(win, res_tile=res_tile), flip,
                    tap_flip)
    fj, dj = jnp.asarray(feats.numpy()), jnp.asarray(dout.numpy())
    ref = ref_sc._res_ovf_dw(fj, jnp.asarray(kept), dj, flip=flip,
                             tap_flip=tap_flip)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **DW_TOL)
    if tap_flip or not flip:
        ref_t = ref_sc._res_tile_dw(fj, jnp.asarray(res_tile), dj,
                                    flip=flip, tap_flip=tap_flip)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_t), **DW_TOL)
