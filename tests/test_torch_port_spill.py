"""The spill kernels' plain versions (K8 ``spill_apply``, K9 ``spill_dw``
on the CPU) and the windowed unpool.

(a) Each windowed plan's ``spill_order`` (built with the plan) holds
    every live entry of its tiers once: by owner, owners ascending, tier
    by tier and in entry order within an owner; by tap, tier by tier and
    in entry order within a tap, in chunks of at most 512 entries of one
    tap and tier.  A plan made without it gets the same when applied.
(b) The spill sums of a route (``_spill_add``: compact list, heavy tiers
    with the tap-chunked companion) against the same contributions added
    with ``index_add_`` into their owners: float32, within 1e-6 (one sum
    in another order); two runs bit-identical.
(c) K8's and K9's plain versions through the routes' helpers
    (``_spill_add``, ``_spill_dw``) against the tier-by-tier functions
    they replace (``_res_all_apply`` and ``_res_all_dw`` added onto the
    windowed result) on every tier layout the planners make: the compact
    list only, heavy with and without the tap-chunked companion, a tile
    tier, no spills, and the cross-level maps, in float32 and bfloat16,
    for the forward and the three dW orientations.  The forward is equal
    bit for bit in float32 and within one bfloat16 ulp in bfloat16 (the
    planners give each owner one tier, so one rounding).  dW: bit for bit
    where the old code summed each tap in the same chunks (the heavy
    tier's tap-chunked companion); where it summed a tier's whole list in
    one library GEMM (whose blocking the library chooses), within the
    float32 rounding bound of both sums, 2 (m + 2) 2^-24 sum|terms| with m
    a tap's entries.
(d) ``wg_unpool_apply``: its forward equals a plain gather of each fine
    row's parent bit for bit, in float32 and bfloat16 (one product by 1
    per row, accumulated in f32); its gradient (the down map with
    identity weights on the cotangent, no dW) against ``jax.grad`` of the
    reference's ``wg_unpool_apply`` (``_wg_unpool_bwd``) with its Pallas
    route forced on the CPU (interpret mode), float32, rtol = atol = 2e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_common import port_plan_of
from tdwss.ops import pallas_subm as ps
from tdwss.ops import sparse_conv as ref_sc
from tdwss.ops.host_plan import (build_subm_rulebook_np,
                                 build_windowed_gather, downsample_level_np,
                                 parent_rulebook, reset_sticky_plans,
                                 voxelize_np)
from tdwss_torch.ops import plan as port_plan
from tdwss_torch.ops import sparse_conv as port_sc
from tdwss_torch.ops.host_plan import \
    build_windowed_subm27 as port_build_w27

GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def plans():
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
    rb = build_subm_rulebook_np(grid, 3)
    # tight windows: spills in the compact list, and in the heavy tiers
    # (grouped, with the tap-chunked companion) when res_cap is None
    compact = port_build_w27(rb, grid, tile=512, window=128, res_cap=27 * n,
                             sub=64, subwin=64)
    heavy = port_build_w27(rb, grid, tile=512, window=128, res_cap=None,
                           sub=64, subwin=64)
    reset_sticky_plans()
    return dict(n=n, nc=nc, valid=np.asarray(grid.valid), parent=parent,
                down=wgd, up=wgu, compact=compact, heavy=heavy)


def _tier_entries(win, v_out, k):
    """Each tier's live (owner, tap, src) entries in tier order, as
    Python tuples (tier, owner, tap, src)."""
    tiers = [np.asarray(win.res_ovf)]
    if win.res_tile is not None:
        rt = np.asarray(win.res_tile)
        t_res = v_out // rt.shape[0]
        own = np.where(rt[..., 0] < t_res,
                       np.arange(rt.shape[0])[:, None] * t_res + rt[..., 0],
                       v_out)
        tiers.append(np.stack([own, rt[..., 1], rt[..., 2]], -1)
                     .reshape(-1, 3))
    if win.res_tent is not None:
        tent = np.asarray(win.res_tent)
        taps = np.repeat(np.asarray(win.res_ttap), 512)
        tiers.append(np.stack([tent[:, 1], taps, tent[:, 0]], 1))
    elif win.res_hent is not None:
        tiers.append(np.asarray(win.res_hent))
    return [(t, int(o), int(a), int(s)) for t, ent in enumerate(tiers)
            for o, a, s in ent if 0 <= o < v_out and 0 <= a < k]


def _check_layout(win):
    v_out, k = win.rb_local.shape
    so = win.spill_order
    ent = _tier_entries(win, v_out, k)
    by_own = sorted(ent, key=lambda e: e[1])              # stable
    assert [tuple(r) for r in np.asarray(so.entry)] == [
        (s, a) for _, _, a, s in by_own]
    owner, start = np.asarray(so.owner), np.asarray(so.start)
    assert list(owner) == sorted({e[1] for e in ent})
    assert start[0] == 0 and start[-1] == len(ent)
    for u, o in enumerate(owner):
        assert {e[1] for e in by_own[start[u]:start[u + 1]]} == {o}
    by_tap = sorted(ent, key=lambda e: e[2])
    assert [tuple(r) for r in np.asarray(so.tap_entry)] == [
        (s, o) for _, o, _, s in by_tap]
    chunk, tap_chunk = np.asarray(so.chunk), np.asarray(so.tap_chunk)
    assert chunk[-1, 0] == len(ent) and tap_chunk.shape == (k + 1,)
    for j in range(chunk.shape[0] - 1):
        part = by_tap[chunk[j, 0]:chunk[j + 1, 0]]
        assert 0 < len(part) <= 512
        assert {(e[0], e[2]) for e in part} == {(chunk[j, 1], part[0][2])}
        a = part[0][2]
        assert tap_chunk[a] <= j < tap_chunk[a + 1]
    return len(ent)


def test_spill_order_covers_each_entry_once(plans):
    for key in ("compact", "heavy"):
        assert _check_layout(plans[key]) > 0
    assert plans["heavy"].res_tent.shape[0]
    # a plan made without it gets the same when it is applied
    rng = np.random.default_rng(8)
    feats = torch.from_numpy(rng.normal(size=(plans["n"], 4))
                             .astype(np.float32))
    w3 = torch.from_numpy(rng.normal(size=(27, 4, 3)).astype(np.float32))
    for key in ("compact", "heavy"):
        runs = []
        for win in (plans[key], plans[key].replace(spill_order=None)):
            win = win.to("cpu")
            runs.append(port_sc._spill_add(
                feats, win, w3, torch.zeros((plans["n"], 3))))
        assert torch.equal(runs[0], runs[1])


def _index_add_reference(feats, win, w2d, cout):
    """Every tier's contributions added with ``index_add_`` (the route the
    segmented sums replace)."""
    v, c = feats.shape[0], feats.shape[1]
    w3 = w2d.reshape(-1, c, cout)
    out = torch.zeros((v, cout), dtype=torch.float64)
    entries = [torch.from_numpy(win.res_ovf.astype(np.int64))]
    if win.res_tent is not None:
        tent = torch.from_numpy(win.res_tent.astype(np.int64))
        taps = torch.from_numpy(np.repeat(win.res_ttap, 512).astype(np.int64))
        entries.append(torch.stack([tent[:, 1], taps, tent[:, 0]], 1))
    for ent in entries:
        own, tap, src = ent[:, 0], ent[:, 1], ent[:, 2]
        live = (own < v) & (src < v) & (tap < 27)
        own, tap, src = own[live], tap[live], src[live]
        contrib = torch.einsum("ec,eco->eo", feats[src].double(),
                               w3[tap].double())
        out.index_add_(0, own, contrib)
    return out


@pytest.mark.parametrize("key", ["compact", "heavy"])
def test_segmented_spill_sum_equals_index_add(plans, key):
    win = port_plan_of(plans[key], port_plan.Windowed27)
    rng = np.random.default_rng(7)
    c, cout = 6, 5
    feats = torch.from_numpy(rng.normal(size=(plans["n"], c))
                             .astype(np.float32))
    w2d = torch.from_numpy(rng.normal(size=(27 * c, cout)).astype(np.float32))
    w3 = w2d.reshape(27, c, cout)
    out = port_sc._spill_add(feats, win, w3, torch.zeros((plans["n"], cout)))
    again = port_sc._spill_add(feats, win, w3,
                               torch.zeros((plans["n"], cout)))
    assert torch.equal(out, again)
    ref = _index_add_reference(feats, plans[key], w2d, cout)
    assert ref.abs().max() > 1.0
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)


def _layout_of(plans, layout):
    """(plan with its spill order, V_src, V_out) of one tier layout."""
    n, nc = plans["n"], plans["nc"]
    if layout in ("down", "up"):
        cls = port_plan.WindowedGather
        win = port_plan_of(plans[layout], cls)
        return win, (n, nc) if layout == "down" else (nc, n)
    win = plans["heavy" if layout.startswith("heavy") else "compact"]
    if layout == "heavy_hent":
        win = win.replace(res_tent=None, res_ttap=None, res_tperm=None)
    elif layout == "empty":
        pad = np.full_like(win.res_ovf, n)
        win = win.replace(res_ovf=pad)
    elif layout == "tile":
        # the compact list's even 512-row tiles as a tile tier (T2, R, 3)
        # [local, tap, src], padding local == 512; the rest stays compact
        ovf = win.res_ovf[win.res_ovf[:, 0] < n]
        tile_of = ovf[:, 0] // 512
        moved = tile_of % 2 == 0
        r = int(np.bincount(tile_of[moved]).max())
        res_tile = np.zeros((n // 512, r, 3), np.int32)
        res_tile[..., 0] = 512
        res_tile[..., 2] = n
        for t in range(0, n // 512, 2):
            rows = ovf[tile_of == t]
            res_tile[t, :len(rows), 0] = rows[:, 0] % 512
            res_tile[t, :len(rows), 1:] = rows[:, 1:]
        rest = np.full_like(win.res_ovf, n)
        rest[:int((~moved).sum())] = ovf[~moved]
        win = win.replace(res_ovf=rest, res_tile=res_tile)
    win = port_plan.with_spill_order(win.replace(spill_order=None))
    return win.to("cpu"), (n, n)


def _ulps_bf16(x):
    """One bfloat16 ulp of each element of ``x`` (f32)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


LAYOUTS = ["compact", "heavy", "heavy_hent", "tile", "empty", "down", "up"]
PASSES = {"apply": None, "dw": (False, True), "dw_flip": (True, True),
          "dw_flip_keep_taps": (True, False)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pass_", list(PASSES))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_spill_kernels_plain_match_tier_functions(plans, layout, pass_,
                                                  dtype):
    win, (v_src, v_out) = _layout_of(plans, layout)
    k = win.rb_local.shape[1]
    rng = np.random.default_rng(LAYOUTS.index(layout) * 8 + len(pass_))
    c, cout = 6, 5

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    rtile = port_sc._pack_rtile(win)
    entries = win.spill_order.entries
    assert (entries == 0) == (layout == "empty")
    if PASSES[pass_] is None:
        feats, w3 = rand(v_src, c).to(dtype), rand(k, c, cout)
        base = rand(v_out, cout).to(dtype)
        old = port_sc._res_all_apply(feats, rtile, win.res_ovf, win.ovf_v,
                                     win.ovf_count, w3.reshape(k * c, cout),
                                     cout, out_len=v_out)
        want = base + old.to(dtype)
        got = port_sc._spill_add(feats, win, w3, base.clone())
        assert torch.equal(got, port_sc._spill_add(feats, win, w3,
                                                   base.clone()))
        if dtype == torch.float32:
            assert torch.equal(got, want)
        else:
            d = (got.float() - want.float()).abs()
            assert (d <= _ulps_bf16(want.float())).all()
        return
    flip, tap_flip = PASSES[pass_]
    n_l, n_r = (v_out, v_src) if flip else (v_src, v_out)
    feats, dout = rand(n_l, c).to(dtype), rand(n_r, cout).to(dtype)
    base = rand(k, c, cout)
    old = port_sc._res_all_dw(feats, rtile, win.res_ovf, dout, k, flip,
                              tap_flip)
    want = base + old.reshape(k, c, cout)
    got = port_sc._spill_dw(feats, dout, win, base.clone(), flip, tap_flip)
    assert torch.equal(got, port_sc._spill_dw(feats, dout, win,
                                              base.clone(), flip, tap_flip))
    if layout in ("heavy", "empty"):
        assert torch.equal(got, want)
        return
    # the float32 rounding bound of two sums of the same terms
    ent = np.asarray(win.spill_order.tap_entry).astype(np.int64)
    lrow, rrow = (ent[:, 1], ent[:, 0]) if flip else (ent[:, 0], ent[:, 1])
    chunk = np.asarray(win.spill_order.chunk)
    first = np.asarray(win.spill_order.tap_chunk)
    absum = base.double().abs().clone()
    per_tap = np.zeros(k, np.int64)
    fl, dr = feats.double().abs(), dout.double().abs()
    for a in range(k):
        rows = slice(chunk[first[a], 0], chunk[first[a + 1], 0])
        slot = k - 1 - a if (flip and tap_flip) else a
        absum[slot] += fl[lrow[rows]].t() @ dr[rrow[rows]]
        per_tap[slot] = rows.stop - rows.start
    m = torch.from_numpy(per_tap + 2).double()[:, None, None]
    bound = 2 * m * 2.0 ** -24 * absum
    assert ((got.double() - want.double()).abs() <= bound).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unpool_forward_is_a_gather(plans, dtype):
    rng = np.random.default_rng(3)
    coarse = torch.from_numpy(rng.normal(size=(plans["nc"], 24))
                              .astype(np.float32)).to(dtype)
    up = port_plan_of(plans["up"], port_plan.WindowedGather)
    down = port_plan_of(plans["down"], port_plan.WindowedGather)
    out = port_sc.wg_unpool_apply(coarse, up, down)
    parent = torch.from_numpy(plans["parent"].astype(np.int64))
    ok = torch.from_numpy(plans["valid"]) & (parent >= 0) & (
        parent < plans["nc"])
    want = torch.where(ok[:, None], coarse[parent.clamp(0, plans["nc"] - 1)],
                       torch.zeros((), dtype=dtype))
    assert out.dtype == dtype
    assert torch.equal(out, want)


def test_unpool_gradient_matches_reference(plans, monkeypatch):
    monkeypatch.setattr(
        ref_sc, "_use_pallas_wg",
        lambda v_src, v_out, tiles, window, k, c, cout, nwin=1:
        tiles > 0 and v_out % tiles == 0 and window % 8 == 0
        and v_src % 8 == 0)
    monkeypatch.setattr(ps, "windowed_matmul_sub", functools.partial(
        ps.windowed_matmul_sub, interpret=True))
    rng = np.random.default_rng(4)
    coarse = rng.normal(size=(plans["nc"], 10)).astype(np.float32)
    r = rng.normal(size=(plans["n"], 10)).astype(np.float32)
    jm = jax.tree_util.tree_map
    uj, dj = jm(jnp.asarray, plans["up"]), jm(jnp.asarray, plans["down"])
    ref = jax.grad(lambda f: jnp.sum(
        ref_sc.wg_unpool_apply(f, uj, dj) * r))(jnp.asarray(coarse))
    ct = torch.tensor(coarse, requires_grad=True)
    port_sc.wg_unpool_apply(
        ct, port_plan_of(plans["up"], port_plan.WindowedGather),
        port_plan_of(plans["down"], port_plan.WindowedGather)
    ).backward(torch.from_numpy(r))
    assert (plans["down"].res_ovf[:, 0] < plans["nc"]).sum() > 0
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(ref), **GRAD_TOL)
