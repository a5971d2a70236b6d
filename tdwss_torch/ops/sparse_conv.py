"""Sparse convolutions and their backward (twin of
:mod:`tdwss.ops.sparse_conv`).

Routes, as in the reference:

- :func:`subm_conv_apply` with host-built ``Windowed27`` metadata runs the
  windowed gather-GEMM (K1 in the sub form, K4 in the flat form, see
  :mod:`tdwss_torch.ops.windowed`) plus the spill tiers; without it, the
  plain rulebook gather-GEMM;
- :func:`wg_conv_apply` / :func:`wg_unpool_apply` evaluate cross-level
  rulebooks (strided conv, deconv, unpool) through ``WindowedGather``
  metadata the same way;
- :func:`strided_conv_apply`, :func:`deconv_apply` and :func:`unpool` are
  the rulebook forms for levels without windowed metadata (plain
  differentiable torch).

Windows and spill tiers together are an exact cover of the rulebook, so
every route computes ``out[v] = sum_k feats[rb[v, k]] @ W[k]``.  The
windowed subm and cross-level convs are ``torch.autograd.Function``s
whose backward runs K2 (fused dfeats + dW) or K3/K5 (dW) with K1/K4 on
the cotangent (dfeats), plus the spill tiers' dW and dfeats (see
"Backward routes" below).  On a CUDA tensor every windowed evaluation
launches its kernel; on a CPU tensor the same calls run the kernels'
plain versions.

A ``-1`` rulebook entry means "no neighbour": every gather here masks it
(torch indexing, like numpy, would wrap it to the last row).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from tdwss_torch.ops.windowed import (windowed_bwd_gather, windowed_dw,
                                     windowed_dw_sub, windowed_matmul,
                                     windowed_matmul_sub)

_RES_HCHUNK = 512     # must match tdwss_torch.ops.host_plan._RES_HCHUNK
_RES_TILE = 512       # must match tdwss_torch.ops.host_plan._RES_TILE


def _gather_rows(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats[idx] with out-of-range (incl. negative) ids reading zeros."""
    n = feats.shape[0]
    ok = (idx >= 0) & (idx < n)
    g = feats[torch.where(ok, idx, torch.zeros_like(idx)).long()]
    return g * ok.unsqueeze(-1).to(g.dtype)


def _gather_matmul_impl(feats: torch.Tensor, rulebook: torch.Tensor,
                        weight: torch.Tensor) -> torch.Tensor:
    """out = sum_k feats[rb[:, k]] @ W[k] (f32 accumulation) -> feats dtype.

    weight (K, Cin, Cout); missing neighbours (-1) read zeros.
    """
    v, k = rulebook.shape
    w = weight.to(feats.dtype).float()
    out = torch.zeros((v, w.shape[-1]), dtype=torch.float32,
                      device=feats.device)
    for a in range(k):
        out += _gather_rows(feats, rulebook[:, a]).float() @ w[a]
    return out.to(feats.dtype)


# ---------------------------------------------------------------------------
# Spill tiers: the rulebook entries the windows miss, as (owner, tap, src)
# ---------------------------------------------------------------------------


def _live_entries(n_left, n_right, lrows, taps, rrows, k):
    return ((lrows >= 0) & (lrows < n_left) & (rrows >= 0)
            & (rrows < n_right) & (taps >= 0) & (taps < k))


def _entry_apply(feats, owners, taps, srcs, w3, out):
    """out[owner] += feats[src] @ w3[tap] over live entries (f32 ``out``).

    Dead entries (owner, src or tap out of range: the planner's padding)
    read zeros.  Each entry's contribution is the sum over taps of its
    tap-masked row times w3[a] (one nonzero term, so the value is the
    single product), then one ``index_add_`` into the owners: no host
    synchronisation.
    """
    k = w3.shape[0]
    live = _live_entries(feats.shape[0], out.shape[0], srcs, taps, owners, k)
    f = _gather_rows(feats, torch.where(live, srcs, -1)).float()
    w = w3.to(feats.dtype).float()
    contrib = torch.zeros((f.shape[0], w.shape[-1]), dtype=torch.float32,
                          device=feats.device)
    for a in range(k):
        contrib += (f * (taps == a).unsqueeze(-1)) @ w[a]
    own = torch.where(live, owners, 0).long()
    return out.index_add_(0, own, contrib)


def _entry_dw(feats, dout, lrows, taps, rrows, k):
    """dW (K*C, Cout) f32: feats[lrow]^T (x) dout[rrow] summed into slot
    ``tap`` over live entries (dead ones read zeros)."""
    live = _live_entries(feats.shape[0], dout.shape[0], lrows, taps, rrows, k)
    f = _gather_rows(feats, torch.where(live, lrows, -1)).float()
    d = _gather_rows(dout, rrows).to(feats.dtype).float()
    dw = torch.empty((k, f.shape[1], d.shape[1]), dtype=torch.float32,
                     device=feats.device)
    for a in range(k):
        dw[a] = (f * (taps == a).unsqueeze(-1)).t() @ d
    return dw.reshape(k * f.shape[1], d.shape[1])


def _res_ovf_apply(feats, res_ovf, ovf_v, ovf_count, w2d, cout,
                   out_len=None):
    """Compact spill list [v, tap, src] -> (out_len, Cout) f32.

    The reference sums each owner's run of entries (``ovf_v`` /
    ``ovf_count``) before one scatter; adding entries straight into their
    owner rows is the same sum.
    """
    v = out_len if out_len is not None else feats.shape[0]
    w3 = w2d.reshape(-1, feats.shape[-1], cout)
    out = torch.zeros((v, cout), dtype=torch.float32, device=feats.device)
    return _entry_apply(feats, res_ovf[:, 0], res_ovf[:, 1], res_ovf[:, 2],
                        w3, out)


def _tile_entries(res_tile, v_out):
    """Tile-grouped spills (T2, R, 3) [local, tap, src] -> flat (owner,
    tap, src); the owner of a slot is tile * (v_out / T2) + local, and a
    padding slot (local >= v_out / T2) gets the out-of-range owner v_out."""
    t2, r, _ = res_tile.shape
    t_res = v_out // t2
    local = res_tile[..., 0]
    tile_ids = torch.arange(t2, device=res_tile.device,
                            dtype=local.dtype)[:, None]
    owners = torch.where(local < t_res, tile_ids * t_res + local,
                         torch.full_like(local, v_out))
    return (owners.reshape(-1), res_tile[..., 1].reshape(-1),
            res_tile[..., 2].reshape(-1))


def _res_tile_apply(feats, res_tile, w2d, cout, v_out):
    """Tile-grouped spills -> (v_out, Cout), feats dtype."""
    owners, taps, srcs = _tile_entries(res_tile, v_out)
    w3 = w2d.reshape(-1, feats.shape[-1], cout)
    out = torch.zeros((v_out, cout), dtype=torch.float32, device=feats.device)
    return _entry_apply(feats, owners, taps, srcs, w3, out).to(feats.dtype)


def _res_heavy_apply(feats, res_hent, res_htile, w2d, cout, v_out, t2,
                     tent=None, ttap=None, tperm=None):
    """Heavy-tile spills -> (v_out, Cout), feats dtype.

    With the tap-chunked companion (``tent`` [src, owner] rows, one tap
    per ``_RES_HCHUNK``-row chunk in ``ttap``) the contributions are one
    batched (chunk, C) @ (C, Cout) product per chunk; otherwise the
    owner-chunked ``res_hent`` rows [owner, tap, src] are applied entry by
    entry.  ``res_htile`` / ``tperm`` only lay out the reference's TPU
    scatter and are not needed here.
    """
    cin = feats.shape[-1]
    w3 = w2d.reshape(-1, cin, cout)
    out = torch.zeros((v_out, cout), dtype=torch.float32, device=feats.device)
    if tent is not None and ttap is not None and tent.shape[0]:
        nc = ttap.shape[0]
        f = _gather_rows(feats, tent[:, 0]).float()
        wsel = w3.to(feats.dtype).float()[ttap.long()]       # (NC, C, Cout)
        contrib = torch.bmm(f.reshape(nc, _RES_HCHUNK, cin), wsel)
        own = tent[:, 1].long()
        live = (own >= 0) & (own < v_out)
        own = torch.where(live, own, torch.zeros_like(own))
        out.index_add_(0, own, contrib.reshape(-1, cout)
                       * live.unsqueeze(-1))
    else:
        out = _entry_apply(feats, res_hent[:, 0], res_hent[:, 1],
                           res_hent[:, 2], w3, out)
    return out.to(feats.dtype)


def _res_all_apply(feats, rtile, res_ovf, ovf_v, ovf_count, w2d, cout,
                   out_len=None):
    """Every spill tier of one windowed plan -> (out_len, Cout), feats dtype.

    ``rtile`` = (res_tile, res_hent, res_htile, res_tent, res_ttap,
    res_tperm), any of them None.
    """
    v = out_len if out_len is not None else feats.shape[0]
    out = torch.zeros((v, cout), dtype=feats.dtype, device=feats.device)
    if res_ovf.shape[0]:
        out = _res_ovf_apply(feats, res_ovf, ovf_v, ovf_count, w2d, cout,
                             out_len=v).to(feats.dtype)
    res_tile, res_hent, res_htile, tent, ttap, tperm = rtile
    if tent is not None and not tent.shape[0]:
        tent = ttap = tperm = None
    if res_tile is not None and res_tile.shape[0] and res_tile.shape[1]:
        out = out + _res_tile_apply(feats, res_tile, w2d, cout, v)
    if (res_hent is not None and res_htile is not None
            and res_hent.shape[0] and v % _RES_TILE == 0):
        out = out + _res_heavy_apply(feats, res_hent, res_htile, w2d, cout,
                                     v, v // _RES_TILE, tent, ttap, tperm)
    return out


# ---------------------------------------------------------------------------
# Spill tiers' dW.  ``flip``: evaluate each entry (owner, tap, src) in the
# flipped orientation, feats[owner] (x) dout[src] into slot K-1-tap (slot
# tap with ``tap_flip=False``, the cross-level maps, whose tap is the
# child offset in both directions).  K2's windowed dW covers the flip of
# the windowed entry set, so the spill set must be flipped too for the
# union to cover the rulebook exactly once.
# ---------------------------------------------------------------------------


def _flip_taps(taps, k, flip, tap_flip):
    return (k - 1) - taps if (flip and tap_flip) else taps


def _res_ovf_dw(feats, res_ovf, dout, k=27, flip=False, tap_flip=True):
    """Compact spill list [owner, tap, src] -> (K*C, Cout) f32."""
    owner, tap, src = res_ovf[:, 0], res_ovf[:, 1], res_ovf[:, 2]
    tap = _flip_taps(tap, k, flip, tap_flip)
    if flip:
        return _entry_dw(feats, dout, owner, tap, src, k)
    return _entry_dw(feats, dout, src, tap, owner, k)


def _res_tile_dw(feats, res_tile, dout, k=27, flip=False, tap_flip=True):
    """Tile-grouped spills -> (K*C, Cout) f32.  The owners live in dout's
    domain, or in feats' when flipped."""
    owner, tap, src = _tile_entries(
        res_tile, feats.shape[0] if flip else dout.shape[0])
    tap = _flip_taps(tap, k, flip, tap_flip)
    if flip:
        return _entry_dw(feats, dout, owner, tap, src, k)
    return _entry_dw(feats, dout, src, tap, owner, k)


def _res_heavy_dw(feats, res_hent, dout, k=27, tent=None, ttap=None,
                  flip=False, tap_flip=True):
    """Heavy-tile spills -> (K*C, Cout) f32.

    With the tap-chunked companion (``tent`` [src, owner] rows, one tap
    per ``_RES_HCHUNK``-row chunk in ``ttap``) each chunk is one
    (C, chunk) @ (chunk, Cout) product, summed into its tap slot by a
    one-hot (K, chunks) matmul; otherwise the owner-chunked ``res_hent``
    rows [owner, tap, src] are taken entry by entry.  The reference also
    reuses the forward's tap-ordered feats gather (``f_tap``); here the
    gather is made again.
    """
    if tent is not None and ttap is not None:
        cin, cout = feats.shape[-1], dout.shape[-1]
        nc = ttap.shape[0]
        fcol, dcol = (1, 0) if flip else (0, 1)
        tapv = _flip_taps(ttap, k, flip, tap_flip).long()
        f = _gather_rows(feats, tent[:, fcol]).float()
        d = _gather_rows(dout, tent[:, dcol]).to(feats.dtype).float()
        g = torch.bmm(f.reshape(nc, _RES_HCHUNK, cin).transpose(1, 2),
                      d.reshape(nc, _RES_HCHUNK, cout))    # (NC, C, Cout)
        oh = (torch.arange(k, device=feats.device)[:, None]
              == tapv[None, :]).float()
        return (oh @ g.reshape(nc, cin * cout)).reshape(k * cin, cout)
    owner, tap, src = res_hent[:, 0], res_hent[:, 1], res_hent[:, 2]
    tap = _flip_taps(tap, k, flip, tap_flip)
    if flip:
        return _entry_dw(feats, dout, owner, tap, src, k)
    return _entry_dw(feats, dout, src, tap, owner, k)


def _res_all_dw(feats, rtile, res_ovf, dout, k=27, flip=False,
                tap_flip=True):
    """Every spill tier's dW -> (K*C, Cout) f32 (raw tap order)."""
    cin = feats.shape[-1]
    dw = torch.zeros((k * cin, dout.shape[-1]), dtype=torch.float32,
                     device=feats.device)
    if res_ovf.shape[0]:
        dw = _res_ovf_dw(feats, res_ovf, dout, k, flip, tap_flip)
    res_tile, res_hent, _, tent, ttap, _ = rtile
    if tent is not None and not tent.shape[0]:
        tent = ttap = None
    if res_tile is not None and res_tile.shape[0] and res_tile.shape[1]:
        dw = dw + _res_tile_dw(feats, res_tile, dout, k, flip, tap_flip)
    if res_hent is not None and res_hent.shape[0]:
        dw = dw + _res_heavy_dw(feats, res_hent, dout, k, tent, ttap, flip,
                                tap_flip)
    return dw


def _pack_rtile(win):
    return (win.res_tile, win.res_hent, win.res_htile, win.res_tent,
            win.res_ttap, win.res_tperm)


# ---------------------------------------------------------------------------
# Windowed routes
# ---------------------------------------------------------------------------


def _w27_active_slice(va, v, tile_sz, starts, sub_off, rb_local, sub):
    """Slice plan arrays to the active output prefix ``va`` (a multiple of
    the tile; rows past it are all padding)."""
    if not va or va >= v or va % tile_sz:
        return starts, sub_off, rb_local
    ta = va // tile_sz
    starts = starts[:ta]
    if sub and sub_off is not None and sub_off.shape[0]:
        sub_off = sub_off[:ta * (tile_sz // sub)]
    return starts, sub_off, rb_local[:va]


def _pad_active(out, v):
    """Zero-pad an active-prefix result back to the V domain."""
    if out.shape[0] == v:
        return out
    return F.pad(out, (0, 0, 0, v - out.shape[0]))


def _windowed_any(src, rb_local, starts, weight, window, tile, sub, subwin,
                  sub_off):
    """One windowed gather-GEMM: K1 in the sub form, K4 in the flat form.

    rb_local (V_out, K) int32; starts (tiles, nwin); weight (K, C, Cout).
    """
    if sub:
        return windowed_matmul_sub(src, starts.reshape(-1),
                                   sub_off.reshape(-1), rb_local.t(), weight,
                                   window=window, tile=tile, sub=sub,
                                   subwin=subwin)
    return windowed_matmul(src, starts.reshape(-1), rb_local.t(), weight,
                           window=window, tile=tile)


def _windowed_dw_any(src, rb_local, starts, dout, window, tile, sub,
                     subwin, sub_off):
    """One windowed dW: K3 in the sub form, K5 in the flat form
    -> (K*C, Cout) f32."""
    k, c = rb_local.shape[1], src.shape[1]
    if sub:
        dw = windowed_dw_sub(src, starts.reshape(-1), sub_off.reshape(-1),
                             rb_local.t(), dout, window=window, tile=tile,
                             sub=sub, subwin=subwin)
    else:
        dw = windowed_dw(src, starts.reshape(-1), rb_local.t(), dout,
                         window=window, tile=tile)
    return dw.reshape(k * c, -1)


def _w27_matmul_any(feats, rb_local, starts, weight, window, sub=0,
                    subwin=0, sub_off=None, v_active=0):
    """27-tap windowed gather-GEMM over the active prefix -> (V, Cout)."""
    v = feats.shape[0]
    tile_sz = v // starts.shape[0]
    starts, sub_off, rb_local = _w27_active_slice(
        v_active, v, tile_sz, starts, sub_off, rb_local, sub)
    out = _windowed_any(feats, rb_local, starts, weight, window, tile_sz,
                        sub, subwin, sub_off)
    return _pad_active(out, v)


def _wg_matmul_any(src, rb_local, starts, weight, window, sub=0, subwin=0,
                   sub_off=None):
    """Windowed cross-level rulebook evaluation -> (V_out, Cout)."""
    v_out = rb_local.shape[0]
    if starts.dim() == 1:
        starts = starts[:, None]
    return _windowed_any(src, rb_local, starts, weight, window,
                         v_out // starts.shape[0], sub, subwin, sub_off)


def _w27_dw_any(feats, rb_local, starts, dout, window, sub=0, subwin=0,
                sub_off=None, v_active=0):
    """27-tap windowed dW over the active prefix -> (27*C, Cout) f32."""
    tile_sz = feats.shape[0] // starts.shape[0]
    starts, sub_off, rb_local = _w27_active_slice(
        v_active, feats.shape[0], tile_sz, starts, sub_off, rb_local, sub)
    return _windowed_dw_any(feats, rb_local, starts, dout[:rb_local.shape[0]],
                            window, tile_sz, sub, subwin, sub_off)


def _wg_dw_any(src, rb_local, starts, dout, window, sub=0, subwin=0,
               sub_off=None):
    """Windowed cross-level dW -> (K*C, Cout) f32."""
    if starts.dim() == 1:
        starts = starts[:, None]
    return _windowed_dw_any(src, rb_local, starts, dout, window,
                            rb_local.shape[0] // starts.shape[0], sub,
                            subwin, sub_off)


# ---------------------------------------------------------------------------
# Backward routes.  As in the reference (``_subm_conv_w27_bwd``,
# ``_wg_conv_bwd``, tdwss/ops/sparse_conv.py:1006-1063, 1474-1517): where
# the backward plan is sub-form and both widths are at most
# ``_GATHER_MAX_C``, K2 gives dfeats and dW in one pass and the spill dW
# runs flipped; otherwise K3 (sub) or K5 (flat) gives dW with the spill
# dW in the forward orientation, and K1 (or K4) on the cotangent gives
# dfeats.  The spill tiers' dfeats are ``_res_all_apply`` on the
# cotangent either way.  The reference's TPU-only gates are dropped:
# ``_use_pallas_kernel`` / ``_use_pallas_wg`` (backend and
# ``_PALLAS_MIN_V``, :657-681, :1288-1300), ``_sub_vmem_fits`` (:711),
# ``_gather_vmem_fits`` (:752) and the lane packing ``_pack_p``.  The
# CPU takes the same routes as the card, with the plain versions.
# ---------------------------------------------------------------------------

_GATHER_MAX_C = 128


def _gather_route(sub, cin, cout) -> bool:
    return bool(sub) and cin <= _GATHER_MAX_C and cout <= _GATHER_MAX_C


def _subm_w27_backward(feats, weight, dout, win, need_dfeats):
    k, cin, cout = weight.shape
    v = feats.shape[0]
    dout_c = dout.to(feats.dtype).contiguous()
    wt = weight.flip(0).transpose(1, 2)             # wt[a] = W[26-a]^T
    rtile = _pack_rtile(win)
    if k == 27 and _gather_route(win.sub, cin, cout):
        tile_sz = v // win.starts.shape[0]
        starts, sub_off, rb_local = _w27_active_slice(
            win.v_active, v, tile_sz, win.starts, win.sub_off, win.rb_local,
            win.sub)
        dx, dw3 = windowed_bwd_gather(
            dout_c, feats, starts.reshape(-1), sub_off.reshape(-1),
            rb_local.t(), wt, window=win.window, tile=tile_sz, sub=win.sub,
            subwin=win.subwin, flip_taps=True, need_dfeats=need_dfeats)
        dw = dw3.reshape(k * cin, cout) + _res_all_dw(
            feats, rtile, win.res_ovf, dout_c, k, flip=True)
        dfeats = _pad_active(dx, v) if need_dfeats else None
    else:
        dw = _w27_dw_any(feats, win.rb_local, win.starts, dout_c, win.window,
                         win.sub, win.subwin, win.sub_off, win.v_active)
        dw = dw + _res_all_dw(feats, rtile, win.res_ovf, dout_c, k)
        dfeats = (_w27_matmul_any(dout_c, win.rb_local, win.starts, wt,
                                  win.window, win.sub, win.subwin,
                                  win.sub_off, win.v_active)
                  if need_dfeats else None)
    if need_dfeats:
        dfeats = dfeats.to(feats.dtype) + _res_all_apply(
            dout_c, rtile, win.res_ovf, win.ovf_v, win.ovf_count,
            wt.reshape(k * cout, cin), cin).to(feats.dtype)
    return dfeats, dw.reshape(k, cin, cout).to(weight.dtype)


def _wg_backward(feats, weight, dout, wg_fwd, wg_bwd, need_dfeats):
    if wg_bwd is None:
        raise NotImplementedError("the backward of a windowed cross-level "
                                  "conv needs the transposed plan (wg_bwd)")
    k, cin, cout = weight.shape
    dout_c = dout.to(feats.dtype).contiguous()
    wt = weight.transpose(1, 2)                     # wt[a] = W[a]^T
    b_rb = wg_bwd.rb_local
    b_starts = (wg_bwd.starts[:, None] if wg_bwd.starts.dim() == 1
                else wg_bwd.starts)
    if _gather_route(wg_bwd.sub, cin, cout):
        dfeats, dw3 = windowed_bwd_gather(
            dout_c, feats, b_starts.reshape(-1), wg_bwd.sub_off.reshape(-1),
            b_rb.t(), wt, window=wg_bwd.window,
            tile=b_rb.shape[0] // b_starts.shape[0], sub=wg_bwd.sub,
            subwin=wg_bwd.subwin, flip_taps=False, need_dfeats=need_dfeats)
        dw = dw3.reshape(k * cin, cout) + _res_all_dw(
            feats, _pack_rtile(wg_bwd), wg_bwd.res_ovf, dout_c, k, flip=True,
            tap_flip=False)
    else:
        dw = _wg_dw_any(feats, wg_fwd.rb_local, wg_fwd.starts, dout_c,
                        wg_fwd.window, wg_fwd.sub, wg_fwd.subwin,
                        wg_fwd.sub_off)
        dw = dw + _res_all_dw(feats, _pack_rtile(wg_fwd), wg_fwd.res_ovf,
                              dout_c, k)
        dfeats = (_wg_matmul_any(dout_c, b_rb, b_starts, wt, wg_bwd.window,
                                 wg_bwd.sub, wg_bwd.subwin, wg_bwd.sub_off)
                  if need_dfeats else None)
    if need_dfeats:
        dfeats = dfeats.to(feats.dtype) + _res_all_apply(
            dout_c, _pack_rtile(wg_bwd), wg_bwd.res_ovf, wg_bwd.ovf_v,
            wg_bwd.ovf_count, wt.reshape(k * cout, cin), cin,
            out_len=b_rb.shape[0]).to(feats.dtype)
    return dfeats, dw.reshape(k, cin, cout).to(weight.dtype)


class _SubmConvW27(torch.autograd.Function):
    """Windowed submanifold conv with the kernel backward (the
    reference's ``_subm_conv_w27`` custom VJP)."""

    @staticmethod
    def forward(ctx, feats, weight, win):
        k, cin, cout = weight.shape
        out = _w27_matmul_any(feats, win.rb_local, win.starts, weight,
                              win.window, win.sub, win.subwin, win.sub_off,
                              win.v_active)
        out = out.to(feats.dtype) + _res_all_apply(
            feats, _pack_rtile(win), win.res_ovf, win.ovf_v, win.ovf_count,
            weight.reshape(k * cin, cout), cout).to(feats.dtype)
        ctx.save_for_backward(feats, weight)
        ctx.win = win
        return out

    @staticmethod
    def backward(ctx, dout):
        feats, weight = ctx.saved_tensors
        dfeats, dw = _subm_w27_backward(feats, weight, dout, ctx.win,
                                        ctx.needs_input_grad[0])
        return dfeats, dw, None


class _WGConv(torch.autograd.Function):
    """Windowed cross-level conv with the kernel backward (the
    reference's ``_wg_conv`` custom VJP)."""

    @staticmethod
    def forward(ctx, feats, weight, wg_fwd, wg_bwd):
        k, cin, cout = weight.shape
        out = _wg_matmul_any(feats, wg_fwd.rb_local, wg_fwd.starts, weight,
                             wg_fwd.window, wg_fwd.sub, wg_fwd.subwin,
                             wg_fwd.sub_off)
        out = out.to(feats.dtype) + _res_all_apply(
            feats, _pack_rtile(wg_fwd), wg_fwd.res_ovf, wg_fwd.ovf_v,
            wg_fwd.ovf_count, weight.reshape(k * cin, cout), cout,
            out_len=wg_fwd.rb_local.shape[0]).to(feats.dtype)
        ctx.save_for_backward(feats, weight)
        ctx.plans = (wg_fwd, wg_bwd)
        return out

    @staticmethod
    def backward(ctx, dout):
        feats, weight = ctx.saved_tensors
        dfeats, dw = _wg_backward(feats, weight, dout, *ctx.plans,
                                  ctx.needs_input_grad[0])
        return dfeats, dw, None, None


def subm_conv_apply(feats: torch.Tensor, rulebook: torch.Tensor,
                    weight: torch.Tensor, win=None) -> torch.Tensor:
    """Submanifold convolution: output sites == input sites.

    feats (V, Cin); rulebook (V, 27) (a placeholder at windowed levels);
    weight (27, Cin, Cout) -> (V, Cout) in feats' dtype.  ``win``
    (Windowed27) selects the windowed route and its kernel backward;
    the rulebook route is plain differentiable torch.
    """
    if win is not None and rulebook.shape[-1] == 27:
        return _SubmConvW27.apply(feats, weight, win)
    return _gather_matmul_impl(feats, rulebook, weight)


def strided_conv_apply(fine_feats: torch.Tensor, down_rb: torch.Tensor,
                       weight: torch.Tensor,
                       parent: Optional[torch.Tensor] = None,
                       child_offset: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Strided convolution fine -> coarse (filter == stride): down_rb
    (Vc, f^3) into the fine level, weight (f^3, Cin, Cout) -> (Vc, Cout).
    ``parent`` / ``child_offset`` serve the reference's backward only."""
    return _gather_matmul_impl(fine_feats, down_rb, weight)


def deconv_apply(coarse_feats: torch.Tensor, parent: torch.Tensor,
                 child_offset: torch.Tensor, weight: torch.Tensor,
                 fine_valid: Optional[torch.Tensor] = None,
                 down_rb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Transposed convolution coarse -> fine (filter == stride):
    fine[f] = coarse[parent[f]] @ W[child_offset[f]] -> (Vf, Cout)."""
    k, cin, cout = weight.shape
    cdt = coarse_feats.dtype
    g = _gather_rows(coarse_feats, parent).float()
    onehot = F.one_hot(child_offset.long().clamp(0, k - 1), k).float()
    z = (onehot[:, :, None] * g[:, None, :]).reshape(-1, k * cin)
    out = (z @ weight.to(cdt).float().reshape(k * cin, cout)).to(cdt)
    if fine_valid is not None:
        out = torch.where(fine_valid[:, None], out, torch.zeros_like(out))
    return out


def unpool(coarse_feats: torch.Tensor, parent: torch.Tensor,
           fine_valid: Optional[torch.Tensor] = None,
           down_rb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Copy the parent voxel's features to its children."""
    out = _gather_rows(coarse_feats, parent)
    if fine_valid is not None:
        out = torch.where(fine_valid[:, None], out, torch.zeros_like(out))
    return out


def wg_conv_apply(feats: torch.Tensor, weight: torch.Tensor, wg_fwd,
                  wg_bwd=None) -> torch.Tensor:
    """Cross-level conv through WindowedGather metadata.

    strided conv: ``wg_conv_apply(fine_feats, W, lvl.wg_down, lvl.wg_up)``
    deconv:       ``wg_conv_apply(coarse_feats, W, lvl.wg_up, lvl.wg_down)``
    with W (f^3, Cin, Cout) in child-offset tap order either way;
    ``wg_bwd`` (the transposed map) serves the backward only.
    """
    return _WGConv.apply(feats, weight, wg_fwd, wg_bwd)


def wg_unpool_apply(coarse_feats: torch.Tensor, wg_up,
                    wg_down=None) -> torch.Tensor:
    """Unpool coarse -> fine through WindowedGather metadata: the up
    rulebook with tap-tiled identity weights."""
    c = coarse_feats.shape[-1]
    k = wg_up.rb_local.shape[1]
    eye = torch.eye(c, dtype=coarse_feats.dtype,
                    device=coarse_feats.device).expand(k, c, c)
    return wg_conv_apply(coarse_feats, eye, wg_up)
