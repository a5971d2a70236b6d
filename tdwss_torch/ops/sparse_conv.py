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
  the rulebook forms for levels without windowed metadata, and of the
  plans-free branch (plain torch: the rulebook gather-GEMM with a
  backward of its own, :class:`_RulebookConv`; the rest differentiable
  as written).
- :func:`gather_neighbors`, :func:`max_pool` and :func:`avg_pool` are
  the reference's plain gathers over a rulebook (no model calls them;
  plain torch, as the reference's are plain XLA).

Windows and spill tiers together are an exact cover of the rulebook, so
every route computes ``out[v] = sum_k feats[rb[v, k]] @ W[k]``.  The
windowed subm and cross-level convs are ``torch.autograd.Function``s
whose backward runs K2 (fused dfeats + dW) or K3/K5 (dW) with K1/K4 on
the cotangent (dfeats), plus the spill tiers' dW and dfeats (see
"Backward routes" below).  Every pass adds a plan's spill tiers onto the
windowed result with one kernel over the plan's ``spill_order``: K8
(``spill_apply``) for a forward or a dfeats, K9 (``spill_dw``) for a dW.
On a CUDA tensor every windowed evaluation launches its kernel; on a CPU
tensor the same calls run the kernels' plain versions.

A ``-1`` rulebook entry means "no neighbour": every gather here masks it
(torch indexing, like numpy, would wrap it to the last row).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from tdwss_torch.ops.plan import spill_order
from tdwss_torch.ops.windowed import (spill_apply, spill_dw,
                                     windowed_bwd_gather, windowed_bwd_sub,
                                     windowed_dw, windowed_dw_sub,
                                     windowed_matmul, windowed_matmul_sub)
from tdwss_torch.utils import profiling

def _gather_rows(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats[idx] along dim 0 with out-of-range (incl. negative) ids
    reading zeros (``jnp.take(..., mode="fill", fill_value=0)``)."""
    n = feats.shape[0]
    ok = (idx >= 0) & (idx < n)
    g = feats[torch.where(ok, idx, torch.zeros_like(idx)).long()]
    return g * ok.reshape(ok.shape + (1,) * (g.dim() - ok.dim())).to(g.dtype)


def gather_neighbors(feats: torch.Tensor, rulebook: torch.Tensor
                     ) -> torch.Tensor:
    """(V, Cin), (Vo, K) -> (Vo, K*Cin); a missing neighbour (-1, or an
    entry >= V) reads zeros."""
    return _gather_rows(feats, rulebook).reshape(rulebook.shape[0], -1)


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


class _RulebookConv(torch.autograd.Function):
    """:func:`_gather_matmul_impl` with a backward that keeps only the
    features, the rulebook and the weight: dW[k] = feats[rb[:, k]]^T dout
    (rounded to the features' dtype, as autograd through the forward's
    cast of W rounds it), and dfeats[s] = sum of dout[v] @ W[k]^T over
    the entries rb[v, k] == s, added in f32 by ``index_add_`` (a missing
    entry into a dump row that is sliced off).  Autograd through the
    forward would keep each tap's gathered (V, Cin) f32 rows: 27 copies
    of the input per subm conv."""

    @staticmethod
    def forward(ctx, feats, rulebook, weight):
        ctx.save_for_backward(feats, rulebook, weight)
        return _gather_matmul_impl(feats, rulebook, weight)

    @staticmethod
    def backward(ctx, dout):
        feats, rb, weight = ctx.saved_tensors
        n, k = feats.shape[0], rb.shape[1]
        d = dout.float()
        dfeats = dw = None
        if ctx.needs_input_grad[2]:
            dw = torch.stack([_gather_rows(feats, rb[:, a]).float().t() @ d
                              for a in range(k)])
            dw = dw.to(feats.dtype).to(weight.dtype)
        if ctx.needs_input_grad[0]:
            w = weight.to(feats.dtype).float()
            acc = torch.zeros((n + 1, feats.shape[1]), dtype=torch.float32,
                              device=feats.device)
            for a in range(k):
                idx = rb[:, a]
                idx = torch.where((idx >= 0) & (idx < n), idx,
                                  torch.full_like(idx, n))
                acc.index_add_(0, idx.long(), d @ w[a].t())
            dfeats = acc[:n].to(feats.dtype)
        return dfeats, None, dw


# ---------------------------------------------------------------------------
# Spill tiers: the rulebook entries the windows miss, as (owner, tap, src).
# Every pass adds all of a plan's tiers with one kernel over the plan's
# ``spill_order`` (the host planner's layout of the tiers): K8 for a
# forward or a dfeats (:func:`_spill_add`), K9 for a dW (:func:`_spill_dw`);
# on a CPU tensor they run their plain versions.  A dW with ``flip``
# evaluates each entry in the flipped orientation, feats[owner] (x)
# dout[src] into slot K-1-tap (slot tap with ``tap_flip=False``, the
# cross-level maps, whose tap is the child offset in both directions).
# K2's windowed dW covers the flip of the windowed entry set, so the spill
# set must be flipped too for the union to cover the rulebook exactly once.
# ---------------------------------------------------------------------------


def _layout(plan, device):
    """The plan's :class:`~tdwss_torch.ops.plan.SpillOrder` on ``device``,
    built now on the host for a plan made without it."""
    so = plan.spill_order if plan.spill_order is not None else \
        spill_order(plan)
    if not isinstance(so.entry, torch.Tensor) or so.entry.device != device:
        so = so.to(device)
    return so


def _spill_add(feats, plan, w3, out):
    """``out`` (V_out, Cout) in feats' dtype plus the plan's spill tiers on
    ``feats`` with weights w3 (K, C, Cout), or the identity where w3 is
    None: one K8 pass, in place."""
    so = _layout(plan, feats.device)
    if so.entries:
        profiling.count("tdwss.conv.spill_entries", so.entries)
        spill_apply(feats, so.owner, so.start, so.entry, w3, out)
    return out


def _spill_dw(feats, dout, plan, dw, flip=False, tap_flip=True):
    """``dw`` (K, C, Cout) f32 plus the plan's spill tiers' dW: one K9
    pass, in place.  ``flip``: each entry (owner, tap, src) in the flipped
    orientation, feats[owner] (x) dout[src], into slot K-1-tap (slot tap
    with ``tap_flip=False``); see above."""
    so = _layout(plan, feats.device)
    if so.entries:
        profiling.count("tdwss.conv.spill_entries", so.entries)
        spill_dw(feats, dout, so.tap_entry, so.chunk, so.tap_chunk, dw,
                 flip=flip, flip_taps=flip and tap_flip)
    return dw


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
# runs flipped.  Otherwise a sub-form 27-tap subm conv takes K6, the
# fused backward over the primal's windows (``_w27_bwd_fused``,
# :955-1004), with the spill dW in the forward orientation, since K6's
# windowed dW covers the forward entry set.  Everything else (a flat
# plan, a cross-level conv over the width gate) takes K3 (sub) or K5
# (flat) for dW with the spill dW in the forward orientation, and K1 (or
# K4) on the cotangent for dfeats.  The spill tiers' dfeats are K8 on the
# cotangent on every route, their dW K9.  The reference's
# TPU-only gates are dropped: ``_use_pallas_kernel`` / ``_use_pallas_wg``
# (backend and ``_PALLAS_MIN_V``, :657-681, :1288-1300),
# ``_sub_vmem_fits`` (:711, :986), ``_gather_vmem_fits`` (:752), the lane
# packing ``_pack_p`` (K6 declines under packing, :975-983) and K6's
# lane-padding test ``_lane_pad(cin + cout) == _lane_pad(max(cin,
# cout))`` (:985), which keeps the TPU's concat inside one padding width
# and has no counterpart here, where feats and dout are not concatenated.
# The CPU takes the same routes as the card, with the plain versions.
# ---------------------------------------------------------------------------

_GATHER_MAX_C = 128


def _gather_route(sub, cin, cout) -> bool:
    return bool(sub) and cin <= _GATHER_MAX_C and cout <= _GATHER_MAX_C


def _subm_w27_backward(feats, weight, dout, win, need_dfeats):
    with profiling.span("tdwss.conv.backward"):
        k, cin, cout = weight.shape
        v = feats.shape[0]
        dout_c = dout.to(feats.dtype).contiguous()
        wt = weight.flip(0).transpose(1, 2)             # wt[a] = W[26-a]^T
        if k == 27 and win.sub:
            tile_sz = v // win.starts.shape[0]
            starts, sub_off, rb_local = _w27_active_slice(
                win.v_active, v, tile_sz, win.starts, win.sub_off,
                win.rb_local, win.sub)
            geo = dict(window=win.window, tile=tile_sz, sub=win.sub,
                       subwin=win.subwin, need_dfeats=need_dfeats)
            if _gather_route(win.sub, cin, cout):
                dx, dw3 = windowed_bwd_gather(
                    dout_c, feats, starts.reshape(-1), sub_off.reshape(-1),
                    rb_local.t(), wt, flip_taps=True, **geo)
            else:
                dx, dw3 = windowed_bwd_sub(
                    feats, dout_c, starts.reshape(-1), sub_off.reshape(-1),
                    rb_local.t(), wt, **geo)
            dw = _spill_dw(feats, dout_c, win, dw3,
                           flip=_gather_route(win.sub, cin, cout))
            dfeats = _pad_active(dx, v) if need_dfeats else None
        else:
            dw = _w27_dw_any(feats, win.rb_local, win.starts, dout_c,
                             win.window, win.sub, win.subwin, win.sub_off,
                             win.v_active)
            dw = _spill_dw(feats, dout_c, win, dw.view(k, cin, cout))
            dfeats = (_w27_matmul_any(dout_c, win.rb_local, win.starts, wt,
                                      win.window, win.sub, win.subwin,
                                      win.sub_off, win.v_active)
                      if need_dfeats else None)
        if need_dfeats:
            dfeats = _spill_add(dout_c, win, wt, dfeats.to(feats.dtype))
        return dfeats, dw.to(weight.dtype)


def _wg_backward(feats, weight, dout, wg_fwd, wg_bwd, need_dfeats):
    with profiling.span("tdwss.conv.backward"):
        if wg_bwd is None:
            raise NotImplementedError("the backward of a windowed "
                                      "cross-level conv needs the transposed "
                                      "plan (wg_bwd)")
        k, cin, cout = weight.shape
        dout_c = dout.to(feats.dtype).contiguous()
        wt = weight.transpose(1, 2)                     # wt[a] = W[a]^T
        b_rb = wg_bwd.rb_local
        b_starts = (wg_bwd.starts[:, None] if wg_bwd.starts.dim() == 1
                    else wg_bwd.starts)
        if _gather_route(wg_bwd.sub, cin, cout):
            dfeats, dw3 = windowed_bwd_gather(
                dout_c, feats, b_starts.reshape(-1),
                wg_bwd.sub_off.reshape(-1), b_rb.t(), wt, window=wg_bwd.window,
                tile=b_rb.shape[0] // b_starts.shape[0], sub=wg_bwd.sub,
                subwin=wg_bwd.subwin, flip_taps=False, need_dfeats=need_dfeats)
            dw = _spill_dw(feats, dout_c, wg_bwd, dw3, flip=True,
                           tap_flip=False)
        else:
            dw = _wg_dw_any(feats, wg_fwd.rb_local, wg_fwd.starts, dout_c,
                            wg_fwd.window, wg_fwd.sub, wg_fwd.subwin,
                            wg_fwd.sub_off)
            dw = _spill_dw(feats, dout_c, wg_fwd, dw.view(k, cin, cout))
            dfeats = (_wg_matmul_any(dout_c, b_rb, b_starts, wt, wg_bwd.window,
                                     wg_bwd.sub, wg_bwd.subwin, wg_bwd.sub_off)
                      if need_dfeats else None)
        if need_dfeats:
            dfeats = _spill_add(dout_c, wg_bwd, wt, dfeats.to(feats.dtype))
        return dfeats, dw.to(weight.dtype)


class _SubmConvW27(torch.autograd.Function):
    """Windowed submanifold conv with the kernel backward (the
    reference's ``_subm_conv_w27`` custom VJP)."""

    @staticmethod
    def forward(ctx, feats, weight, win):
        out = _w27_matmul_any(feats, win.rb_local, win.starts, weight,
                              win.window, win.sub, win.subwin, win.sub_off,
                              win.v_active)
        out = _spill_add(feats, win, weight, out.to(feats.dtype))
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
        out = _wg_matmul_any(feats, wg_fwd.rb_local, wg_fwd.starts, weight,
                             wg_fwd.window, wg_fwd.sub, wg_fwd.subwin,
                             wg_fwd.sub_off)
        out = _spill_add(feats, wg_fwd, weight, out.to(feats.dtype))
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
    the rulebook route is plain torch (:class:`_RulebookConv`).
    """
    if win is not None and rulebook.shape[-1] == 27:
        return _SubmConvW27.apply(feats, weight, win)
    return _RulebookConv.apply(feats, rulebook, weight)


def strided_conv_apply(fine_feats: torch.Tensor, down_rb: torch.Tensor,
                       weight: torch.Tensor,
                       parent: Optional[torch.Tensor] = None,
                       child_offset: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Strided convolution fine -> coarse (filter == stride): down_rb
    (Vc, f^3) into the fine level, weight (f^3, Cin, Cout) -> (Vc, Cout).
    ``parent`` / ``child_offset`` serve the reference's backward only."""
    return _RulebookConv.apply(fine_feats, down_rb, weight)


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


def max_pool(fine_feats: torch.Tensor, down_rb: torch.Tensor
             ) -> torch.Tensor:
    """scn.MaxPooling (filter == stride): the max over each coarse voxel's
    children in ``down_rb`` (Vc, f^3) -> (Vc, C).  A missing child reads
    the dtype's ``finfo.min`` and an output left at it (no live child
    above it) is 0.  ``torch.amax`` splits the gradient equally among
    tied maxima, as ``jnp.max``'s does (``torch.max(dim)`` would route
    it to one)."""
    neg = torch.finfo(fine_feats.dtype).min
    n = fine_feats.shape[0]
    live = ((down_rb >= 0) & (down_rb < n))[..., None]
    g = torch.where(live, _gather_rows(fine_feats, down_rb),
                    torch.full((), neg, dtype=fine_feats.dtype,
                               device=fine_feats.device))      # (Vc, K, C)
    out = torch.amax(g, dim=1)
    return torch.where(out == neg, torch.zeros_like(out), out)


def avg_pool(fine_feats: torch.Tensor, down_rb: torch.Tensor
             ) -> torch.Tensor:
    """scn.AveragePooling: the sum in f32 over each coarse voxel's
    gathered children divided by max(count, 1), where ``count`` counts
    the entries ``down_rb >= 0`` (an entry >= V counts and reads 0, as in
    the reference) -> (Vc, C) in the input's dtype."""
    g = _gather_rows(fine_feats, down_rb)
    cnt = (down_rb >= 0).float().sum(dim=1)
    summed = g.float().sum(dim=1)
    return (summed / cnt.clamp_min(1.0)[:, None]).to(fine_feats.dtype)


def wg_conv_apply(feats: torch.Tensor, weight: torch.Tensor, wg_fwd,
                  wg_bwd=None) -> torch.Tensor:
    """Cross-level conv through WindowedGather metadata.

    strided conv: ``wg_conv_apply(fine_feats, W, lvl.wg_down, lvl.wg_up)``
    deconv:       ``wg_conv_apply(coarse_feats, W, lvl.wg_up, lvl.wg_down)``
    with W (f^3, Cin, Cout) in child-offset tap order either way;
    ``wg_bwd`` (the transposed map) serves the backward only.
    """
    return _WGConv.apply(feats, weight, wg_fwd, wg_bwd)


def _identity_apply(feats, plan):
    """``plan``'s rulebook with tap-tiled identity weights: each output row
    is the sum of its live sources' rows (windows through K1 / K4, spill
    tiers through K8's identity form) -> (V_out, C) in feats' dtype."""
    c = feats.shape[-1]
    k = plan.rb_local.shape[1]
    eye = torch.eye(c, dtype=feats.dtype, device=feats.device).expand(k, c, c)
    out = _wg_matmul_any(feats, plan.rb_local, plan.starts, eye, plan.window,
                         plan.sub, plan.subwin, plan.sub_off)
    return _spill_add(feats, plan, None, out.to(feats.dtype))


class _WGUnpool(torch.autograd.Function):
    """Windowed unpool with its kernel backward (the reference's
    ``_wg_unpool`` custom VJP, tdwss/ops/sparse_conv.py:1566-1622).

    Forward: the up map with identity weights, out[f] = coarse[parent[f]]
    (each fine row has one live tap: the single f32 product by 1 is
    exact, so this is a gather bit for bit).  Backward: the down map
    (the transpose) with identity weights on the cotangent, dcoarse[c] =
    sum of its children's rows.  The identity is a constant, so no dW is
    computed (``_WGConv`` would run K2 / K3 for one).
    """

    @staticmethod
    def forward(ctx, coarse_feats, wg_up, wg_down):
        ctx.wg_down = wg_down
        return _identity_apply(coarse_feats, wg_up)

    @staticmethod
    def backward(ctx, dout):
        if ctx.wg_down is None:
            raise NotImplementedError("the backward of a windowed unpool "
                                      "needs the transposed plan (wg_down)")
        if not ctx.needs_input_grad[0]:
            return None, None, None
        return _identity_apply(dout.contiguous(), ctx.wg_down), None, None


def wg_unpool_apply(coarse_feats: torch.Tensor, wg_up,
                    wg_down=None) -> torch.Tensor:
    """Unpool coarse -> fine through WindowedGather metadata: the up
    rulebook with tap-tiled identity weights; ``wg_down`` (the transposed
    map) serves the backward only."""
    return _WGUnpool.apply(coarse_feats, wg_up, wg_down)
