"""Kernel-point convolution ops (twin of :mod:`tdwss.models.kpconv.ops`).

Plain PyTorch in f32, as the reference's KPConv is plain XLA (gathers,
``einsum``, ``dot``) and reaches no Pallas kernel.  Everything is
static-shape: neighbour matrices are padded (N, nmax) int64/int32 with
the *shadow index == number of support rows*, which the gathers turn
into zero features or far-away (``SHADOW_COORD``) coordinates, as
``jnp.take(mode="fill")`` does in the reference.  An index below 0 is a
shadow too: it never wraps around to the last row (``jnp.take`` wraps
-1 .. -Ns; no pyramid produces one).

The arithmetic follows the reference's order: squared point-to-kernel
distances by the expansion ``|a|^2 + |b|^2 - 2ab`` (shadow terms are
~1e12; a direct difference rounds otherwise), the influence-weighted
aggregation as a batched (K, nmax) x (nmax, Cin) product per point, and
the kernel weights as one (N, K*Cin) x (K*Cin, Cout) product.  Where the
reference casts to f32, the port takes ``acc_dtype``: f32 for f32 and
bf16 inputs, f64 for f64 ones (a dtype the reference never runs).  The
deformable path computes the masked full width, as the reference does
(no ``new_max_neighb`` top-k repacking).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from tdwss_torch.models.layers import acc_dtype

SHADOW_COORD = 1e6


class KPConvAux(NamedTuple):
    """Side outputs needed by the deformable regularizer."""

    min_d2: Optional[torch.Tensor] = None        # (N, K) min sq dist
    deformed_kp: Optional[torch.Tensor] = None   # (N, K, 3)


def _take_fill(x: torch.Tensor, idx: torch.Tensor, fill: float
               ) -> torch.Tensor:
    """``x[idx]`` (x of shape (Ns, C)) with every index outside [0, Ns)
    reading ``fill``: one padding row appended and looked up.  The
    lookup is an embedding whose padding index is that row, so the
    backward drops the shadow entries instead of summing them all into
    one row (a third of a layer's neighbour slots can be shadows)."""
    n = x.shape[0]
    pad = x.new_full((1, x.shape[1]), fill)
    safe = torch.where((idx >= 0) & (idx < n), idx, n)
    return F.embedding(safe.long(), torch.cat([x, pad]), padding_idx=n)


def gather_coords(s_pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(Ns,3),(N,n) -> (N,n,3); shadow rows land at SHADOW_COORD."""
    return _take_fill(s_pts, idx, SHADOW_COORD)


def gather_feats(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(Ns,C),(N,n) -> (N,n,C); shadow rows read zeros."""
    return _take_fill(x, idx, 0.0)


def _sq_distances(rel: torch.Tensor, kp: torch.Tensor) -> torch.Tensor:
    """|rel - kp|^2 -> (N, n, K).

    rel: (N, n, 3) centred neighbours; kp: (K, 3) or (N, K, 3).
    """
    rel32 = rel.to(acc_dtype(rel.dtype))
    kp32 = kp.to(rel32.dtype)
    r2 = torch.sum(rel32 * rel32, dim=-1)                    # (N, n)
    k2 = torch.sum(kp32 * kp32, dim=-1)                      # (K,) or (N, K)
    if kp.dim() == 2:
        cross = torch.einsum("vnd,kd->vnk", rel32, kp32)
        k2 = k2[None, None, :]
    else:
        cross = torch.einsum("vnd,vkd->vnk", rel32, kp32)
        k2 = k2[:, None, :]
    return r2[:, :, None] + k2 - 2.0 * cross


def kp_influences(sq_distances: torch.Tensor, kp_extent: float,
                  influence: str, aggregation: str) -> torch.Tensor:
    """(N, n, K) sq distances -> (N, K, n) influence weights."""
    if influence == "constant":
        w = torch.ones_like(sq_distances)
    elif influence == "linear":
        # maximum, not clamp: at a tie both split the gradient in half,
        # as jnp.clip's does
        w = torch.maximum(1.0 - torch.sqrt(sq_distances) / kp_extent,
                          torch.zeros_like(sq_distances))
    elif influence == "gaussian":
        sigma = kp_extent * 0.3
        w = torch.exp(-sq_distances / (2.0 * sigma**2 + 1e-9))
    else:
        raise ValueError(f"unknown KP influence {influence!r}")
    if aggregation == "closest":
        nearest = torch.argmin(sq_distances, dim=-1)         # (N, n)
        w = w * F.one_hot(nearest, sq_distances.shape[-1]).to(w.dtype)
    elif aggregation != "sum":
        raise ValueError(f"unknown aggregation mode {aggregation!r}")
    return w.permute(0, 2, 1)                                # (N, K, n)


def kpconv_apply(
    q_pts: torch.Tensor,
    s_pts: torch.Tensor,
    neighb_inds: torch.Tensor,
    x: torch.Tensor,
    kernel_points: torch.Tensor,
    weights: torch.Tensor,
    *,
    kp_extent: float,
    influence: str = "linear",
    aggregation: str = "sum",
    offsets: Optional[torch.Tensor] = None,
    modulations: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, KPConvAux]:
    """Kernel-point convolution.

    q_pts (N,3) query points; s_pts (Ns,3) supports; neighb_inds (N,n)
    with shadow == Ns; x (Ns,Cin); kernel_points (K,3); weights
    (K,Cin,Cout).  Returns ((N,Cout) in x's dtype, aux).  Products take
    x's dtype's operands and accumulate in f32, as the reference's
    ``preferred_element_type``.
    """
    neighbors = gather_coords(s_pts, neighb_inds)            # (N, n, 3)
    rel = neighbors - q_pts[:, None, :]                      # centred

    if offsets is not None:
        deformed = kernel_points[None, :, :] + offsets       # (N, K, 3)
        sq = _sq_distances(rel, deformed)
        aux = KPConvAux(min_d2=torch.amin(sq, dim=1), deformed_kp=deformed)
    else:
        sq = _sq_distances(rel, kernel_points)
        aux = KPConvAux()

    all_weights = kp_influences(sq, kp_extent, influence, aggregation)
    neighb_x = gather_feats(x, neighb_inds)                  # (N, n, Cin)

    cdt, acc = x.dtype, acc_dtype(x.dtype)
    weighted = torch.einsum("vkn,vnc->vkc", all_weights.to(cdt).to(acc),
                            neighb_x.to(acc))                # (N, K, Cin)
    if modulations is not None:
        weighted = weighted * modulations[:, :, None]

    k, cin, cout = weights.shape
    out = (weighted.reshape(-1, k * cin).to(cdt).to(acc)
           @ weights.reshape(k * cin, cout).to(cdt).to(acc))
    return out.to(cdt), aux


def max_pool(x: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """Max over padded neighbourhoods; shadows read 0 (ties share the
    gradient, as ``jnp.max``'s)."""
    return torch.amax(gather_feats(x, inds), dim=1)


def closest_pool(x: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """Pool from the first (closest) neighbour."""
    return gather_feats(x, inds[:, 0])


def global_average(x: torch.Tensor, batch_ids: torch.Tensor,
                   valid: torch.Tensor, num_scenes: int) -> torch.Tensor:
    """Per-cloud mean over the valid rows."""
    ids = torch.where(valid, batch_ids.long(),
                      torch.full_like(batch_ids.long(), num_scenes))
    acc = acc_dtype(x.dtype)
    summed = torch.zeros((num_scenes + 1, x.shape[-1]), dtype=acc,
                         device=x.device).index_add(0, ids, x.to(acc))
    counts = torch.zeros((num_scenes + 1,), dtype=torch.int64,
                         device=x.device).index_add(
        0, ids, torch.ones_like(ids))
    mean = summed[:num_scenes] / torch.clamp(counts[:num_scenes], min=1
                                             )[:, None].to(acc)
    return mean.to(x.dtype)


def p2p_fitting_regularizer(min_d2s, deformed_kps, kp_extents, *,
                            repulse_extent: float,
                            deform_fitting_power: float) -> torch.Tensor:
    """Deformable-offset regularizer: the fitting term (normalised squared
    distance of each deformed kernel point to its closest input) and the
    repulsion between the deformed kernel points of one point.

    min_d2s: list of (N, K); deformed_kps: list of (N, K, 3);
    kp_extents: matching per-conv KP extents.
    """
    fitting = 0.0
    repulsive = 0.0
    for min_d2, dkp, ext in zip(min_d2s, deformed_kps, kp_extents):
        fitting = fitting + torch.mean(torch.abs(min_d2 / (ext**2)))
        locs = dkp / ext                                     # (N, K, 3)
        k = locs.shape[1]
        sq = torch.sum((locs[:, :, None, :] - locs[:, None, :, :].detach())
                       ** 2, dim=-1)
        d = torch.sqrt(torch.maximum(sq, sq.new_full((), 1e-12)))  # (N, K, K)
        mask = 1.0 - torch.eye(k, dtype=d.dtype, device=d.device)[None]
        rep = torch.minimum(d - repulse_extent, d.new_zeros(())) ** 2 * mask
        repulsive = repulsive + torch.mean(torch.sum(rep, dim=2)) / k
    total = 2.0 * fitting + repulsive
    return deform_fitting_power * total
