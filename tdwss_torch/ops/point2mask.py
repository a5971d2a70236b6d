"""Differentiable point cloud -> 2D mask rendering (twin of
:mod:`tdwss.ops.point2mask`).

- :func:`projection`: points onto the plane of each (theta, phi) view;
- :func:`ball_query_2d`: for each query pixel, the first ``nsample``
  supports in index order among ``supports[:points_num]`` within
  ``radius`` (the reference CUDA kernel's scan order), -1 padded, through
  the reference's cumulative-count mask; the reference builds the dense
  (queries, supports) distance matrix, which at resolution 256 and 20k
  points is over 5 GB in f32, so the port takes the queries in chunks and
  scans, for each, only the supports of the x band the chunk can reach:
  the same indices;
- :func:`point2mask_module`: coordinates into the centred 80% of an
  (H, W) canvas, the top-2 class scores averaged over each pixel's
  neighbours, a softmax to a 2-channel mask; a pixel without neighbours
  (or with tied channels) is background [1, 0];
- :class:`Point2Mask` / :class:`Box2Mask` / :class:`Pixel2Mask`: the
  instance-label, GSS-box and image-alpha front ends.  Their
  per-instance crops and padding are host numpy; the rendering runs on
  the front end's device (``cuda`` unless the caller passes
  ``device="cpu"``).

Gradients reach ``features`` through autograd's gather backward.

The reference's compiled CPU program contracts ``sum((q - s) ** 2)``
into ``fma(dy, dy, dx * dx)``, and the canvas scaling into one fused
multiply-add too (:func:`canvas_coords`).  The port computes both fused
multiply-adds in f64, where the f32 products are exact, and rounds to
f32, as separate torch ops on every device: the card and the CPU find
the same hits at the radius, and the reference's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from tdwss_torch.device import resolve_device

# the ball query's queries per band, and (query, candidate) pairs per block
_QUERY_CHUNK = 4096
_CHUNK_ELEMS = 1 << 24


def projection(pc: torch.Tensor, theta: torch.Tensor, phi: torch.Tensor,
               r: float = 1.0) -> torch.Tensor:
    """Project (B, N, 3) points onto M view planes -> (B, M, N, 2)."""
    sint, cost = torch.sin(theta), torch.cos(theta)
    sinp, cosp = torch.sin(phi), torch.cos(phi)
    u = torch.stack([-sint, cost, torch.zeros_like(theta)], dim=-1)  # (M, 3)
    v = torch.stack([cost * sinp, sint * sinp, cosp], dim=-1)        # (M, 3)
    center = torch.stack([cost * cosp, sint * cosp, sinp], dim=-1) * r
    rel = pc[:, None, :, :] - center[None, :, None, :]               # B,M,N,3

    def dot(axis):
        a = axis[None, :, None, :]
        return rel[..., 0] * a[..., 0] + rel[..., 1] * a[..., 1] \
            + rel[..., 2] * a[..., 2]

    return torch.stack([dot(u), dot(v)], dim=-1)


def ball_query_2d(queries: torch.Tensor, supports: torch.Tensor,
                  radius: float, nsample: int,
                  points_num: Union[int, torch.Tensor]) -> torch.Tensor:
    """(P, 2) queries x (N, 2) supports -> (P, nsample) int32 indices,
    -1 where a row has fewer hits: the FIRST ``nsample`` hits in index
    order among ``supports[:points_num]``.

    The queries go in chunks of ``_QUERY_CHUNK``; each chunk scans only
    the candidates among ``supports[:points_num]`` whose x lies within
    ``radius + 1`` of the chunk's x range (their index order kept), and
    takes them in blocks of at most ``_CHUNK_ELEMS`` (query, candidate)
    pairs.  A support outside that band has ``dx * dx > radius**2``, so
    it is never a hit, and the cumulative count over the candidates
    gives each hit the rank it has among all supports."""
    p, n = queries.shape[0], supports.shape[0]
    dev = queries.device
    r2 = radius * radius
    in_range = torch.arange(n, device=dev) < points_num
    out = torch.full((p, nsample), -1, dtype=torch.int32, device=dev)
    for lo in range(0, p, _QUERY_CHUNK):
        q = queries[lo:lo + _QUERY_CHUNK]
        qx = q[:, 0]
        band = (in_range & (supports[:, 0] >= qx.min() - (radius + 1))
                & (supports[:, 0] <= qx.max() + (radius + 1)))
        cand = torch.nonzero(band).squeeze(1)
        if cand.numel() == 0:
            continue
        s = supports[cand]
        src = cand.to(torch.int32)
        rows = max(1, _CHUNK_ELEMS // cand.numel())
        for a in range(0, q.shape[0], rows):
            qq = q[a:a + rows]
            dx = qq[:, None, 0] - s[None, :, 0]
            dy = (qq[:, None, 1] - s[None, :, 1]).double()
            d2 = (dy * dy + (dx * dx).double()).to(torch.float32)
            hit = d2 <= r2                                    # (c, cand)
            rank = torch.cumsum(hit, dim=1, dtype=torch.int32)   # 1-based
            keep = hit & (rank <= nsample)
            slot = torch.where(keep, rank - 1,
                               torch.full_like(rank, nsample))
            part = torch.full((qq.shape[0], nsample + 1), -1,
                              dtype=torch.int32, device=dev)
            part.scatter_(1, slot.long(), src.expand(qq.shape[0], -1))
            out[lo + a:lo + a + qq.shape[0]] = part[:, :nsample]
    return out


def canvas_coords(coords: torch.Tensor, res: Tuple[int, int]
                  ) -> torch.Tensor:
    """(B, N, 2) coordinates scaled into the centred 80% of the (H, W)
    canvas (reference :90-93); the centre and scale carry no gradient.

    The reference writes ``(...) * 0.8 * p / 2 + 0.1 * p``.  Its compiled
    CPU program folds the constants in f32, ``k = (0.8 * p) / 2`` and
    ``b = 0.1 * p``, and contracts ``y * k + b`` into one fused
    multiply-add.  This computes that fused multiply-add in f64 (the
    product of two f32 values is exact there) and rounds the sum to f32,
    on every device, so the canvas positions, and the ball query's hits
    at the radius, are the reference's."""
    h, w = res
    cmax = coords.amax(dim=-2, keepdim=True)
    cmin = coords.amin(dim=-2, keepdim=True)
    center = ((cmax + cmin) / 2).detach()
    scale = (torch.clamp(cmax - cmin, min=1e-5) / 2).detach()
    p = torch.tensor([[h, w]], dtype=torch.float32, device=coords.device)
    k, b = (0.8 * p / 2).double(), (0.1 * p).double()
    y = ((coords - center) / scale + 1).double()
    return (y * k + b).to(torch.float32)


def pixel_samples(res: Tuple[int, int], device) -> torch.Tensor:
    """(H * W, 2) float32 pixel positions, row-major."""
    h, w = res
    xg, yg = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    return torch.stack([xg, yg], dim=-1).reshape(-1, 2).to(torch.float32)


def neighbours(coords: torch.Tensor, res: Tuple[int, int],
               points_num: torch.Tensor, radius: float, nsample: int
               ) -> torch.Tensor:
    """(B, H * W, nsample) int32: each pixel's ball query over each
    instance's canvas coordinates (:func:`point2mask_module`'s)."""
    canvas = canvas_coords(coords, res)
    samples = pixel_samples(res, coords.device)
    return torch.stack([
        ball_query_2d(samples, canvas[b], radius, nsample, points_num[b])
        for b in range(coords.shape[0])])


def masks_from_neighbours(idx: torch.Tensor, features: torch.Tensor,
                          res: Tuple[int, int]) -> torch.Tensor:
    """(B, H * W, S) neighbour indices and (B, N, C) scores -> (B, H, W, 2)
    soft masks: the top-2 scores (reference :105) averaged over the
    nonzero gathered entries of each channel (:111-115), a softmax, and
    background [1, 0] where the channels tie."""
    b, n, _ = features.shape
    # the reference's sort(...)[..., -2:], without sort's int64 indices
    pts = torch.topk(features, 2, dim=-1).values.flip(-1)            # B,N,2
    padded = torch.cat([pts, torch.zeros_like(pts[:, :1])], dim=1)   # B,N+1,2
    ids = torch.where(idx >= 0, idx, torch.full_like(idx, n)).long()
    g = torch.stack([padded[i][ids[i]] for i in range(b)])           # B,P,S,2
    occ = (g != 0).to(torch.float32).sum(dim=2)
    summed = g.sum(dim=2)
    avg = summed / torch.where(occ == 0, torch.ones_like(occ), occ)
    m = torch.softmax(avg, dim=-1)
    empty = (m[..., 0] == m[..., 1])[..., None]
    background = torch.zeros_like(m)
    background[..., 0] = 1
    m = torch.where(empty, background, m)
    return m.reshape(b, res[0], res[1], 2)


def point2mask_module(coords: torch.Tensor, features: torch.Tensor,
                      res: Tuple[int, int], points_num: torch.Tensor,
                      radius: float = 4.0, nsample: int = 3) -> torch.Tensor:
    """(B, N, 2) coords + (B, N, C) scores -> (B, H, W, 2) soft masks."""
    return masks_from_neighbours(
        neighbours(coords, res, points_num, radius, nsample), features, res)


def _pad_instances(coord_list, feat_list, counts, num_views):
    """Mean-pad ragged per-instance crops to a common size (ref :216-227)."""
    max_pt = max(int(c) for c in counts)
    coords_out, feats_out = [], []
    for crds, fts, cnt in zip(coord_list, feat_list, counts):
        cnt = int(cnt)
        if cnt < max_pt:
            pad_c = np.broadcast_to(
                crds.mean(axis=1, keepdims=True), (num_views, max_pt - cnt, 2))
            pad_f = np.broadcast_to(
                fts.mean(axis=0, keepdims=True), (max_pt - cnt, fts.shape[1]))
            crds = np.concatenate([crds, pad_c], axis=1)
            fts = np.concatenate([fts, pad_f], axis=0)
        coords_out.append(crds)
        feats_out.append(fts)
    return np.stack(coords_out), np.stack(feats_out), max_pt


def render_inputs(coords, feats, counts, num_views):
    """The padded (instance x view) inputs of :func:`point2mask_module`:
    coords (I * M, N, 2), feats (I * M, N, C), points_num (I * M,)."""
    crds, fts, _ = _pad_instances(coords, feats, counts, num_views)
    num_inst = crds.shape[0]
    crds = crds.reshape(num_inst * num_views, -1, 2)
    fts = np.repeat(fts, num_views, axis=0)
    pn = np.repeat(np.asarray(counts, np.int32), num_views)
    return crds, fts, pn


def _tensor(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device)


def _render(coords, feats, counts, num_views, res, radius, nsample, device):
    crds, fts, pn = render_inputs(coords, feats, counts, num_views)
    mask = point2mask_module(_tensor(crds, device, torch.float32),
                             _tensor(fts, device, torch.float32), res,
                             _tensor(pn, device), radius=radius,
                             nsample=nsample)
    return mask[..., 1:].repeat(1, 1, 1, 3) * 255


class _FrontEnd:
    def __init__(self, *, radius: float, nsample: int, device=None):
        self.radius = radius
        self.nsample = nsample
        self.device = resolve_device(device)

    def _project(self, xyz, theta, phi, r) -> np.ndarray:
        dev = self.device
        return projection(_tensor(xyz, dev, torch.float32),
                          _tensor(theta, dev, torch.float32),
                          _tensor(phi, dev, torch.float32), r).cpu().numpy()

    def _render(self, instances, num_views, res):
        coord_list, feat_list, counts = instances
        return _render(coord_list, feat_list, counts, num_views, res,
                       self.radius, self.nsample, self.device)


class Point2Mask(_FrontEnd):
    """Instance-label front end (ref :145-239): one mask per (instance,
    view)."""

    def instances(self, xyz, features, proposals, theta, phi, r=1.0
                  ) -> List[Tuple[list, list, list]]:
        """Per scene, (projected coords (M, n, 2), features (n, C), n) of
        each instance label, in label order."""
        pc_coords = self._project(xyz, theta, phi, r)
        out = []
        for coords, label, feats in zip(pc_coords, np.asarray(proposals),
                                        np.asarray(features)):
            coord_list, feat_list, counts = [], [], []
            for lab in np.unique(label):
                sel = label == lab
                coord_list.append(coords[:, sel])
                feat_list.append(feats[sel])
                counts.append(int(sel.sum()))
            out.append((coord_list, feat_list, counts))
        return out

    def __call__(self, xyz, features, proposals, res, theta, phi, r=1.0):
        if isinstance(res, int):
            res = (res, res)
        m = np.asarray(theta).shape[0]
        masks = [self._render(inst, m, res) for inst in self.instances(
            xyz, features, proposals, theta, phi, r)]
        return torch.cat(masks).permute(0, 3, 1, 2)


class Box2Mask(_FrontEnd):
    """GSS-box front end with purity / density filters (ref :305-385);
    boxes in the corner layout [min xyz, max xyz]."""

    def instances(self, xyz, features, boxes, theta, phi, r=1.0,
                  box_filter_bar: Optional[Dict[str, float]] = None
                  ) -> List[Tuple[list, list, list]]:
        """Per scene, (projected coords (M, n, 2), features (n, C), n) of
        each box that holds points and passes the filters (scenes with no
        such box are left out)."""
        box_filter_bar = box_filter_bar or {}
        purity_lwbnd = box_filter_bar.get("purity_lwbnd", 0.0)
        density_lwbnd = box_filter_bar.get("density_lwbnd", 0.0)
        pc_coords = self._project(xyz, theta, phi, r)
        xyz = np.asarray(xyz)
        features = np.asarray(features)
        label = features.argmax(-1)
        out = []
        for coords, boxpool, feats, pc, lab in zip(
                pc_coords, np.asarray(boxes), features, xyz, label):
            coord_list, feat_list, counts = [], [], []
            for box in boxpool:
                sel = np.all(pc <= box[3:6], -1) & np.all(pc >= box[:3], -1)
                num_pts = int(sel.sum())
                if num_pts == 0:
                    continue
                clab = lab[sel]
                vals, cnts = np.unique(clab, return_counts=True)
                box_label = vals[np.argmax(cnts)]
                volume = float(np.prod(box[3:6] - box[:3]))
                sel_pts = int((clab == box_label).sum())
                purity = sel_pts / num_pts
                density = num_pts / max(volume, 1e-9)
                if purity >= purity_lwbnd and density >= density_lwbnd:
                    coord_list.append(coords[:, sel])
                    feat_list.append(feats[sel])
                    counts.append(num_pts)
            if coord_list:
                out.append((coord_list, feat_list, counts))
        return out

    def __call__(self, xyz, features, boxes, res, theta, phi, r=1.0,
                 box_filter_bar: Optional[Dict[str, float]] = None):
        if isinstance(res, int):
            res = (res, res)
        m = np.asarray(theta).shape[0]
        masks = [self._render(inst, m, res) for inst in self.instances(
            xyz, features, boxes, theta, phi, r, box_filter_bar)]
        if not masks:
            return torch.zeros((0, 3) + tuple(res), dtype=torch.float32,
                               device=self.device)
        return torch.cat(masks).permute(0, 3, 1, 2)


class Pixel2Mask(_FrontEnd):
    """Image-alpha front end (ref :241-303): blur a binary mask."""

    def inputs(self, image) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(coords (B, N, 2), feats (B, N, 2), points_num (B,)) of the
        images' foreground pixels (channel 0 at 255), mean-padded."""
        coord_list, counts = [], []
        for img in np.asarray(image):
            fg = np.argwhere(img[..., 0] == 255).astype(np.float32) + 0.5
            coord_list.append(fg[None, :, :])           # one 'view'
            counts.append(fg.shape[0])
        feat_list = [
            np.stack([np.zeros(c), np.ones(c)], axis=-1).astype(np.float32)
            for c in counts]
        crds, fts, _ = _pad_instances(coord_list, feat_list, counts, 1)
        return crds[:, 0], fts, np.asarray(counts, np.int32)

    def __call__(self, image, res):
        if isinstance(res, int):
            res = (res, res)
        crds, fts, pn = self.inputs(image)
        dev = self.device
        mask = point2mask_module(
            _tensor(crds, dev, torch.float32), _tensor(fts, dev), res,
            _tensor(pn, dev), radius=self.radius, nsample=self.nsample)
        mask = mask + mask / math.e
        return mask[..., 1:].repeat(1, 1, 1, 3) * 255
