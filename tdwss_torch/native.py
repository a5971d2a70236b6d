"""ctypes binding to the framework-free C++ host planner.

The port compiles ``native/tdwss_native.cpp`` itself, with portable flags
(no ``-march=native``; ``-mfma`` where the host has it), into ``build/tdwss_torch/`` under a name keyed by
the source's hash, and never loads ``native/libtdwss_native.so``: that
file is untracked and may have been built for another host's CPU.

Every planner function returns ``None`` when the library is unavailable
or switched off (:func:`disabled`), and the callers in
:mod:`tdwss_torch.ops.host_plan` then take their numpy paths.  A caller
that must not fall back (the chip smoke run) calls :func:`require`,
which builds or raises.

The KPConv host ops (:func:`grid_subsample`, :func:`radius_neighbors`)
and :func:`region_grow` never fall back silently: they build the
library or raise, and run their numpy versions only inside
:func:`disabled`.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_REPO_ROOT, "native", "tdwss_native.cpp")
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "tdwss_torch")


def _fma_flags():
    """``-mfma`` on an x86-64 host whose CPU has FMA3.  The reference
    library builds with ``-march=native``, which contracts
    ``radius_neighbors``' squared distances into FMAs; without the same
    contraction, neighbours whose distances differ in the last bit come
    out in another order when a row overflows.

    Not ``-march=native`` itself: the library's file name is keyed on
    the source and the flags, and ``-march=native`` reads the same on
    every host, so a ``build/`` carried with a checkout to another CPU
    would load code built for the first one.  ``-mfma``, the part of it
    that changes a result, enters the key only where the host has it."""
    if platform.machine() not in ("x86_64", "AMD64"):
        return []
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((line for line in f if line.startswith("flags")),
                         "")
    except OSError:
        return []
    return ["-mfma"] if " fma" in flags else []


CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared", "-pthread",
             *_fma_flags()]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_enabled = True


def _lib_path() -> str:
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libtdwss_native-{digest.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the planner (if its hashed .so is missing); returns the path."""
    path = _lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, _SOURCE]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{res.stderr[-4000:]}")
    os.replace(tmp, path)           # atomic: concurrent builders agree
    return path


def _abi_ok(lib: ctypes.CDLL) -> bool:
    """The library's window alignment must match the planner's WIN_ALIGN."""
    from tdwss_torch.ops.host_plan import WIN_ALIGN

    if not hasattr(lib, "tdwss_win_align"):
        return False
    lib.tdwss_win_align.restype = ctypes.c_int32
    return int(lib.tdwss_win_align()) == WIN_ALIGN


def _open() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    if not _abi_ok(lib):
        raise RuntimeError(
            "tdwss_native win-align contract differs from "
            "tdwss_torch.ops.host_plan.WIN_ALIGN")
    lib.grid_subsample.restype = ctypes.c_int32
    lib.radius_neighbors.restype = None
    lib.region_grow.restype = ctypes.c_int32
    lib.subm_rulebook.restype = None
    lib.voxelize.restype = ctypes.c_int32
    lib.windowed_rb.restype = ctypes.c_int64
    lib.windowed_rb16.restype = ctypes.c_int64
    lib.subm_windowed_plan.restype = ctypes.c_int64
    lib.downsample_plan.restype = ctypes.c_int32
    return lib


def require() -> ctypes.CDLL:
    """Build and load the planner, or raise with the build error."""
    global _lib, _error
    with _lock:
        if _lib is None:
            _lib = _open()
            _error = None
        return _lib


def _load() -> Optional[ctypes.CDLL]:
    global _error
    if not _enabled:
        return None
    if _lib is not None:
        return _lib
    if _error is not None:
        return None
    try:
        return require()
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        _error = str(e)
        return None


def available() -> bool:
    return _load() is not None


def last_error() -> Optional[str]:
    return _error


@contextlib.contextmanager
def disabled():
    """Run the host planner's numpy reference paths in this block."""
    global _enabled
    prev = _enabled
    _enabled = False
    try:
        yield
    finally:
        _enabled = prev


def _i32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def _f32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def _p(a, ct=ctypes.c_int32):
    return a.ctypes.data_as(ctypes.POINTER(ct)) if a is not None else None


def subm_rulebook(coords: np.ndarray, valid: np.ndarray,
                  kernel_size: int = 3) -> Optional[np.ndarray]:
    """(V, k^3) submanifold rulebook by parallel hash probing, or None."""
    lib = _load()
    if lib is None or kernel_size % 2 == 0:
        return None
    coords = _i32(coords)
    valid_u8 = np.ascontiguousarray(valid, np.uint8)
    v = coords.shape[0]
    out = np.empty((v, kernel_size ** 3), np.int32)
    lib.subm_rulebook(_p(coords), _p(valid_u8, ctypes.c_uint8),
                      ctypes.c_int64(v), ctypes.c_int32(kernel_size),
                      _p(out))
    return out


def voxelize(coords: np.ndarray, valid: np.ndarray, num_voxels: int,
             feats: Optional[np.ndarray] = None):
    """Key-sorted dedup of (x,y,z,b) coords.

    Returns (vox_coords, key_hi, key_lo, vox_valid, counts, num_valid,
    point2voxel, vox_feats or None, sorted_order), or None.
    """
    lib = _load()
    if lib is None:
        return None
    coords = _i32(coords)
    valid_u8 = np.ascontiguousarray(valid, np.uint8)
    n = coords.shape[0]
    v = int(num_voxels)
    fdim = 0 if feats is None else int(feats.shape[1])
    feats_f = (np.ascontiguousarray(feats, np.float32)
               if feats is not None else None)
    vox_coords = np.empty((v, 4), np.int32)
    key_hi = np.empty((v,), np.int32)
    key_lo = np.empty((v,), np.int32)
    vox_valid = np.empty((v,), np.uint8)
    counts = np.empty((v,), np.int32)
    p2v = np.empty((n,), np.int32)
    vox_feats = np.empty((v, fdim), np.float32) if feats is not None else None
    order = np.empty((n,), np.int32)
    num_valid = lib.voxelize(
        _p(coords), _p(valid_u8, ctypes.c_uint8), ctypes.c_int64(n),
        ctypes.c_int32(v), _p(feats_f, ctypes.c_float), ctypes.c_int32(fdim),
        _p(vox_coords), _p(key_hi), _p(key_lo),
        _p(vox_valid, ctypes.c_uint8), _p(counts), _p(p2v),
        _p(vox_feats, ctypes.c_float), _p(order))
    return (vox_coords, key_hi, key_lo, vox_valid.astype(bool), counts,
            np.int32(num_valid), p2v, vox_feats, order)


def downsample_plan(coords: np.ndarray, valid: np.ndarray, num_voxels: int,
                    filter_size: int, stride: int):
    """Fused strided-downsample plan from a key-sorted fine grid.

    Returns (vox_coords, key_hi, key_lo, vox_valid, counts, num_valid,
    parent, child_offset, down_rb, rb_up), or None.
    """
    lib = _load()
    if lib is None or filter_size != stride:
        return None
    coords = _i32(coords)
    valid_u8 = np.ascontiguousarray(valid, np.uint8)
    vf = coords.shape[0]
    vc = int(num_voxels)
    k = filter_size ** 3
    vox_coords = np.empty((vc, 4), np.int32)
    key_hi = np.empty((vc,), np.int32)
    key_lo = np.empty((vc,), np.int32)
    vox_valid = np.empty((vc,), np.uint8)
    counts = np.empty((vc,), np.int32)
    parent = np.empty((vf,), np.int32)
    child_offset = np.empty((vf,), np.int32)
    down_rb = np.empty((vc, k), np.int32)
    rb_up = np.empty((vf, k), np.int32)
    num_valid = lib.downsample_plan(
        _p(coords), _p(valid_u8, ctypes.c_uint8), ctypes.c_int64(vf),
        ctypes.c_int32(vc), ctypes.c_int32(filter_size),
        ctypes.c_int32(stride), _p(vox_coords), _p(key_hi), _p(key_lo),
        _p(vox_valid, ctypes.c_uint8), _p(counts), _p(parent),
        _p(child_offset), _p(down_rb), _p(rb_up))
    return (vox_coords, key_hi, key_lo, vox_valid.astype(bool), counts,
            np.int32(num_valid), parent, child_offset, down_rb, rb_up)


def windowed_rb(rb: np.ndarray, tile: int, window: int, nwin: int,
                sub: int, subwin: int, e_cap: int,
                v_src: Optional[int] = None):
    """(starts, sub_off | None, rb_local, spills (n, 3) v-sorted) for a
    fixed window, or None.  rb_local is int16 whenever the window fits."""
    lib = _load()
    if lib is None:
        return None
    rb = _i32(rb)
    v, k = rb.shape
    if v_src is None:
        v_src = v
    tiles = v // tile
    use16 = window < 32768
    starts = np.empty((tiles, nwin), np.int32)
    sub_off = np.empty((v // sub, nwin), np.int32) if sub else None
    rb_local = np.empty((v, k), np.int16 if use16 else np.int32)
    e_cap = max(int(e_cap), 1)
    spills = np.empty((e_cap, 3), np.int32)
    fn = lib.windowed_rb16 if use16 else lib.windowed_rb
    args = (
        _p(rb), ctypes.c_int64(v), ctypes.c_int64(int(v_src)),
        ctypes.c_int32(k), ctypes.c_int32(tile), ctypes.c_int32(window),
        ctypes.c_int32(nwin), ctypes.c_int32(sub), ctypes.c_int32(subwin),
        _p(starts), _p(sub_off),
        _p(rb_local, ctypes.c_int16 if use16 else ctypes.c_int32),
        _p(spills),
    )
    total = fn(*args, ctypes.c_int64(e_cap))
    if total > e_cap:
        spills = np.empty((int(total), 3), np.int32)
        fn(*args[:-1], _p(spills), ctypes.c_int64(int(total)))
    return starts, sub_off, rb_local, spills[: int(total)]


def subm_windowed_plan(coords: np.ndarray, valid: np.ndarray, tile: int,
                       window: int, nwin: int, sub: int, subwin: int,
                       e_cap: int):
    """Fused 27-tap windowed plan straight from key-sorted coords, or None.

    Returns (starts, sub_off | None, rb_local int16, spills v-sorted).
    """
    lib = _load()
    if lib is None or window >= 32768:
        return None
    coords = _i32(coords)
    valid_u8 = np.ascontiguousarray(valid, np.uint8)
    v = coords.shape[0]
    tiles = v // tile
    starts = np.empty((tiles, nwin), np.int32)
    sub_off = np.empty((v // sub, nwin), np.int32) if sub else None
    rb_local = np.empty((v, 27), np.int16)
    e_cap = max(int(e_cap), 1)
    spills = np.empty((e_cap, 3), np.int32)
    args = (
        _p(coords), _p(valid_u8, ctypes.c_uint8), ctypes.c_int64(v),
        ctypes.c_int32(tile), ctypes.c_int32(window), ctypes.c_int32(nwin),
        ctypes.c_int32(sub), ctypes.c_int32(subwin), _p(starts),
        _p(sub_off), _p(rb_local, ctypes.c_int16), _p(spills),
    )
    total = lib.subm_windowed_plan(*args, ctypes.c_int64(e_cap))
    if total > e_cap:
        spills = np.empty((int(total), 3), np.int32)
        lib.subm_windowed_plan(*args[:-1], _p(spills),
                               ctypes.c_int64(int(total)))
    return starts, sub_off, rb_local, spills[: int(total)]


def _host_op_lib() -> Optional[ctypes.CDLL]:
    """The library for a host op with no planner fallback: ``None``
    inside :func:`disabled`, else built and loaded or raised."""
    return require() if _enabled else None


def grid_subsample(points: np.ndarray, features: Optional[np.ndarray] = None,
                   labels: Optional[np.ndarray] = None,
                   cell_size: float = 0.1):
    """Voxel-grid barycentre pooling (KPConv grid_subsampling): the mean
    point, the mean features and the majority label of each cell.

    Returns (points (M, 3), features (M, F) or None, labels (M,) or None).
    """
    n = points.shape[0]
    lib = _host_op_lib() if n > 0 else None
    if lib is None:
        return _grid_subsample_np(points, features, labels, cell_size)
    fdim = features.shape[1] if features is not None else 0
    feat = _f32(features) if features is not None else None
    lab = _i32(labels) if labels is not None else None
    out_p = np.empty((n, 3), np.float32)
    out_f = np.empty((n, fdim), np.float32) if features is not None else None
    out_l = np.empty((n,), np.int32) if labels is not None else None
    m = lib.grid_subsample(
        _p(_f32(points), ctypes.c_float), ctypes.c_int64(n),
        _p(feat, ctypes.c_float), ctypes.c_int32(fdim), _p(lab),
        ctypes.c_float(cell_size), _p(out_p, ctypes.c_float),
        _p(out_f, ctypes.c_float), _p(out_l))
    return (out_p[:m], out_f[:m] if out_f is not None else None,
            out_l[:m] if out_l is not None else None)


def _grid_subsample_np(points, features, labels, cell_size):
    """The numpy version of :func:`grid_subsample` (cells in sorted key
    order, not the library's first-seen order)."""
    if points.shape[0] == 0:
        return points, features, labels
    cells = np.floor(points / cell_size).astype(np.int64)
    _, inverse, counts = np.unique(cells, axis=0, return_inverse=True,
                                   return_counts=True)
    inverse = inverse.reshape(-1)
    m = counts.shape[0]
    out_p = np.zeros((m, 3), np.float64)
    np.add.at(out_p, inverse, points)
    out_p = (out_p / counts[:, None]).astype(np.float32)
    out_f = None
    if features is not None:
        out_f = np.zeros((m, features.shape[1]), np.float64)
        np.add.at(out_f, inverse, features)
        out_f = (out_f / counts[:, None]).astype(np.float32)
    out_l = None
    if labels is not None:
        out_l = np.full(m, -100, np.int32)
        for j in range(m):
            vals, cnt = np.unique(labels[inverse == j], return_counts=True)
            out_l[j] = vals[np.argmax(cnt)]
    return out_p, out_f, out_l


def radius_neighbors(queries: np.ndarray, supports: np.ndarray,
                     radius: float, max_neighbors: int = 64) -> np.ndarray:
    """(Nq, max_neighbors) int32 indices of the supports within
    ``radius`` of each query, -1 padded (KPConv batch_neighbors; the
    closest are kept on overflow)."""
    nq, ns = queries.shape[0], supports.shape[0]
    lib = _host_op_lib()
    if lib is None:
        return _radius_neighbors_np(queries, supports, radius, max_neighbors)
    out = np.empty((nq, max_neighbors), np.int32)
    lib.radius_neighbors(
        _p(_f32(queries), ctypes.c_float), ctypes.c_int64(nq),
        _p(_f32(supports), ctypes.c_float), ctypes.c_int64(ns),
        ctypes.c_float(radius), ctypes.c_int32(max_neighbors), _p(out))
    return out


def _radius_neighbors_np(queries, supports, radius, max_neighbors):
    """The scipy version of :func:`radius_neighbors` (its own order)."""
    from scipy.spatial import cKDTree

    out = np.full((queries.shape[0], max_neighbors), -1, np.int32)
    tree = cKDTree(supports)
    for i, idx in enumerate(tree.query_ball_point(queries, radius)):
        idx = np.asarray(idx, np.int64)
        if idx.shape[0] > max_neighbors:
            d = np.linalg.norm(supports[idx] - queries[i], axis=1)
            idx = idx[np.argsort(d)[:max_neighbors]]
        out[i, : idx.shape[0]] = idx
    return out


def region_grow(points: np.ndarray, normals: np.ndarray, k: int = 12,
                max_dist: float = 0.05, max_angle_deg: float = 20.0,
                min_region: int = 50, cell_size: Optional[float] = None):
    """Plane-fitting region growing (CGAL shape-detection parity):
    (region id per point, -1 unassigned; number of regions)."""
    n = points.shape[0]
    if cell_size is None:
        # ~k points per cell on surface-like data
        extent = float(points.max(0).min() - points.min(0).min() + 1e-6)
        cell_size = max(extent / max(np.cbrt(n), 1.0) * 2.0, max_dist * 2,
                        1e-3)
    lib = _host_op_lib() if n > 0 else None
    if lib is None:
        return _region_grow_np(points, normals, k, max_dist, max_angle_deg,
                               min_region)
    out = np.empty(n, np.int32)
    num = lib.region_grow(
        _p(_f32(points), ctypes.c_float), _p(_f32(normals), ctypes.c_float),
        ctypes.c_int64(n), ctypes.c_int32(k), ctypes.c_float(max_dist),
        ctypes.c_float(max_angle_deg), ctypes.c_int32(min_region),
        ctypes.c_float(cell_size), _p(out))
    return out, int(num)


def _region_grow_np(points, normals, k, max_dist, max_angle_deg,
                    min_region):
    """The numpy version of :func:`region_grow` (the reference's
    ``tdwss.native._region_grow_np``): breadth-first growth from each
    unassigned point in index order over its k nearest neighbours (scipy's
    ``cKDTree``), gated by the normal's angle and the distance to the
    region's running plane; regions under ``min_region`` points are
    undone."""
    from scipy.spatial import cKDTree

    n = points.shape[0]
    tree = cKDTree(points)
    _, knn = tree.query(points, k=min(k + 1, n))
    knn = knn[:, 1:]
    cos_thresh = np.cos(np.deg2rad(max_angle_deg))
    region = np.full(n, -1, np.int32)
    num = 0
    for seed in range(n):
        if region[seed] != -1:
            continue
        members = [seed]
        region[seed] = num
        normal = normals[seed].astype(np.float64).copy()
        centroid = points[seed].astype(np.float64).copy()
        head = 0
        while head < len(members):
            cur = members[head]
            head += 1
            for nb in knn[cur]:
                if region[nb] != -1:
                    continue
                nlen = np.linalg.norm(normal) + 1e-12
                dot = float(normals[nb] @ normal) / nlen
                if abs(dot) < cos_thresh:
                    continue
                dist = abs(float((points[nb] - centroid / len(members))
                                 @ normal) / nlen)
                if dist > max_dist:
                    continue
                region[nb] = num
                members.append(int(nb))
                centroid += points[nb]
                normal += np.sign(dot) * normals[nb]
        if len(members) < min_region:
            region[np.asarray(members)] = -1
        else:
            num += 1
    return region, num
