"""Windowed gather-GEMM kernels K1-K5 (CUDA, ``sm_90a``).

Twins of the reference's Pallas kernels in ``tdwss/ops/pallas_subm.py``,
with their argument contracts:

- K1 ``windowed_matmul_sub`` (two-level sub-window addressing) and K4
  ``windowed_matmul`` (flat window-local addressing), the forward:
  ``out[v] = sum_a x[src(v, a)] @ w[a]``, out in x's dtype;
- K3 ``windowed_dw_sub`` and its flat form K5 ``windowed_dw``, the
  weight gradient: ``dW[a] = sum_v x[src(v, a)]^T (x) dout[v]``, f32;
- K2 ``windowed_bwd_gather``, the fused backward over the cotangent:
  ``dfeats[v] = sum_a dout[src(v, a)] @ wt[a]`` (in dout's dtype) and
  ``dW[tau(a)] = sum_v feats[v]^T (x) dout[src(v, a)]`` (f32), with
  ``tau(a) = K-1-a`` (``flip_taps``, submanifold) or ``a`` (cross-level);

where ``src(v, a) = starts[tile(v), a % nwin] (+ soff[sub(v), a % nwin]
in the sub forms) + rb_local_t[a, v]`` and a local at or past the
sentinel (``subwin`` in the sub forms, ``window`` in the flat ones) adds
nothing.  Every product accumulates in f32.  The TPU lane padding
(``pad_w9``, the ``C3p`` axis) and lane packing are dropped: weights are
``(K, C, Cout)`` and dW comes back as ``(K, C, Cout)``.

A CUDA tensor launches the kernels in ``tdwss_torch/csrc/`` (K1/K4 in
``windowed_fwd.cu``, K2/K3/K5 in ``windowed_bwd.cu``; built with ``nvcc``
at first use into ``build/tdwss_torch/`` and bound with ctypes); a CPU
tensor takes the plain PyTorch version beside each.  There is no
fallback from a kernel to its plain version on the card.  ``launches``
counts kernel launches per kernel name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_DIR)
_CSRC = os.path.join(_PKG_DIR, "csrc")
SOURCES = {"fwd": os.path.join(_CSRC, "windowed_fwd.cu"),
           "bwd": os.path.join(_CSRC, "windowed_bwd.cu")}
HEADER = os.path.join(_CSRC, "windowed_common.cuh")
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "tdwss_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

K1 = "windowed_matmul_sub"
K2 = "windowed_bwd_gather"
K3 = "windowed_dw_sub"
K4 = "windowed_matmul"
K5 = "windowed_dw"
launches: Dict[str, int] = {K1: 0, K2: 0, K3: 0, K4: 0, K5: 0}

# dW partials: one block per (row chunk, C tile, Cout tile); enough
# chunks for ~4 blocks per SM of an H100 (132 SMs), at least 256 rows a
# chunk, at most 64 MiB of f32 partials.
_TARGET_BLOCKS = 4 * 132
_MIN_CHUNK_ROWS = 256
_PART_BYTES = 64 << 20

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGTYPES = {
    "tdwss_windowed_fwd": [
        _P, _I64, _I,            # x, v_src, c
        _P, _P, _P, _I64, _I64,  # starts, soff, rb, rb strides
        _P, _I, _I,              # w, k, cout
        _P, _I64,                # out, v_out
        _I, _I, _I, _I, _I, _P,  # tile, nwin, sub, sentinel, dtype, stream
    ],
    "tdwss_windowed_dw": [
        _P, _I64, _I,            # x, v_src, c
        _P, _P, _P, _I64, _I64,  # starts, soff, rb, rb strides
        _I, _P, _I, _I64,        # k, dout, cout, v_out
        _I, _I, _I, _I, _I,      # tile, nwin, sub, sentinel, nchunk
        _P, _P, _I, _P,          # part, dw, dtype, stream
    ],
    "tdwss_windowed_bwd_gather": [
        _P, _I64, _I,            # dout, v_src, cout
        _P, _P, _P, _I64, _I64,  # starts, soff, rb, rb strides
        _I, _P, _P, _I, _P,      # k, wt, feats, cin, dfeats
        _I64, _I, _I, _I, _I,    # v_out, tile, nwin, sub, sentinel
        _I, _I, _P, _P, _I, _P,  # flip, nchunk, part, dw, dtype, stream
    ],
}
_FUNCS = {"fwd": ("tdwss_windowed_fwd",),
          "bwd": ("tdwss_windowed_dw", "tdwss_windowed_bwd_gather")}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")


def lib_path(part: str = "fwd") -> str:
    """Path of the built library of ``part`` ("fwd" or "bwd"), hashed by
    its source, the shared header and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (SOURCES[part], HEADER):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libwindowed_{part}-{digest.hexdigest()[:12]}.so")


def build(part: str = "fwd") -> str:
    """Compile ``windowed_<part>.cu`` if its hashed .so is missing; returns
    the path.  ``ptxas`` register and shared-memory use goes to ``.log``."""
    path = lib_path(part)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCES[part]]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{res.stderr[-4000:]}")
    with open(path + ".log", "w") as f:
        f.write(res.stdout + res.stderr)
    os.replace(tmp, path)
    return path


def _load(part: str) -> ctypes.CDLL:
    with _lock:
        if part not in _libs:
            lib = ctypes.CDLL(build(part))
            for name in _FUNCS[part]:
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = _ARGTYPES[name]
            if part == "fwd":
                lib.tdwss_windowed_fwd_kmax.restype = ctypes.c_int
            _libs[part] = lib
        return _libs[part]


# ---------------------------------------------------------------------------
# Contract checks and the shared addressing
# ---------------------------------------------------------------------------


def _geometry(feats3, starts, soff, rb_local_t, tile, sub, window, subwin):
    """Validate the addressing arguments; returns (k, v_out, nwin)."""
    if feats3.dim() != 2 or rb_local_t.dim() != 2:
        raise ValueError("feats3 (V, C) and rb_local_t (K, V_out)")
    k, v_out = rb_local_t.shape
    if v_out % tile:
        raise ValueError(f"v_out {v_out} must be a multiple of tile {tile}")
    tiles = v_out // tile
    if tiles == 0 or starts.numel() % tiles:
        raise ValueError("starts must hold tiles * nwin entries")
    nwin = starts.numel() // tiles
    if nwin == 0 or k % nwin:
        raise ValueError(f"nwin {nwin} must divide the tap count {k}")
    if soff is not None:
        if tile % sub or subwin % 8 or subwin > window:
            raise ValueError("bad sub-window geometry")
        if soff.numel() != (v_out // sub) * nwin:
            raise ValueError("soff must hold (v_out / sub) * nwin entries")
    for name, t in (("starts", starts), ("soff", soff),
                    ("rb_local_t", rb_local_t)):
        if t is not None and t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    return k, v_out, nwin


def _check_w(w, k, c):
    if w.dim() != 3 or w.shape[0] != k or w.shape[1] != c:
        raise ValueError(f"w {tuple(w.shape)} must be (K={k}, C={c}, Cout)")


def _check_rows(name, t, rows):
    if t.dim() != 2 or t.shape[0] != rows:
        raise ValueError(f"{name} {tuple(t.shape)} must be ({rows}, C)")


def _sources(starts, soff, rb_local_t, tile, sub, sentinel, v_src):
    """(src (V_out, K) int64, ok (V_out, K) bool) of every (row, tap);
    ``src`` is 0 where ``ok`` is False."""
    k, v_out = rb_local_t.shape
    dev = rb_local_t.device
    tiles = v_out // tile
    nwin = starts.numel() // tiles
    g = torch.arange(k, device=dev) % nwin
    v = torch.arange(v_out, device=dev)
    base = starts.reshape(tiles, nwin).long()[v // tile][:, g]
    if soff is not None:
        base = base + soff.reshape(-1, nwin).long()[v // sub][:, g]
    loc = rb_local_t.t().long()
    src = base + loc
    ok = (loc >= 0) & (loc < sentinel) & (src >= 0) & (src < v_src)
    return torch.where(ok, src, torch.zeros_like(src)), ok


def _rb_strides(rb_local_t):
    k, v_out = rb_local_t.shape
    sk, sv = rb_local_t.stride()
    if not (sv == 1 and sk == v_out) and not (sk == 1 and sv == k):
        raise ValueError("rb_local_t must be (K, V_out) contiguous or the "
                         "transpose of a contiguous (V_out, K) array")
    return sk, sv


def _device_check(tensors, dtype):
    dev = tensors[0].device
    if any(t.device != dev for t in tensors if t is not None):
        raise ValueError("all arguments must lie on one device")
    if dtype not in _DTYPES:
        raise TypeError(f"dtype {dtype} not in {list(_DTYPES)}")


def _on_cpu(t) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def _nchunks(v_out, c, cout, k):
    """Row chunks of the dW partials (see the module constants)."""
    t = 32 if (c <= 32 and cout <= 32) else 64
    tiles = -(-c // t) * -(-cout // t)
    want = -(-_TARGET_BLOCKS // tiles)
    by_rows = max(1, v_out // _MIN_CHUNK_ROWS)
    by_mem = max(1, _PART_BYTES // (k * c * cout * 4))
    return max(1, min(want, by_rows, by_mem, v_out))


# ---------------------------------------------------------------------------
# K1 / K4: forward
# ---------------------------------------------------------------------------


def _plain(feats3, starts, soff, rb_local_t, w, tile, sub, sentinel):
    """Plain PyTorch version of K1/K4 (soff None = flat)."""
    src, ok = _sources(starts, soff, rb_local_t, tile, sub, sentinel,
                       feats3.shape[0])
    xf = feats3.float()
    wf = w.to(feats3.dtype).float()
    out = torch.zeros((src.shape[0], w.shape[-1]), dtype=torch.float32,
                      device=feats3.device)
    for a in range(src.shape[1]):
        out += (xf[src[:, a]] * ok[:, a, None]) @ wf[a]
    return out.to(feats3.dtype)


def windowed_matmul_sub_plain(feats3, starts, soff, rb_local_t, w, window,
                              tile, sub, subwin):
    """Plain version of K1 (same arguments as :func:`windowed_matmul_sub`)."""
    k, _, _ = _geometry(feats3, starts, soff, rb_local_t, tile, sub, window,
                        subwin)
    _check_w(w, k, feats3.shape[1])
    return _plain(feats3, starts, soff, rb_local_t, w, tile, sub, subwin)


def windowed_matmul_plain(feats3, starts, rb_local_t, w, window, tile):
    """Plain version of K4 (same arguments as :func:`windowed_matmul`)."""
    k, _, _ = _geometry(feats3, starts, None, rb_local_t, tile, 0, window, 0)
    _check_w(w, k, feats3.shape[1])
    return _plain(feats3, starts, None, rb_local_t, w, tile, 0, window)


def _launch(name, feats3, starts, soff, rb_local_t, w, tile, sub, sentinel,
            nwin):
    _device_check([feats3, starts, rb_local_t, w, soff], feats3.dtype)
    if not feats3.is_contiguous():
        raise ValueError("feats3 must be contiguous")
    k, v_out = rb_local_t.shape
    sk, sv = _rb_strides(rb_local_t)
    lib = _load("fwd")
    if k > lib.tdwss_windowed_fwd_kmax():
        raise ValueError(f"tap count {k} exceeds the kernel's limit")
    w = w.to(feats3.dtype).contiguous()
    starts = starts.contiguous()
    soff = soff.contiguous() if soff is not None else None
    out = torch.empty((v_out, w.shape[-1]), dtype=feats3.dtype,
                      device=feats3.device)
    stream = torch.cuda.current_stream(feats3.device).cuda_stream
    err = lib.tdwss_windowed_fwd(
        feats3.data_ptr(), feats3.shape[0], feats3.shape[1],
        starts.data_ptr(), soff.data_ptr() if soff is not None else None,
        rb_local_t.data_ptr(), sk, sv, w.data_ptr(), k, w.shape[-1],
        out.data_ptr(), v_out, tile, nwin, sub, sentinel,
        _DTYPES[feats3.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launches[name] += 1
    return out


def windowed_matmul_sub(feats3, starts, soff, rb_local_t, w, window, tile,
                        sub, subwin):
    """K1: two-level windowed gather-GEMM -> (V_out, Cout) in feats3's dtype.

    feats3 (V_src, C); starts (tiles * nwin,) int32; soff
    (tiles * (tile / sub) * nwin,) int32 sub-window offsets within the big
    window; rb_local_t (K, V_out) int32 relative to start + soff, sentinel
    >= subwin; w (K, C, Cout).
    """
    k, _, nwin = _geometry(feats3, starts, soff, rb_local_t, tile, sub,
                           window, subwin)
    _check_w(w, k, feats3.shape[1])
    if _on_cpu(feats3):
        return _plain(feats3, starts, soff, rb_local_t, w, tile, sub, subwin)
    return _launch(K1, feats3, starts, soff, rb_local_t, w, tile, sub,
                   subwin, nwin)


def windowed_matmul(feats3, starts, rb_local_t, w, window, tile):
    """K4: flat windowed gather-GEMM -> (V_out, Cout) in feats3's dtype.

    As :func:`windowed_matmul_sub` without sub-window offsets; locals are
    relative to the window start, sentinel >= window.
    """
    k, _, nwin = _geometry(feats3, starts, None, rb_local_t, tile, 0, window,
                           0)
    _check_w(w, k, feats3.shape[1])
    if _on_cpu(feats3):
        return _plain(feats3, starts, None, rb_local_t, w, tile, 0, window)
    return _launch(K4, feats3, starts, None, rb_local_t, w, tile, 0, window,
                   nwin)


# ---------------------------------------------------------------------------
# K3 / K5: weight gradient
# ---------------------------------------------------------------------------


def _plain_dw(feats3, starts, soff, rb_local_t, dout, tile, sub, sentinel):
    """Plain PyTorch version of K3/K5 (soff None = flat) -> (K, C, Cout)."""
    src, ok = _sources(starts, soff, rb_local_t, tile, sub, sentinel,
                       feats3.shape[0])
    xf = feats3.float()
    df = dout.to(feats3.dtype).float()
    k = src.shape[1]
    dw = torch.empty((k, xf.shape[1], df.shape[1]), dtype=torch.float32,
                     device=feats3.device)
    for a in range(k):
        dw[a] = (xf[src[:, a]] * ok[:, a, None]).t() @ df
    return dw


def _dw_args(feats3, starts, soff, rb_local_t, dout, window, tile, sub,
             subwin):
    k, v_out, nwin = _geometry(feats3, starts, soff, rb_local_t, tile, sub,
                               window, subwin)
    _check_rows("dout", dout, v_out)
    return k, v_out, nwin


def windowed_dw_sub_plain(feats3, starts, soff, rb_local_t, dout, window,
                          tile, sub, subwin):
    """Plain version of K3 (same arguments as :func:`windowed_dw_sub`)."""
    _dw_args(feats3, starts, soff, rb_local_t, dout, window, tile, sub,
             subwin)
    return _plain_dw(feats3, starts, soff, rb_local_t, dout, tile, sub,
                     subwin)


def windowed_dw_plain(feats3, starts, rb_local_t, dout, window, tile):
    """Plain version of K5 (same arguments as :func:`windowed_dw`)."""
    _dw_args(feats3, starts, None, rb_local_t, dout, window, tile, 0, 0)
    return _plain_dw(feats3, starts, None, rb_local_t, dout, tile, 0, window)


def _launch_dw(name, feats3, starts, soff, rb_local_t, dout, tile, sub,
               sentinel, nwin):
    _device_check([feats3, starts, rb_local_t, dout, soff], feats3.dtype)
    if not feats3.is_contiguous():
        raise ValueError("feats3 must be contiguous")
    k, v_out = rb_local_t.shape
    sk, sv = _rb_strides(rb_local_t)
    c, cout = feats3.shape[1], dout.shape[1]
    dout = dout.to(feats3.dtype).contiguous()
    starts = starts.contiguous()
    soff = soff.contiguous() if soff is not None else None
    nchunk = _nchunks(v_out, c, cout, k)
    part = torch.empty((nchunk, k, c, cout), dtype=torch.float32,
                       device=feats3.device)
    dw = torch.empty((k, c, cout), dtype=torch.float32, device=feats3.device)
    stream = torch.cuda.current_stream(feats3.device).cuda_stream
    err = _load("bwd").tdwss_windowed_dw(
        feats3.data_ptr(), feats3.shape[0], c, starts.data_ptr(),
        soff.data_ptr() if soff is not None else None, rb_local_t.data_ptr(),
        sk, sv, k, dout.data_ptr(), cout, v_out, tile, nwin, sub, sentinel,
        nchunk, part.data_ptr(), dw.data_ptr(), _DTYPES[feats3.dtype],
        stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launches[name] += 1
    return dw


def windowed_dw_sub(feats3, starts, soff, rb_local_t, dout, window, tile,
                    sub, subwin):
    """K3: two-level windowed dW -> (K, C, Cout) f32.

    feats3 (V_src, C) the gather source; dout (V_out, Cout) the cotangent
    (cast to feats3's dtype); addressing as :func:`windowed_matmul_sub`.
    """
    _, _, nwin = _dw_args(feats3, starts, soff, rb_local_t, dout, window,
                          tile, sub, subwin)
    if _on_cpu(feats3):
        return _plain_dw(feats3, starts, soff, rb_local_t, dout, tile, sub,
                         subwin)
    return _launch_dw(K3, feats3, starts, soff, rb_local_t, dout, tile, sub,
                      subwin, nwin)


def windowed_dw(feats3, starts, rb_local_t, dout, window, tile):
    """K5: flat windowed dW -> (K, C, Cout) f32 (K3 with flat locals)."""
    _, _, nwin = _dw_args(feats3, starts, None, rb_local_t, dout, window,
                          tile, 0, 0)
    if _on_cpu(feats3):
        return _plain_dw(feats3, starts, None, rb_local_t, dout, tile, 0,
                         window)
    return _launch_dw(K5, feats3, starts, None, rb_local_t, dout, tile, 0,
                      window, nwin)


# ---------------------------------------------------------------------------
# K2: fused backward over the cotangent
# ---------------------------------------------------------------------------


def _plain_bwd_gather(dout, feats, starts, soff, rb_local_t, wt, tile, sub,
                      subwin, flip_taps, need_dfeats):
    src, ok = _sources(starts, soff, rb_local_t, tile, sub, subwin,
                       dout.shape[0])
    v_out, k = src.shape
    df = dout.float()
    ff = feats[:v_out].to(dout.dtype).float()
    wf = wt.to(dout.dtype).float()
    dx = (torch.zeros((v_out, wt.shape[-1]), dtype=torch.float32,
                      device=dout.device) if need_dfeats else None)
    dw = torch.empty((k, ff.shape[1], df.shape[1]), dtype=torch.float32,
                     device=dout.device)
    for a in range(k):
        g = df[src[:, a]] * ok[:, a, None]
        if need_dfeats:
            dx += g @ wf[a]
        dw[k - 1 - a if flip_taps else a] = ff.t() @ g
    return (dx.to(dout.dtype) if need_dfeats else None), dw


def _bwd_gather_args(dout, feats, starts, soff, rb_local_t, wt, window, tile,
                     sub, subwin):
    k, v_out, nwin = _geometry(dout, starts, soff, rb_local_t, tile, sub,
                               window, subwin)
    if soff is None:
        raise ValueError("windowed_bwd_gather takes the sub form only")
    _check_w(wt, k, dout.shape[1])
    if feats.dim() != 2 or feats.shape[0] < v_out or (
            feats.shape[1] != wt.shape[2]):
        raise ValueError(f"feats {tuple(feats.shape)} must be (>= {v_out}, "
                         f"Cin={wt.shape[2]})")
    return k, v_out, nwin


def windowed_bwd_gather_plain(dout, feats, starts, soff, rb_local_t, wt,
                              window, tile, sub, subwin, flip_taps=True,
                              need_dfeats=True):
    """Plain version of K2 (same arguments as :func:`windowed_bwd_gather`)."""
    _bwd_gather_args(dout, feats, starts, soff, rb_local_t, wt, window, tile,
                     sub, subwin)
    return _plain_bwd_gather(dout, feats, starts, soff, rb_local_t, wt, tile,
                             sub, subwin, flip_taps, need_dfeats)


def windowed_bwd_gather(dout, feats, starts, soff, rb_local_t, wt, window,
                        tile, sub, subwin, flip_taps=True, need_dfeats=True):
    """K2: fused symmetric backward -> (dfeats (V_out, Cin) in dout's
    dtype, or None without ``need_dfeats``; dW (K, Cin, Cout) f32).

    dout (V_src, Cout) the cotangent, the gather source; feats
    (>= V_out, Cin) the primal rows (cast to dout's dtype); wt (K, Cout,
    Cin) the transposed weights of the dfeats product (subm: W[K-1-a]^T,
    cross-level: W[a]^T); addressing as :func:`windowed_matmul_sub`.
    ``flip_taps``: tap a's dW product lands in slot K-1-a (the 27-tap
    rulebook's flip symmetry) instead of a.
    """
    k, v_out, nwin = _bwd_gather_args(dout, feats, starts, soff, rb_local_t,
                                      wt, window, tile, sub, subwin)
    if _on_cpu(dout):
        return _plain_bwd_gather(dout, feats, starts, soff, rb_local_t, wt,
                                 tile, sub, subwin, flip_taps, need_dfeats)
    _device_check([dout, feats, starts, soff, rb_local_t, wt], dout.dtype)
    if not dout.is_contiguous():
        raise ValueError("dout must be contiguous")
    sk, sv = _rb_strides(rb_local_t)
    cout, cin = wt.shape[1], wt.shape[2]
    wt = wt.to(dout.dtype).contiguous()
    feats = feats[:v_out].to(dout.dtype).contiguous()
    starts = starts.contiguous()
    soff = soff.contiguous()
    nchunk = _nchunks(v_out, cin, cout, k)
    part = torch.empty((nchunk, k, cin, cout), dtype=torch.float32,
                       device=dout.device)
    dw = torch.empty((k, cin, cout), dtype=torch.float32, device=dout.device)
    dx = (torch.empty((v_out, cin), dtype=dout.dtype, device=dout.device)
          if need_dfeats else None)
    stream = torch.cuda.current_stream(dout.device).cuda_stream
    err = _load("bwd").tdwss_windowed_bwd_gather(
        dout.data_ptr(), dout.shape[0], cout, starts.data_ptr(),
        soff.data_ptr(), rb_local_t.data_ptr(), sk, sv, k, wt.data_ptr(),
        feats.data_ptr(), cin, dx.data_ptr() if dx is not None else None,
        v_out, tile, nwin, sub, subwin, int(flip_taps), nchunk,
        part.data_ptr(), dw.data_ptr(), _DTYPES[dout.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{K2} launch failed: cudaError {err}")
    launches[K2] += 1
    return dx, dw


# ---------------------------------------------------------------------------
# Work of each function, for its bound
# ---------------------------------------------------------------------------


def _live(starts, soff, rb_local_t, tile, sub, sentinel, v_src):
    src, ok = _sources(starts, soff, rb_local_t, tile, sub, sentinel, v_src)
    entries = int(ok.sum())
    src_rows = int(torch.unique(src[ok]).numel())
    out_rows = int(ok.any(dim=1).sum())
    meta = (rb_local_t.numel() * 4 + starts.numel() * 4
            + (soff.numel() * 4 if soff is not None else 0))
    return entries, src_rows, out_rows, meta


def work(feats3, starts, soff, rb_local_t, w, tile, sub, sentinel):
    """K1/K4: (bytes, flops) the function needs on these inputs: each
    distinct source row, rb, starts, offsets, w and the output moved
    once, and 2 * C * Cout operations per live (row, tap) entry."""
    entries, rows, _, meta = _live(starts, soff, rb_local_t, tile, sub,
                                   sentinel, feats3.shape[0])
    item = feats3.element_size()
    c, cout = w.shape[1], w.shape[2]
    v_out = rb_local_t.shape[1]
    nbytes = (rows * c * item + meta + w.numel() * item
              + v_out * cout * item)
    return nbytes, 2 * entries * c * cout


def work_dw(feats3, starts, soff, rb_local_t, dout, tile, sub, sentinel):
    """K3/K5: each distinct gathered row of feats3, each cotangent row
    with a live entry, the addressing and the f32 dW moved once; 2 * C *
    Cout operations per live entry."""
    entries, rows, out_rows, meta = _live(starts, soff, rb_local_t, tile,
                                          sub, sentinel, feats3.shape[0])
    item = feats3.element_size()
    k, c, cout = rb_local_t.shape[0], feats3.shape[1], dout.shape[1]
    nbytes = (rows * c * item + out_rows * cout * item + meta
              + k * c * cout * 4)
    return nbytes, 2 * entries * c * cout


def work_bwd_gather(dout, feats, starts, soff, rb_local_t, wt, tile, sub,
                    subwin, need_dfeats=True):
    """K2: each distinct gathered cotangent row, each primal row with a
    live entry, the addressing, wt, dfeats and the f32 dW moved once;
    2 * Cin * Cout operations per live entry for each of the two
    products (one without ``need_dfeats``)."""
    entries, rows, out_rows, meta = _live(starts, soff, rb_local_t, tile,
                                          sub, subwin, dout.shape[0])
    item = dout.element_size()
    k, cout, cin = wt.shape
    v_out = rb_local_t.shape[1]
    nbytes = (rows * cout * item + out_rows * cin * item + meta
              + k * cin * cout * 4)
    if need_dfeats:
        nbytes += wt.numel() * item + v_out * cin * item
    return nbytes, (2 if need_dfeats else 1) * 2 * entries * cin * cout
