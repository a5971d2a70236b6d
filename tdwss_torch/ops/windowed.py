"""Windowed gather-GEMM kernels K1-K6 and the spill kernels K8-K9 (CUDA,
``sm_90a``).

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
- K6 ``windowed_bwd_sub``, the fused backward over the primal's windows
  (sub form): ``dfeats[v] = sum_a dout[src(v, a)] @ wt[a]`` (in feats'
  dtype) and ``dW[a] = sum_v feats[src(v, a)]^T (x) dout[v]`` (f32), each
  source row resolved once for both products;

where ``src(v, a) = starts[tile(v), a % nwin] (+ soff[sub(v), a % nwin]
in the sub forms) + rb_local_t[a, v]`` and a local at or past the
sentinel (``subwin`` in the sub forms, ``window`` in the flat ones) adds
nothing.  Every product accumulates in f32.  The TPU lane padding
(``pad_w9``, the ``C3p`` axis) and lane packing are dropped: weights are
``(K, C, Cout)`` and dW comes back as ``(K, C, Cout)``.

Beside them, port-only (the reference evaluates the spill tiers in plain
jnp), K8 ``spill_apply`` and K9 ``spill_dw`` add a windowed plan's spill
entries (:class:`tdwss_torch.ops.plan.SpillOrder`) onto the windowed
result, ``out[o] += sum_e x[src_e] @ w[tap_e]`` over each owner's
entries, and onto the windowed dW, ``dW[slot(tap)] += sum_e left[l_e]^T
(x) right[r_e]``, each in one fixed order.

Every kernel K1-K6 has two bodies, chosen by the dtype (:func:`fwd_tile`,
:func:`bwd_tile`): bf16 runs on the tensor cores (K2's and K6's dfeats
on K1's body; every dW, K3/K5's included, on the tensor-core dW tile;
both in ``csrc/windowed_mma.cuh``), f32 on the CUDA cores;
``body_launches`` counts their launches per body.
A CUDA tensor launches the kernels in ``tdwss_torch/csrc/`` (K1/K4 in
``windowed_fwd.cu``, K2/K3/K5 in ``windowed_bwd.cu``, K6 in
``windowed_bwd_sub.cu``, K8/K9 in ``spill.cu``; built with ``nvcc``
at first use into ``build/tdwss_torch/`` and bound with ctypes); a CPU
tensor takes the plain PyTorch version beside each.  There is no
fallback from a kernel to its plain version on the card.  ``launches``
counts kernel launches per kernel name; while a torch profiler records,
each of the eight entries is the span ``tdwss.kernel.<entry>``
(:mod:`tdwss_torch.utils.profiling`).  ``build`` also compiles the
brick engine's block gather K7 (``block_gather.cu``, part ``"gather"``;
its wrapper and count are in ``tdwss_torch/ops/experimental/
block_gather.py``).
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

from tdwss_torch.utils import profiling

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_DIR)
_CSRC = os.path.join(_PKG_DIR, "csrc")
SOURCES = {"fwd": os.path.join(_CSRC, "windowed_fwd.cu"),
           "bwd": os.path.join(_CSRC, "windowed_bwd.cu"),
           "bwd_sub": os.path.join(_CSRC, "windowed_bwd_sub.cu"),
           "gather": os.path.join(_CSRC, "block_gather.cu"),
           "spill": os.path.join(_CSRC, "spill.cu")}
HEADERS = (os.path.join(_CSRC, "windowed_common.cuh"),
           os.path.join(_CSRC, "windowed_mma.cuh"))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "tdwss_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

K1 = "windowed_matmul_sub"
K2 = "windowed_bwd_gather"
K3 = "windowed_dw_sub"
K4 = "windowed_matmul"
K5 = "windowed_dw"
K6 = "windowed_bwd_sub"
K8 = "spill_apply"
K9 = "spill_dw"
# Most taps a rulebook may have (KMAX in csrc/windowed_common.cuh; the
# libraries report theirs, and the forward launch checks against it).
KMAX = 32
launches: Dict[str, int] = {K1: 0, K2: 0, K3: 0, K4: 0, K5: 0, K6: 0,
                            K8: 0, K9: 0}
# The two bodies of K1-K6: bf16 runs on the tensor cores (cp.async
# gathers, mma.sync; csrc/windowed_mma.cuh), f32 on the CUDA cores.  K8
# and K9 run on the CUDA cores in both dtypes.
# Launches are also counted per body, "<kernel>:<body>".
BODY_MMA, BODY_FMA = "mma", "fma"
body_launches: Dict[str, int] = {f"{k}:{b}": 0 for k in launches
                                 for b in (BODY_MMA, BODY_FMA)}
# The forward body's column tiles (windowed_mma.cuh derives the rest of
# its tiling from the tile); the tensor-core dW tile's sides.
_MMA_TILES = (32, 64, 128, 256)
_DW_MMA_SIDES = (32, 64)

# dW partials: one block per (row chunk, C tile, Cout tile); enough
# chunks for ~4 blocks per SM of an H100 (132 SMs), at least 256 rows a
# chunk, at most 64 MiB of f32 partials (the tiles from bwd_tile: the
# CUDA-core tile of K2's and K3/K5's f32 body, 32 x 32 or 64 x 64, or the
# tensor-core dW tile).
_TARGET_BLOCKS = 4 * 132
_MIN_CHUNK_ROWS = 256
_PART_BYTES = 64 << 20
# K6: its partials may take 256 MiB; its f32 body has one block per (row
# chunk, 32 input channels) with every output channel.
_SUB_TM = 32
_SUB_PART_BYTES = 256 << 20

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
        _I, _I, _I, _I, _P,      # tile, nwin, sub, sentinel, stream
    ],
    "tdwss_windowed_fwd_mma": [
        _P, _I64, _I,            # x, v_src, c
        _P, _P, _P, _I64, _I64,  # starts, soff, rb, rb strides
        _P, _I, _I, _I,          # w, ldw, k, cout
        _P, _I64,                # out, v_out
        _I, _I, _I, _I,          # tile, nwin, sub, sentinel
        _I, _P,                  # n_tile, stream
    ],
    "tdwss_windowed_dw": [
        _P, _I64, _I,            # x, v_src, c
        _P, _P, _P, _I64, _I64,  # starts, soff, rb, rb strides
        _I, _P, _I, _I64,        # k, dout, cout, v_out
        _I, _I, _I, _I, _I,      # tile, nwin, sub, sentinel, nchunk
        _P, _P, _I,              # part, dw, dtype
        _I, _I, _P,              # tm, tn, stream
    ],
    "tdwss_windowed_bwd_gather": [
        _P, _I64, _I,            # dout, v_src, cout
        _P, _P, _P, _I64, _I64,  # starts, soff, rb, rb strides
        _I, _P, _I, _P, _I, _P,  # k, wt, ldw, feats, cin, dfeats
        _I64, _I, _I, _I, _I,    # v_out, tile, nwin, sub, sentinel
        _I, _I, _P, _P, _I,      # flip, nchunk, part, dw, dtype
        _I, _I, _I, _P,          # tm, tn, n_tile, stream
    ],
    "tdwss_windowed_bwd_sub": [
        _P, _P, _I64, _I, _I,    # feats, dout, v_src, cin, cout
        _P, _P, _P, _I64, _I64,  # starts, soff, rb, rb strides
        _I, _P, _I, _P,          # k, wt, ldw, dfeats
        _I64, _I, _I, _I, _I,    # v_out, tile, nwin, sub, sentinel
        _I, _P, _P, _I,          # nchunk, part, dw, dtype
        _I, _I, _I, _P,          # tm, tn, n_tile, stream
    ],
    "tdwss_block_gather": [
        _P, _I64, _I64,          # src, n, row_bytes
        _P, _I64, _P, _I, _P,    # idx, m, out, vec_bytes, stream
    ],
    "tdwss_spill_apply": [
        _P, _I64, _I,            # x, n_src, cin
        _P, _P, _P, _I64,        # owner, start, entry, n_owner
        _P, _I, _I,              # w, k, cout
        _P, _I64, _I, _P,        # out, v_out, dtype, stream
    ],
    "tdwss_spill_dw": [
        _P, _I64, _I,            # left, n_left, cl
        _P, _I64, _I,            # right, n_right, cr
        _P, _I, _P, _I,          # rows, lcol, chunk, nchunk
        _P, _I, _I,              # tap_chunk, k, flip_taps
        _P, _P, _I, _P,          # part, dw, dtype, stream
    ],
}
_FUNCS = {"fwd": ("tdwss_windowed_fwd", "tdwss_windowed_fwd_mma"),
          "bwd": ("tdwss_windowed_dw", "tdwss_windowed_bwd_gather"),
          "bwd_sub": ("tdwss_windowed_bwd_sub",),
          "gather": ("tdwss_block_gather",),
          "spill": ("tdwss_spill_apply", "tdwss_spill_dw")}


def reset_launches() -> None:
    for counts in (launches, body_launches):
        for name in counts:
            counts[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")


def lib_path(part: str = "fwd") -> str:
    """Path of the built library of ``part`` (a key of ``SOURCES``),
    named after its source and hashed by the source, the shared headers
    and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (SOURCES[part], *HEADERS):
        with open(path, "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(os.path.basename(SOURCES[part]))[0]
    return os.path.join(BUILD_DIR,
                        f"lib{stem}-{digest.hexdigest()[:12]}.so")


def build(part: str = "fwd") -> str:
    """Compile the source of ``part`` if its hashed .so is missing; returns
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
            if part == "spill":
                lib.tdwss_spill_apply_max_cin.restype = ctypes.c_int
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


def _fma_dw_tile(c, cout):
    """The CUDA-core dW tile (``dw_block`` in windowed_bwd.cu: the f32
    body of K2 and K3/K5): 32 x 32 where both widths are at most 32, else
    64 x 64."""
    t = 32 if (c <= 32 and cout <= 32) else 64
    return {"tm": t, "tn": t}


def _nchunks(v_out, c, cout, k, tile=None, part_bytes=None):
    """Row chunks of the dW partials (see the module constants) for the
    blocks of ``tile`` (a :func:`bwd_tile` dict: ``tm`` x ``tn`` tiles of
    (C, Cout), or ``tm`` input channels with every output channel where
    it has no ``tn``); None is the CUDA-core tile of (C, Cout).  The
    partials' cap ``part_bytes`` defaults to ``_PART_BYTES`` as it is when
    called."""
    tile = tile or _fma_dw_tile(c, cout)
    tiles = -(-c // tile["tm"]) * (-(-cout // tile["tn"]) if "tn" in tile
                                   else 1)
    want = -(-_TARGET_BLOCKS // tiles)
    by_rows = max(1, v_out // _MIN_CHUNK_ROWS)
    by_mem = max(1, (part_bytes or _PART_BYTES) // (k * c * cout * 4))
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


def fwd_tile(c: int, cout: int, k: int, dtype) -> Dict[str, object]:
    """The forward's body for (C, Cout, K, dtype), as the wrapper launches
    it: ``body`` (BODY_MMA for bf16, BODY_FMA for f32); for the
    tensor-core body also ``n``, the column tile: the narrowest of 32,
    64, 128, 256 that covers Cout, else 256 in ceil(Cout / 256) tiles."""
    if dtype not in _DTYPES:
        raise TypeError(f"dtype {dtype} not in {list(_DTYPES)}")
    if dtype != torch.bfloat16:
        return {"body": BODY_FMA}
    n = next((t for t in _MMA_TILES if cout <= t), _MMA_TILES[-1])
    return {"body": BODY_MMA, "n": n}


def bwd_tile(kernel: str, cin: int, cout: int, k: int,
             dtype) -> Dict[str, object]:
    """The body and tiles of a backward kernel (K2, K3, K5 or K6) for
    (Cin, Cout, K, dtype), as the wrapper launches them and as the dW
    partials are sized; for K3/K5, Cin is the gathered x's width C.

    bf16: ``body`` BODY_MMA; ``tm`` x ``tn``, the tensor-core dW tile of
    (Cin, Cout), each side 32 where the width is at most 32, else 64; for
    K2 and K6 also ``n``, the dfeats column tile (K1's body over an output
    of width Cin: :func:`fwd_tile` of Cin).  f32: ``body`` BODY_FMA with
    the CUDA-core tiles: K2 and K3/K5 ``tm`` = ``tn`` = 32 where both
    widths are at most 32, else 64; K6 ``tm`` 32 input channels per block
    and ``slab``, the output channels per pass (64, 128 or 256)."""
    if kernel not in (K2, K3, K5, K6):
        raise ValueError(f"bwd_tile takes {K2}, {K3}, {K5} or {K6}, not "
                         f"{kernel}")
    if dtype not in _DTYPES:
        raise TypeError(f"dtype {dtype} not in {list(_DTYPES)}")
    if dtype == torch.bfloat16:
        tm, tn = (next((s for s in _DW_MMA_SIDES if w <= s),
                       _DW_MMA_SIDES[-1]) for w in (cin, cout))
        if kernel in (K3, K5):
            return {"body": BODY_MMA, "tm": tm, "tn": tn}
        return {"body": BODY_MMA, "n": fwd_tile(cout, cin, k, dtype)["n"],
                "tm": tm, "tn": tn}
    if kernel != K6:
        return {"body": BODY_FMA, **_fma_dw_tile(cin, cout)}
    slab = 64 if cout <= 64 else 128 if cout <= 128 else 256
    return {"body": BODY_FMA, "tm": _SUB_TM, "slab": slab}


def _weights(w, dtype, body):
    """Weights (K, rows, cols) as a body reads them, in ``dtype``: the
    tensor-core body's rows padded to a multiple of 8 columns (16-byte
    copies) on a 16-byte aligned base; returns (w, its row stride)."""
    w = w.to(dtype)
    cols = w.shape[2]
    if body != BODY_MMA:
        return w.contiguous(), cols
    ldw = -(-cols // 8) * 8
    if ldw != cols or not w.is_contiguous() or w.data_ptr() % 16:
        w = torch.nn.functional.pad(w, (0, ldw - cols)).contiguous()
    return w, ldw


def _check_mma_sizes(v_out, v_src, rb_local_t):
    if max(v_out, v_src, rb_local_t.numel()) >= 2 ** 31:
        raise ValueError("the tensor-core body takes 32-bit row and "
                         "rulebook indices")


def _launch(name, feats3, starts, soff, rb_local_t, w, tile, sub, sentinel,
            nwin):
    _device_check([feats3, starts, rb_local_t, w, soff], feats3.dtype)
    if not feats3.is_contiguous():
        raise ValueError("feats3 must be contiguous")
    k, v_out = rb_local_t.shape
    c, cout = feats3.shape[1], w.shape[-1]
    sk, sv = _rb_strides(rb_local_t)
    lib = _load("fwd")
    if k > lib.tdwss_windowed_fwd_kmax():
        raise ValueError(f"tap count {k} exceeds the kernel's limit")
    starts = starts.contiguous()
    soff = soff.contiguous() if soff is not None else None
    out = torch.empty((v_out, cout), dtype=feats3.dtype, device=feats3.device)
    stream = torch.cuda.current_stream(feats3.device).cuda_stream
    plan = fwd_tile(c, cout, k, feats3.dtype)
    soff_ptr = soff.data_ptr() if soff is not None else None
    w, ldw = _weights(w, feats3.dtype, plan["body"])
    if plan["body"] == BODY_MMA:
        _check_mma_sizes(v_out, feats3.shape[0], rb_local_t)
        err = lib.tdwss_windowed_fwd_mma(
            feats3.data_ptr(), feats3.shape[0], c, starts.data_ptr(),
            soff_ptr, rb_local_t.data_ptr(), sk, sv, w.data_ptr(), ldw, k,
            cout, out.data_ptr(), v_out, tile, nwin, sub, sentinel,
            plan["n"], stream)
    else:
        err = lib.tdwss_windowed_fwd(
            feats3.data_ptr(), feats3.shape[0], c, starts.data_ptr(),
            soff_ptr, rb_local_t.data_ptr(), sk, sv, w.data_ptr(), k, cout,
            out.data_ptr(), v_out, tile, nwin, sub, sentinel, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launches[name] += 1
    body_launches[f"{name}:{plan['body']}"] += 1
    return out


def windowed_matmul_sub(feats3, starts, soff, rb_local_t, w, window, tile,
                        sub, subwin):
    """K1: two-level windowed gather-GEMM -> (V_out, Cout) in feats3's dtype.

    feats3 (V_src, C); starts (tiles * nwin,) int32; soff
    (tiles * (tile / sub) * nwin,) int32 sub-window offsets within the big
    window; rb_local_t (K, V_out) int32 relative to start + soff, sentinel
    >= subwin; w (K, C, Cout).
    """
    with profiling.span("tdwss.kernel.windowed_matmul_sub"):
        k, _, nwin = _geometry(feats3, starts, soff, rb_local_t, tile, sub,
                               window, subwin)
        _check_w(w, k, feats3.shape[1])
        if _on_cpu(feats3):
            return _plain(feats3, starts, soff, rb_local_t, w, tile, sub,
                          subwin)
        return _launch(K1, feats3, starts, soff, rb_local_t, w, tile, sub,
                       subwin, nwin)


def windowed_matmul(feats3, starts, rb_local_t, w, window, tile):
    """K4: flat windowed gather-GEMM -> (V_out, Cout) in feats3's dtype.

    As :func:`windowed_matmul_sub` without sub-window offsets; locals are
    relative to the window start, sentinel >= window.
    """
    with profiling.span("tdwss.kernel.windowed_matmul"):
        k, _, nwin = _geometry(feats3, starts, None, rb_local_t, tile, 0,
                               window, 0)
        _check_w(w, k, feats3.shape[1])
        if _on_cpu(feats3):
            return _plain(feats3, starts, None, rb_local_t, w, tile, 0, window)
        return _launch(K4, feats3, starts, None, rb_local_t, w, tile, 0,
                       window, nwin)


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
    plan = bwd_tile(name, c, cout, k, feats3.dtype)
    if plan["body"] == BODY_MMA:
        _check_mma_sizes(v_out, feats3.shape[0], rb_local_t)
    dout = dout.to(feats3.dtype).contiguous()
    starts = starts.contiguous()
    soff = soff.contiguous() if soff is not None else None
    nchunk = _nchunks(v_out, c, cout, k, plan)
    part = torch.empty((nchunk, k, c, cout), dtype=torch.float32,
                       device=feats3.device)
    dw = torch.empty((k, c, cout), dtype=torch.float32, device=feats3.device)
    stream = torch.cuda.current_stream(feats3.device).cuda_stream
    err = _load("bwd").tdwss_windowed_dw(
        feats3.data_ptr(), feats3.shape[0], c, starts.data_ptr(),
        soff.data_ptr() if soff is not None else None, rb_local_t.data_ptr(),
        sk, sv, k, dout.data_ptr(), cout, v_out, tile, nwin, sub, sentinel,
        nchunk, part.data_ptr(), dw.data_ptr(), _DTYPES[feats3.dtype],
        plan["tm"], plan["tn"], stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launches[name] += 1
    body_launches[f"{name}:{plan['body']}"] += 1
    return dw


def windowed_dw_sub(feats3, starts, soff, rb_local_t, dout, window, tile,
                    sub, subwin):
    """K3: two-level windowed dW -> (K, C, Cout) f32.

    feats3 (V_src, C) the gather source; dout (V_out, Cout) the cotangent
    (cast to feats3's dtype); addressing as :func:`windowed_matmul_sub`.
    """
    with profiling.span("tdwss.kernel.windowed_dw_sub"):
        _, _, nwin = _dw_args(feats3, starts, soff, rb_local_t, dout, window,
                              tile, sub, subwin)
        if _on_cpu(feats3):
            return _plain_dw(feats3, starts, soff, rb_local_t, dout, tile, sub,
                             subwin)
        return _launch_dw(K3, feats3, starts, soff, rb_local_t, dout, tile,
                          sub, subwin, nwin)


def windowed_dw(feats3, starts, rb_local_t, dout, window, tile):
    """K5: flat windowed dW -> (K, C, Cout) f32 (K3 with flat locals)."""
    with profiling.span("tdwss.kernel.windowed_dw"):
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
    with profiling.span("tdwss.kernel.windowed_bwd_gather"):
        k, v_out, nwin = _bwd_gather_args(dout, feats, starts, soff,
                                          rb_local_t, wt, window, tile, sub,
                                          subwin)
        if _on_cpu(dout):
            return _plain_bwd_gather(dout, feats, starts, soff, rb_local_t, wt,
                                     tile, sub, subwin, flip_taps, need_dfeats)
        _device_check([dout, feats, starts, soff, rb_local_t, wt], dout.dtype)
        if not dout.is_contiguous():
            raise ValueError("dout must be contiguous")
        sk, sv = _rb_strides(rb_local_t)
        cout, cin = wt.shape[1], wt.shape[2]
        plan = bwd_tile(K2, cin, cout, k, dout.dtype)
        if plan["body"] == BODY_MMA:
            _check_mma_sizes(v_out, dout.shape[0], rb_local_t)
        wt, ldw = _weights(wt, dout.dtype, plan["body"])
        feats = feats[:v_out].to(dout.dtype).contiguous()
        starts = starts.contiguous()
        soff = soff.contiguous()
        nchunk = _nchunks(v_out, cin, cout, k, plan)
        part = torch.empty((nchunk, k, cin, cout), dtype=torch.float32,
                           device=dout.device)
        dw = torch.empty((k, cin, cout), dtype=torch.float32,
                         device=dout.device)
        dx = (torch.empty((v_out, cin), dtype=dout.dtype, device=dout.device)
              if need_dfeats else None)
        stream = torch.cuda.current_stream(dout.device).cuda_stream
        err = _load("bwd").tdwss_windowed_bwd_gather(
            dout.data_ptr(), dout.shape[0], cout, starts.data_ptr(),
            soff.data_ptr(), rb_local_t.data_ptr(), sk, sv, k, wt.data_ptr(),
            ldw, feats.data_ptr(), cin,
            dx.data_ptr() if dx is not None else None, v_out, tile, nwin, sub,
            subwin, int(flip_taps), nchunk, part.data_ptr(), dw.data_ptr(),
            _DTYPES[dout.dtype], plan["tm"], plan["tn"], plan.get("n", 0),
            stream)
        if err != 0:
            raise RuntimeError(f"{K2} launch failed: cudaError {err}")
        launches[K2] += 1
        body_launches[f"{K2}:{plan['body']}"] += 1
        return dx, dw


# ---------------------------------------------------------------------------
# K6: fused backward over the primal's windows (sub form)
# ---------------------------------------------------------------------------


def _plain_bwd_sub(feats, dout, starts, soff, rb_local_t, wt, tile, sub,
                   subwin, need_dfeats):
    src, ok = _sources(starts, soff, rb_local_t, tile, sub, subwin,
                       feats.shape[0])
    v_out, k = src.shape
    ff = feats.float()
    df = dout.to(feats.dtype).float()
    wf = wt.to(feats.dtype).float()
    dx = (torch.zeros((v_out, wt.shape[-1]), dtype=torch.float32,
                      device=feats.device) if need_dfeats else None)
    dw = torch.empty((k, ff.shape[1], df.shape[1]), dtype=torch.float32,
                     device=feats.device)
    for a in range(k):
        m = ok[:, a, None]
        if need_dfeats:
            dx += (df[src[:, a]] * m) @ wf[a]
        dw[a] = (ff[src[:, a]] * m).t() @ df[:v_out]
    return (dx.to(feats.dtype) if need_dfeats else None), dw


def _bwd_sub_args(feats, dout, starts, soff, rb_local_t, wt, window, tile,
                  sub, subwin):
    k, v_out, nwin = _geometry(feats, starts, soff, rb_local_t, tile, sub,
                               window, subwin)
    if soff is None:
        raise ValueError("windowed_bwd_sub takes the sub form only")
    cin = feats.shape[1]
    _check_rows("dout", dout, feats.shape[0])
    if wt.dim() != 3 or tuple(wt.shape) != (k, dout.shape[1], cin):
        raise ValueError(f"wt {tuple(wt.shape)} must be (K={k}, "
                         f"Cout={dout.shape[1]}, Cin={cin})")
    return k, v_out, nwin


def windowed_bwd_sub_plain(feats, dout, starts, soff, rb_local_t, wt,
                           window, tile, sub, subwin, need_dfeats=True):
    """Plain version of K6 (same arguments as :func:`windowed_bwd_sub`)."""
    _bwd_sub_args(feats, dout, starts, soff, rb_local_t, wt, window, tile,
                  sub, subwin)
    return _plain_bwd_sub(feats, dout, starts, soff, rb_local_t, wt, tile,
                          sub, subwin, need_dfeats)


def _nchunks_sub(v_out, cin, cout, k, tile):
    """Row chunks of K6's dW partials for the blocks of ``tile`` (its
    :func:`bwd_tile`; see the module constants)."""
    return _nchunks(v_out, cin, cout, k, tile, _SUB_PART_BYTES)


def windowed_bwd_sub(feats, dout, starts, soff, rb_local_t, wt, window,
                     tile, sub, subwin, need_dfeats=True):
    """K6: fused backward of a 27-tap subm conv over the primal's windows
    -> (dfeats (V_out, Cin) in feats' dtype, or None without
    ``need_dfeats``; dW (K, Cin, Cout) f32).

    feats (V_src, Cin) the primal rows and dout (V_src, Cout) the
    cotangent, both gathered at ``src(v, a)``; dout's first V_out rows are
    also the dense side of dW; wt (K, Cout, Cin) with wt[a] = W[K-1-a]^T;
    addressing as :func:`windowed_matmul_sub`.

    The reference (``tdwss/ops/pallas_subm.py::windowed_bwd_sub``) takes
    the channel concat ``src_cat = [feats | dout]`` lane-padded to
    ``L = _lane_pad(Cin + Cout)``, weights ``wt_full`` (K, L, Cin) that are
    zero outside the dout rows, and returns dW as (K, L, Cout) of which
    the caller keeps rows [:Cin].  Here the two sources stay apart,
    wt is (K, Cout, Cin) and dW comes back as (K, Cin, Cout): the same
    math without the TPU layout.
    """
    with profiling.span("tdwss.kernel.windowed_bwd_sub"):
        k, v_out, nwin = _bwd_sub_args(feats, dout, starts, soff, rb_local_t,
                                       wt, window, tile, sub, subwin)
        if _on_cpu(feats):
            return _plain_bwd_sub(feats, dout, starts, soff, rb_local_t, wt,
                                  tile, sub, subwin, need_dfeats)
        _device_check([feats, dout, starts, soff, rb_local_t, wt], feats.dtype)
        if not feats.is_contiguous():
            raise ValueError("feats must be contiguous")
        sk, sv = _rb_strides(rb_local_t)
        cin, cout = feats.shape[1], dout.shape[1]
        plan = bwd_tile(K6, cin, cout, k, feats.dtype)
        if plan["body"] == BODY_MMA:
            _check_mma_sizes(v_out, feats.shape[0], rb_local_t)
        dout = dout.to(feats.dtype).contiguous()
        wt, ldw = _weights(wt, feats.dtype, plan["body"])
        starts = starts.contiguous()
        soff = soff.contiguous()
        nchunk = _nchunks_sub(v_out, cin, cout, k, plan)
        part = torch.empty((nchunk, k, cin, cout), dtype=torch.float32,
                           device=feats.device)
        dw = torch.empty((k, cin, cout), dtype=torch.float32,
                         device=feats.device)
        dx = (torch.empty((v_out, cin), dtype=feats.dtype, device=feats.device)
              if need_dfeats else None)
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = _load("bwd_sub").tdwss_windowed_bwd_sub(
            feats.data_ptr(), dout.data_ptr(), feats.shape[0], cin, cout,
            starts.data_ptr(), soff.data_ptr(), rb_local_t.data_ptr(), sk, sv,
            k, wt.data_ptr(), ldw, dx.data_ptr() if dx is not None else None,
            v_out, tile, nwin, sub, subwin, nchunk, part.data_ptr(),
            dw.data_ptr(),
            _DTYPES[feats.dtype], plan["tm"],
            plan["tn"] if plan["body"] == BODY_MMA else plan["slab"],
            plan.get("n", 0), stream)
        if err != 0:
            raise RuntimeError(f"{K6} launch failed: cudaError {err}")
        launches[K6] += 1
        body_launches[f"{K6}:{plan['body']}"] += 1
        return dx, dw


# ---------------------------------------------------------------------------
# K8 / K9: the spill tiers (port-only)
# ---------------------------------------------------------------------------

def _spill_apply_args(feats, owner, start, entry, w, out):
    """Validate K8's arguments; returns its tap count (None: identity)."""
    if feats.dim() != 2 or out.dim() != 2:
        raise ValueError("feats (V_src, C) and out (V_out, Cout)")
    if owner.dim() != 1 or tuple(start.shape) != (owner.shape[0] + 1,):
        raise ValueError("owner (U,) and start (U + 1,)")
    if entry.dim() != 2 or entry.shape[1] != 2:
        raise ValueError(f"entry {tuple(entry.shape)} must be (E, 2)")
    for name, t in (("owner", owner), ("start", start), ("entry", entry)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if out.dtype != feats.dtype:
        raise TypeError(f"out {out.dtype} must be in feats' dtype "
                        f"{feats.dtype}")
    if w is None:
        if out.shape[1] != feats.shape[1]:
            raise ValueError("the identity needs Cout == C")
        return None
    _check_w(w, w.shape[0], feats.shape[1])
    if w.shape[2] != out.shape[1]:
        raise ValueError(f"w {tuple(w.shape)} and out {tuple(out.shape)} "
                         "disagree on Cout")
    return w.shape[0]


def _plain_spill_apply(feats, owner, start, entry, w, out):
    k = None if w is None else w.shape[0]
    src, tap = entry[:, 0].long(), entry[:, 1].long()
    ok = (src >= 0) & (src < feats.shape[0])
    if k is not None:
        ok &= (tap >= 0) & (tap < k)
    x = feats[torch.where(ok, src, torch.zeros_like(src))].float() * ok[
        :, None]
    if w is None:
        contrib = x
    else:
        wf = w.to(feats.dtype).float()
        contrib = torch.zeros((x.shape[0], wf.shape[-1]),
                              dtype=torch.float32, device=feats.device)
        for a in range(k):
            contrib += (x * (tap == a)[:, None]) @ wf[a]
    if not owner.shape[0]:
        return out
    # each owner's contributions summed in entry order: column by column
    # over its rows, a short owner's padding reading a zero row
    first, count = start[:-1].long(), (start[1:] - start[:-1]).long()
    col = torch.arange(int(count.max()), device=feats.device)
    idx = torch.where(col < count[:, None], first[:, None] + col,
                      torch.full_like(first[:, None], contrib.shape[0]))
    rows = torch.cat([contrib, contrib.new_zeros((1, contrib.shape[1]))])
    total = rows[idx[:, 0]]
    for j in range(1, idx.shape[1]):
        total = total + rows[idx[:, j]]
    o = owner.long()
    out[o] = out[o] + total.to(out.dtype)
    return out


def spill_apply_plain(feats, owner, start, entry, w, out):
    """Plain version of K8 (same arguments as :func:`spill_apply`)."""
    _spill_apply_args(feats, owner, start, entry, w, out)
    return _plain_spill_apply(feats, owner, start, entry, w, out)


def spill_apply(feats, owner, start, entry, w, out):
    """K8: a plan's spill entries added onto ``out`` in place -> ``out``.

    feats (V_src, C) the source rows; owner (U,), start (U + 1,) and entry
    (E, 2) [src, tap] int32, the entries of each owner (``SpillOrder``'s
    by-owner layout); w (K, C, Cout) cast to feats' dtype, or None for the
    identity (C == Cout); out (V_out, Cout) in feats' dtype.  Each owner's
    row gets ``T(out + T(sum))``, its entries' products summed in f32 in
    entry order (T the dtype); an entry whose source or tap is out of
    range adds nothing.
    """
    with profiling.span("tdwss.kernel.spill_apply"):
        k = _spill_apply_args(feats, owner, start, entry, w, out)
        if _on_cpu(feats):
            return _plain_spill_apply(feats, owner, start, entry, w, out)
        _device_check([feats, owner, start, entry, w, out], feats.dtype)
        if not (feats.is_contiguous() and out.is_contiguous()):
            raise ValueError("feats and out must be contiguous")
        lib = _load("spill")
        if feats.shape[1] > lib.tdwss_spill_apply_max_cin():
            raise ValueError(f"C {feats.shape[1]} exceeds K8's limit")
        if w is not None:
            w = w.to(feats.dtype).contiguous()
        err = lib.tdwss_spill_apply(
            feats.data_ptr(), feats.shape[0], feats.shape[1],
            owner.data_ptr(), start.data_ptr(), entry.data_ptr(),
            owner.shape[0], w.data_ptr() if w is not None else None,
            k if k is not None else KMAX, out.shape[1], out.data_ptr(),
            out.shape[0], _DTYPES[feats.dtype],
            torch.cuda.current_stream(feats.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{K8} launch failed: cudaError {err}")
        launches[K8] += 1
        body_launches[f"{K8}:{BODY_FMA}"] += 1
        return out


def _spill_dw_args(feats, dout, tap_entry, chunk, tap_chunk, dw):
    if feats.dim() != 2 or dout.dim() != 2:
        raise ValueError("feats (V, C) and dout (V', Cout)")
    if tap_entry.dim() != 2 or tap_entry.shape[1] != 2:
        raise ValueError(f"tap_entry {tuple(tap_entry.shape)} must be (E, 2)")
    if chunk.dim() != 2 or chunk.shape[1] != 2 or not chunk.shape[0]:
        raise ValueError(f"chunk {tuple(chunk.shape)} must be (NCH + 1, 2)")
    k = tap_chunk.shape[0] - 1
    if tuple(dw.shape) != (k, feats.shape[1], dout.shape[1]) or (
            dw.dtype != torch.float32):
        raise ValueError(f"dw {tuple(dw.shape)} {dw.dtype} must be f32 "
                         f"(K={k}, C={feats.shape[1]}, Cout={dout.shape[1]})")
    for name, t in (("tap_entry", tap_entry), ("chunk", chunk),
                    ("tap_chunk", tap_chunk)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    return k


def _plain_spill_dw(feats, dout, tap_entry, chunk, tap_chunk, dw, flip,
                    flip_taps):
    lcol = 1 if flip else 0
    lrow, rrow = tap_entry[:, lcol].long(), tap_entry[:, 1 - lcol].long()
    ok = ((lrow >= 0) & (lrow < feats.shape[0]) & (rrow >= 0)
          & (rrow < dout.shape[0]))[:, None]
    zero = torch.zeros_like(lrow)
    left = feats[torch.where(ok[:, 0], lrow, zero)].float() * ok
    right = dout[torch.where(ok[:, 0], rrow, zero)].to(
        feats.dtype).float() * ok
    heads = chunk[:, 0].long()
    if heads.shape[0] < 2:
        return dw
    # each chunk's partial: its rows, padded with zero rows to the longest
    # chunk, in one batched product
    longest = int((heads[1:] - heads[:-1]).max())
    pos = heads[:-1, None] + torch.arange(longest, device=dw.device)
    pos = torch.where(pos < heads[1:, None], pos,
                      torch.full_like(pos, left.shape[0]))
    lp = torch.cat([left, left.new_zeros((1, left.shape[1]))])[pos]
    rp = torch.cat([right, right.new_zeros((1, right.shape[1]))])[pos]
    part = torch.bmm(lp.transpose(1, 2), rp)
    # each tap's chunks summed tier by tier, the tiers' sums in tier order
    tiers = chunk[:, 1].tolist()
    first = tap_chunk.tolist()
    k = len(first) - 1
    for slot in range(k):
        a = k - 1 - slot if flip_taps else slot
        j0, j1 = first[a], first[a + 1]
        if j0 == j1:
            continue
        total, tier_sum = None, part[j0]
        for j in range(j0 + 1, j1):
            if tiers[j] != tiers[j - 1]:
                total = tier_sum if total is None else total + tier_sum
                tier_sum = part[j]
            else:
                tier_sum = tier_sum + part[j]
        dw[slot] += tier_sum if total is None else total + tier_sum
    return dw


def spill_dw_plain(feats, dout, tap_entry, chunk, tap_chunk, dw, flip=False,
                   flip_taps=False):
    """Plain version of K9 (same arguments as :func:`spill_dw`)."""
    _spill_dw_args(feats, dout, tap_entry, chunk, tap_chunk, dw)
    return _plain_spill_dw(feats, dout, tap_entry, chunk, tap_chunk, dw,
                           flip, flip_taps)


def spill_dw(feats, dout, tap_entry, chunk, tap_chunk, dw, flip=False,
             flip_taps=False):
    """K9: a plan's spill entries' weight gradient added onto ``dw`` in
    place -> ``dw``.

    feats (V, C) and dout (V', Cout) (cast to feats' dtype); tap_entry
    (E, 2) [src, owner], chunk (NCH + 1, 2) [first row, tier] and
    tap_chunk (K + 1,) int32 (``SpillOrder``'s by-tap layout); dw (K, C,
    Cout) f32.  An entry adds ``feats[src]^T (x) dout[owner]``, or with
    ``flip`` ``feats[owner]^T (x) dout[src]``, into slot ``tap``, or
    ``K-1-tap`` with ``flip_taps``; a chunk's entries are summed in order,
    a tap's chunks tier by tier in chunk order and the tiers' sums in
    tier order; an entry with a row out of range adds nothing.
    """
    with profiling.span("tdwss.kernel.spill_dw"):
        k = _spill_dw_args(feats, dout, tap_entry, chunk, tap_chunk, dw)
        if _on_cpu(feats):
            return _plain_spill_dw(feats, dout, tap_entry, chunk, tap_chunk,
                                   dw, flip, flip_taps)
        _device_check([feats, dout, tap_entry, chunk, tap_chunk, dw],
                      feats.dtype)
        if not (feats.is_contiguous() and dw.is_contiguous()):
            raise ValueError("feats and dw must be contiguous")
        dout = dout.to(feats.dtype).contiguous()
        nchunk = chunk.shape[0] - 1
        c, cout = feats.shape[1], dout.shape[1]
        part = torch.empty((nchunk, c, cout), dtype=torch.float32,
                           device=feats.device)
        err = _load("spill").tdwss_spill_dw(
            feats.data_ptr(), feats.shape[0], c, dout.data_ptr(),
            dout.shape[0], cout, tap_entry.data_ptr(), int(flip),
            chunk.data_ptr(), nchunk, tap_chunk.data_ptr(), k,
            int(flip_taps), part.data_ptr(), dw.data_ptr(),
            _DTYPES[feats.dtype],
            torch.cuda.current_stream(feats.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{K9} launch failed: cudaError {err}")
        launches[K9] += 1
        body_launches[f"{K9}:{BODY_FMA}"] += 1
        return dw


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


def work_bwd_sub(feats, dout, starts, soff, rb_local_t, wt, tile, sub,
                 subwin, need_dfeats=True):
    """K6: each distinct gathered row of feats, each cotangent row that is
    gathered or has a live entry, the addressing, wt, dfeats and the f32
    dW moved once; 2 * Cin * Cout operations per live entry for each of
    the two products (one without ``need_dfeats``)."""
    src, ok = _sources(starts, soff, rb_local_t, tile, sub, subwin,
                       feats.shape[0])
    entries = int(ok.sum())
    gathered = torch.unique(src[ok])
    live_rows = torch.nonzero(ok.any(dim=1)).reshape(-1)
    dout_rows = int(torch.unique(torch.cat([gathered, live_rows])).numel())
    meta = rb_local_t.numel() * 4 + starts.numel() * 4 + soff.numel() * 4
    item = feats.element_size()
    k, cout, cin = wt.shape
    v_out = rb_local_t.shape[1]
    nbytes = (int(gathered.numel()) * cin * item + dout_rows * cout * item
              + meta + k * cin * cout * 4)
    if need_dfeats:
        nbytes += wt.numel() * item + v_out * cin * item
    return nbytes, (2 if need_dfeats else 1) * 2 * entries * cin * cout


def work_spill_apply(feats, owner, entry, w, out):
    """K8: each distinct live source row, each owner's output row read and
    written, the entry lists and w moved once; 2 * C * Cout operations per
    live entry (none for the identity)."""
    src, tap = entry[:, 0].long(), entry[:, 1].long()
    ok = (src >= 0) & (src < feats.shape[0])
    if w is not None:
        ok &= (tap >= 0) & (tap < w.shape[0])
    item = feats.element_size()
    c, cout = feats.shape[1], out.shape[1]
    nbytes = (int(torch.unique(src[ok]).numel()) * c * item
              + 2 * owner.shape[0] * cout * item
              + (2 * owner.shape[0] + 1 + entry.numel()) * 4
              + (w.numel() * item if w is not None else 0))
    flops = 2 * int(ok.sum()) * c * cout if w is not None else 0
    return nbytes, flops


def work_spill_dw(feats, dout, tap_entry, chunk, tap_chunk, flip=False):
    """K9: each distinct live row of both operands, the entry lists and the
    f32 dW read and written once; 2 * C * Cout operations per live
    entry."""
    lcol = 1 if flip else 0
    lrow, rrow = tap_entry[:, lcol].long(), tap_entry[:, 1 - lcol].long()
    ok = ((lrow >= 0) & (lrow < feats.shape[0]) & (rrow >= 0)
          & (rrow < dout.shape[0]))
    item = feats.element_size()
    k = tap_chunk.shape[0] - 1
    c, cout = feats.shape[1], dout.shape[1]
    nbytes = (int(torch.unique(lrow[ok]).numel()) * c * item
              + int(torch.unique(rrow[ok]).numel()) * cout * item
              + (tap_entry.numel() + chunk.numel() + tap_chunk.numel()) * 4
              + 2 * k * c * cout * 4)
    return nbytes, 2 * int(ok.sum()) * c * cout
