"""Block gather K7: ``out[i] = src[clip(idx[i], 0, N-1)]`` over whole
blocks.

Twin of ``tdwss/ops/experimental/pallas_gather.py`` (the file is renamed
because no Pallas is left in it; the function names stay).  The
reference's ``dma_block_gather`` is a Pallas pipeline of DMA descriptors
for the brick engine's halo faces (each face of an 8^3 brick of C
channels is one (8, 8*C) block); here it is the CUDA kernel K7 in
``tdwss_torch/csrc/block_gather.cu``, built by
``tdwss_torch.ops.windowed.build("gather")`` at first use and bound with
ctypes.  A CUDA tensor launches K7 (no library gather, no fallback); a
CPU tensor takes the plain version, an ``index_select`` on the clipped
index.  ``launches`` counts K7's launches.

The index is clipped, not masked: an index past either end reads the
first or last block (unlike the windowed kernels' sentinels, which read
zero).  There is no backward: the reference defines none.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from tdwss_torch.ops import windowed

K7 = "dma_block_gather"
launches: Dict[str, int] = {K7: 0}

# The reference's grid step: ``len(idx)`` must be a multiple of it.
_STEP = 32


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _clipped(idx: torch.Tensor, n: int) -> torch.Tensor:
    """The index as int32 (as the reference casts it), clipped to [0, n)."""
    return idx.to(torch.int32).clamp(0, n - 1)


def _check_contract(src: torch.Tensor, idx: torch.Tensor) -> None:
    m = idx.shape[0]
    if m % _STEP != 0:
        raise ValueError(f"idx length {m} must be a multiple of {_STEP}")
    if src.dim() != 3 or src.shape[1] % 8 != 0:
        raise ValueError("src must be (N, 8k, W) tile-aligned blocks")


def _check_args(src: torch.Tensor, idx: torch.Tensor) -> None:
    if src.dim() < 1 or idx.dim() != 1:
        raise ValueError(f"src {tuple(src.shape)} must be (N, ...) and idx "
                         f"{tuple(idx.shape)} (M,)")
    if idx.dtype.is_floating_point or idx.dtype == torch.bool:
        raise TypeError(f"idx must be an integer tensor, got {idx.dtype}")
    if idx.device != src.device:
        raise ValueError("src and idx must lie on one device")
    if src.shape[0] == 0 and idx.shape[0]:
        raise ValueError("cannot gather from an empty src")


def _plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if idx.shape[0] == 0:
        return src.new_empty((0,) + tuple(src.shape[1:]))
    return src.index_select(0, _clipped(idx, src.shape[0]).long())


def _vec_bytes(*nums: int) -> int:
    """Widest copy (16, 8, 4, 2 or 1 bytes) that divides every number."""
    for w in (16, 8, 4, 2):
        if all(x % w == 0 for x in nums):
            return w
    return 1


def _launch(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if not src.is_contiguous():
        raise ValueError("src must be contiguous")
    n, m = src.shape[0], idx.shape[0]
    out = src.new_empty((m,) + tuple(src.shape[1:]))
    row_bytes = math.prod(src.shape[1:]) * src.element_size()
    if m == 0 or row_bytes == 0:
        return out
    idx32 = idx.to(torch.int32).contiguous()
    lib = windowed._load("gather")
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = lib.tdwss_block_gather(
        src.data_ptr(), n, row_bytes, idx32.data_ptr(), m, out.data_ptr(),
        _vec_bytes(row_bytes, src.data_ptr(), out.data_ptr()), stream)
    if err != 0:
        raise RuntimeError(f"{K7} launch failed: cudaError {err}")
    launches[K7] += 1
    return out


def _gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    _check_args(src, idx)
    if windowed._on_cpu(src):
        return _plain(src, idx)
    return _launch(src, idx)


def dma_block_gather_plain(src: torch.Tensor,
                           idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K7 (same arguments and checks as
    :func:`dma_block_gather`)."""
    _check_contract(src, idx)
    _check_args(src, idx)
    return _plain(src, idx)


def dma_block_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K7: ``out[i] = src[clip(idx[i], 0, N-1)]`` for blocks src (N, 8k, W)
    -> (M, 8k, W) in src's dtype.

    The reference's argument contract: ``ValueError`` unless ``len(idx)``
    is a multiple of 32 and src is 3-D with a block height that is a
    multiple of 8.  Any element type (the kernel copies bytes).
    """
    _check_contract(src, idx)
    return _gather(src, idx)


def gather_blocks(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The engine's block gather, ``jnp.take(src, idx, axis=0,
    mode="clip")``: src (N, ...) and idx (M,) of any length -> (M, ...).

    On a CUDA tensor it always launches K7, which needs none of the TPU's
    (8, 128) tile rules (the reference's shape test chose between its DMA
    pipeline and XLA's gather); on the CPU it is the plain version.
    """
    return _gather(src, idx)


def work(src: torch.Tensor, idx: torch.Tensor):
    """(bytes, flops) the gather needs on these inputs: each distinct
    block that the clipped index names read once, each output block
    written once and the index read once; no operations.  (Without
    repeated indices that is 2 * M * block bytes + 4 * M.)"""
    m = idx.shape[0]
    row = math.prod(src.shape[1:]) * src.element_size()
    distinct = (int(torch.unique(_clipped(idx, src.shape[0])).numel())
                if m else 0)
    return (distinct + m) * row + 4 * m, 0
