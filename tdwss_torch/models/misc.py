"""Small model helpers (twin of :mod:`tdwss.models.misc`).

- :class:`Result`: list-or-dict output accumulator for forward functions
  that return a variable set of tensors.
- :func:`interpolate_pos_encoding`: resize of a cubic 3D learned
  positional table to a new (H, W, Z) patch grid, computing what
  ``jax.image.resize(method="cubic")`` computes: the Keys cubic kernel
  (a = -0.5) at half-pixel centres, the kernel widened by the shrink
  factor when a side shrinks (antialiasing), the weights renormalised to
  sum to one at the edges, one separable weight matrix per resized side.
  ``torch.nn.functional.interpolate`` has no tricubic mode, and its
  bicubic (a = -0.75, clamped edges) is another function.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch


class Result:
    """Accumulates forward outputs as a tuple or a dict."""

    def __init__(self, as_dict: bool = False):
        self.outs: Union[Dict[str, Any], List[Any]] = {} if as_dict else []

    @property
    def as_dict(self) -> bool:
        return isinstance(self.outs, dict)

    def append(self, element: Any, name: Optional[str] = None) -> None:
        if self.as_dict:
            if name is None:
                raise ValueError("dict-mode Result.append requires a name")
            self.outs[name] = element
        else:
            self.outs.append(element)

    def update(self, **kwargs: Any) -> None:
        if self.as_dict:
            self.outs.update(**kwargs)
        else:
            for v in kwargs.values():
                self.outs.append(v)

    def as_output(self):
        return self.outs if self.as_dict else tuple(self.outs)

    def as_return(self):
        outs = self.as_output()
        if self.as_dict:
            return outs
        if len(outs) == 1:
            return outs[0]
        return outs


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


_KERNELS = {"cubic": _keys_cubic, "bicubic": _keys_cubic,
            "tricubic": _keys_cubic, "linear": _triangle,
            "bilinear": _triangle, "trilinear": _triangle}


def _resize_weights(input_size: int, output_size: int, method: str = "cubic",
                   device=None) -> torch.Tensor:
    """(input_size, output_size) float32 weights of one resized side, as
    ``jax.image.resize`` builds them (antialiased, translation 0)."""
    kernel = _KERNELS[method]
    inv_scale = float(np.float32(1.0 / (output_size / input_size)))
    kernel_scale = max(inv_scale, 1.0)
    sample_f = ((torch.arange(output_size, dtype=torch.float32,
                              device=device) + 0.5) * inv_scale - 0.5)
    x = torch.abs(sample_f[None, :] - torch.arange(
        input_size, dtype=torch.float32, device=device)[:, None]
        ) / kernel_scale
    w = kernel(x)
    total = torch.sum(w, dim=0, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    w = torch.where(torch.abs(total) > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def interpolate_pos_encoding(pos_embed: torch.Tensor, h: int, w: int, z: int,
                             method: str = "cubic") -> torch.Tensor:
    """Resize a (1, N, D) cubic-grid positional table to (1, H*W*Z, D).

    N must be a perfect cube (side s); returns ``pos_embed`` unchanged
    when the target grid is the same cube.
    """
    n, dim = pos_embed.shape[1], pos_embed.shape[2]
    if h * w * z == n and h == w == z:
        return pos_embed
    side = round(n ** (1.0 / 3.0))
    if side**3 != n:
        raise ValueError(f"pos_embed length {n} is not a perfect cube")
    grid = pos_embed.reshape(side, side, side, dim).float()
    for axis, size in enumerate((h, w, z)):
        if size == side:
            continue
        wm = _resize_weights(side, size, method, grid.device)
        grid = torch.tensordot(grid, wm, dims=([axis], [0])
                               ).movedim(-1, axis)
    return grid.to(pos_embed.dtype).reshape(1, h * w * z, dim)
