"""Model size (twin of ``tdwss.utils.flops.param_count``).

The reference's ``mega_mul_add`` reads XLA's cost analysis of the
compiled step; no PyTorch counter sees the port's hand-written kernels,
so it is not ported (``ROADMAP.md`` A.7).
"""

from __future__ import annotations

import torch


def param_count(model: torch.nn.Module) -> int:
    """#classifier parameters (reference train.py:44)."""
    return sum(p.numel() for p in model.parameters())
