"""Device selection shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda`` unless the caller asks otherwise; raises when CUDA is asked
    for and no card is present (never falls back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain versions on the CPU")
    return dev


def check_model_device(model: torch.nn.Module, dev: torch.device) -> None:
    """Raise unless ``model``'s parameters live on ``dev``'s device type."""
    p = next(model.parameters())
    if p.device.type != dev.type:
        raise ValueError(f"model lives on {p.device}, not on {dev}")
