"""Shared CLI plumbing (twin of ``tdwss.cli.common``)."""

from __future__ import annotations

import argparse
import os
from typing import Tuple

import torch

from tdwss_torch.config import Config, load_config


def init_distributed(device: str) -> bool:
    """Under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``
    set), initialise the default process group from those variables:
    NCCL for a CUDA device (this rank's card, ``cuda:LOCAL_RANK``, made
    current first), gloo for the CPU.  Without them, nothing is
    initialised and a ``mesh.data > 1`` config is refused by the
    ``Trainer``.  Returns whether a group was initialised."""
    if not all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "LOCAL_RANK")):
        return False
    backend = "gloo"
    if torch.device(device).type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    torch.distributed.init_process_group(backend, init_method="env://")
    return True


def parse_config(description: str,
                 default_config: str = "configs/3DUNetWithText_scannet_default.yaml"
                 ) -> Tuple[Config, str]:
    """(config, device) from the command line: the reference's flags,
    plus ``--device`` (``cuda`` by default; ``cpu`` runs the plain
    versions of the kernels)."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config", type=str, default=default_config,
                        help="path to config file")
    parser.add_argument("--pretrain", type=str, default="",
                        help="path to pretrain model")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda)")
    args = parser.parse_args()
    overrides = {}
    if args.epochs is not None:
        overrides["epochs"] = args.epochs
    if args.pretrain:
        overrides["pretrain"] = args.pretrain
    return load_config(args.config, **overrides), args.device
