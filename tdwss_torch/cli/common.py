"""Shared CLI plumbing (twin of ``tdwss.cli.common``)."""

from __future__ import annotations

import argparse
from typing import Tuple

from tdwss_torch.config import Config, load_config


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
