"""Training entry point (twin of ``tdwss.cli.train``; reference train.py).

    python -m tdwss_torch.cli.train --config configs/<experiment>.yaml

A config with ``mesh.data: N > 1`` trains data-parallel on N ranks:

    torchrun --nproc_per_node N -m tdwss_torch.cli.train --config <yaml>

(NCCL over one card per rank; ``--device cpu`` runs gloo ranks on the
CPU.)
"""

import torch

from tdwss_torch.cli.common import init_distributed, parse_config
from tdwss_torch.engine.train import Trainer


def main() -> None:
    cfg, device = parse_config("Point Cloud Segmentation — training")
    grouped = init_distributed(device)
    try:
        Trainer(cfg, device=device).fit()
    finally:
        if grouped:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
