"""Pseudo-label threshold sweep (twin of ``tdwss.cli.statistics``;
reference statistics.py): linspace(0.6, 0.8, 9) over the train set,
plotted to visualization/Statistics.jpg.

``--train-augmented`` sweeps the train-augmented loader, as the
reference does (statistics.py:41-56); the default sweeps deterministic
val-style views, every point at generation's operating point.
"""

import argparse
import sys

from tdwss_torch.cli.common import parse_config
from tdwss_torch.engine.pseudo import threshold_sweep
from tdwss_torch.engine.train import Trainer


def main() -> None:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--train-augmented", action="store_true")
    flags, rest = pre.parse_known_args()
    sys.argv = [sys.argv[0]] + rest
    cfg, device = parse_config(
        "Point Cloud Segmentation — threshold statistics")
    trainer = Trainer(cfg, use_checkpoints=True, device=device)
    threshold_sweep(cfg, trainer.model, trainer.train_scenes,
                    train_augmented=flags.train_augmented,
                    device=trainer.device)


if __name__ == "__main__":
    main()
