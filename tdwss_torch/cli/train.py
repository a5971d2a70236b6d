"""Training entry point (twin of ``tdwss.cli.train``; reference train.py).

    python -m tdwss_torch.cli.train --config configs/<experiment>.yaml
"""

from tdwss_torch.cli.common import parse_config
from tdwss_torch.engine.train import Trainer


def main() -> None:
    cfg, device = parse_config("Point Cloud Segmentation — training")
    Trainer(cfg, device=device).fit()


if __name__ == "__main__":
    main()
