"""Pseudo-label generation (twin of ``tdwss.cli.pseudo_label_generation``;
reference pseudoLabelGeneration.py): one threshold, per-scene label files
under cfg.path/<training_name>_thresh<t>."""

from tdwss_torch.cli.common import parse_config
from tdwss_torch.engine.pseudo import generate_pseudo_labels
from tdwss_torch.engine.train import Trainer


def main() -> None:
    cfg, device = parse_config(
        "Point Cloud Segmentation — pseudo label generation")
    trainer = Trainer(cfg, use_checkpoints=True, device=device)
    generate_pseudo_labels(cfg, trainer.model, trainer.train_scenes,
                           device=trainer.device)


if __name__ == "__main__":
    main()
