"""Standalone validation (twin of ``tdwss.cli.validation``; reference
validation.py): restore the newest checkpoint, 9 multi-view voting reps,
the mIoU after each."""

from tdwss_torch.cli.common import parse_config
from tdwss_torch.engine.evaluate import validate
from tdwss_torch.engine.train import Trainer


def main() -> None:
    cfg, device = parse_config("Point Cloud Segmentation — validation")
    trainer = Trainer(cfg, use_checkpoints=True, device=device)
    validate(cfg, trainer.model, trainer.val_scenes, reps=9,
             device=trainer.device)


if __name__ == "__main__":
    main()
