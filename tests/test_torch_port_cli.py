"""The weak-supervision loop through the port's own command-line entry
points, as ``tests/test_cli_loop.py`` drives the reference's: train a scene-tag
classifier, sweep the pseudo-label thresholds, write the pseudo labels,
retrain ``FullySupervised`` on them, and validate with multi-view
voting, each a ``python -m tdwss_torch.cli.<name> --device cpu``
subprocess in ``tmp_path`` on the synthetic fallback data, with ``jax``,
``tdwss`` and TensorBoard unimportable in the child (as on the card
machine, which has none of them).  Without ``--device cpu`` and without
a card, every entry point refuses to run.
"""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_TINY = """\
GENERAL:
  training_name: {name}
  model_name: {model}
DATA:
  pointcloud_data: {{scale: 10, val_reps: 1, batch_size: 2, elastic_deformation: false}}
  label: {label}
  {pseudo}
  has_text: false
STRUCTURE:
  pointcloud_model:
    name: SparseConvFCNet
    m: 4
    dimension: 3
    full_scale: 128
    block_reps: 1
    residual_blocks: false
    depth: 2
  loss: {{Classification: true}}
Training:
  epochs: 2
PSEUDO_LABEL:
  threshold: 0.62
  path: {pseudo_dir}
  suffix: _pseudo_label.npy
ENGINE:
  engine: {{max_points: 8192, min_level_capacity: 256}}
"""

# Runs a module as __main__ with the named top-level packages blocked:
# their import raises ImportError.  A probe through importlib.util.find_spec
# (torch._dynamo makes some) gets a spec with no origin, not an error.
_BOOT = r"""
import importlib.abc, importlib.machinery, runpy, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "tdwss", "tensorboard",
           "tensorflow")
class Block(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            return importlib.machinery.ModuleSpec(name, self)
        return None
    def create_module(self, spec):
        raise ImportError("blocked import: " + spec.name)
    def exec_module(self, module):
        pass
sys.meta_path.insert(0, Block())
module = sys.argv[1]
sys.argv = [module] + sys.argv[2:]
runpy.run_module(module, run_name="__main__", alter_sys=True)
"""


def _run(module, config, cwd, *extra):
    # the child inherits the test process's thread cap (OMP_NUM_THREADS)
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-c", _BOOT, module, "--config", config, *extra],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_weak_supervision_loop_on_the_cpu(tmp_path):
    pseudo_dir = tmp_path / "pseudo"
    scene_cfg = tmp_path / "scene.yaml"
    scene_cfg.write_text(_TINY.format(
        name="cli_loop", model="MultiLabel", label="scene_level", pseudo="",
        pseudo_dir=pseudo_dir))
    cpu = ("--device", "cpu")

    r = _run("tdwss_torch.cli.train", str(scene_cfg), tmp_path, *cpu)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "mean IOU" in r.stdout and "2 Train loss" in r.stdout
    ckpts = tmp_path / "exp" / "cli_loop" / "checkpoints_torch"
    assert sorted(os.listdir(ckpts)) == ["epoch_1.pt", "epoch_2.pt"]
    assert (tmp_path / "exp" / "cli_loop" / "scalars.jsonl").exists()

    r = _run("tdwss_torch.cli.statistics", str(scene_cfg), tmp_path, *cpu)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("Thresh=") == 9
    assert "Start from epoch 3" in r.stdout

    r = _run("tdwss_torch.cli.pseudo_label_generation", str(scene_cfg),
             tmp_path, *cpu)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "Using Thresh=0.62" in r.stdout
    label_dir = pseudo_dir / "cli_loop_thresh0.62"
    files = sorted(os.listdir(label_dir))
    assert len(files) == 8 and all(f.endswith("_pseudo_label.npy")
                                   for f in files)

    pseudo_cfg = tmp_path / "pseudo.yaml"
    pseudo_cfg.write_text(_TINY.format(
        name="cli_loop_pseudo", model="FullySupervised", label="pseudo",
        pseudo=(f"pseudo_label_path: {label_dir}\n"
                f"  pseudo_label_suffix: _pseudo_label.npy"),
        pseudo_dir=pseudo_dir))
    r = _run("tdwss_torch.cli.train", str(pseudo_cfg), tmp_path, *cpu)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "2 Train loss" in r.stdout

    r = _run("tdwss_torch.cli.validation", str(pseudo_cfg), tmp_path, *cpu)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("mean IOU") == 9


@pytest.mark.parametrize("name", ["train", "statistics",
                                  "pseudo_label_generation", "validation"])
def test_entry_points_refuse_without_a_card(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a card")
    cfg = tmp_path / "scene.yaml"
    cfg.write_text(_TINY.format(
        name="no_card", model="MultiLabel", label="scene_level", pseudo="",
        pseudo_dir=tmp_path / "pseudo"))
    r = _run(f"tdwss_torch.cli.{name}", str(cfg), tmp_path)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
    assert not (tmp_path / "exp").exists()


_TINY_TEXT = """\
GENERAL:
  training_name: cli_text
  model_name: MultiLabelContrastive
DATA:
  pointcloud_data: {scale: 10, val_reps: 1, batch_size: 2, elastic_deformation: false}
  label: scene_level
  has_text: true
  text_data: {max_seq_len: 16, cropped_texts: 4}
STRUCTURE:
  pointcloud_model:
    name: SparseConvUNet
    m: 4
    dimension: 3
    full_scale: 128
    block_reps: 1
    residual_blocks: false
  text_model: {name: TextTransformer, context_length: 16, width: 64, layers: 2, vocab_size: 1000}
  loss: {Classification: true, TextContrastive: true}
Training:
  epochs: 2
ENGINE:
  engine: {max_points: 8192, min_level_capacity: 256}
"""


def test_text_config_trains_through_the_cli(tmp_path):
    """A small text config (MultiLabelContrastive, Classification +
    TextContrastive) trains two epochs and validates through the train
    entry point on the synthetic scenes with their descriptions."""
    cfg = tmp_path / "text.yaml"
    cfg.write_text(_TINY_TEXT)
    r = _run("tdwss_torch.cli.train", str(cfg), tmp_path, "--device", "cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "2 Train loss" in r.stdout and "mean IOU" in r.stdout
    ckpts = tmp_path / "exp" / "cli_text" / "checkpoints_torch"
    assert sorted(os.listdir(ckpts)) == ["epoch_1.pt", "epoch_2.pt"]
    state = torch.load(ckpts / "epoch_2.pt", map_location="cpu")
    assert any(k.startswith("text_encoder.resblock_1.")
               for k in state["model"])
