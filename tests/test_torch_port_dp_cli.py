"""``torchrun`` over the port's train entry point on the CPU:
``python -m torch.distributed.run --nproc_per_node 2 -m
tdwss_torch.cli.train --device cpu`` trains a ``mesh.data: 2`` config
for one epoch (the entry point initialises a gloo group from torchrun's
variables), rank 0 alone printing and writing the checkpoint.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_TINY_DP = """\
GENERAL:
  training_name: cli_dp
  model_name: MultiLabel
DATA:
  pointcloud_data: {scale: 10, val_reps: 1, batch_size: 4, elastic_deformation: false}
  label: scene_level
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
  loss: {Classification: true}
Training:
  epochs: 1
ENGINE:
  engine: {max_points: 8192, min_level_capacity: 256}
  mesh: {data: 2}
"""


def test_torchrun_cli_trains_mesh_data_2_on_the_cpu(tmp_path):
    cfg = tmp_path / "dp.yaml"
    cfg.write_text(_TINY_DP)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "tdwss_torch.cli.train",
         "--config", str(cfg), "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    assert r.stdout.count("1 Train loss") == 1      # rank 0 prints
    ckpts = tmp_path / "exp" / "cli_dp" / "checkpoints_torch"
    assert os.listdir(ckpts) == ["epoch_1.pt"]
