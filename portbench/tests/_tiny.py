"""Each cell of the benchmark cut to a size a CPU test holds: the same
encoder and mix kind, m=4 (narrow planes for the up-pool), a few
thousand points, f32 compute (bf16 over a few voxels at the deepest
levels is all rounding).

Besides the cells of ``BENCHMARK.json``, the parked direct up-pool cell
on subclouds: out of the benchmark until the program seeds its elastic
deformation, its reference, mix and conv marks are kept and run here."""

import copy

from portbench import harness

PARKED = {
    "subcloud_uppool.train": {
        "spec": {"loop": "train", "config": "subcloud_uppool",
                 "traffic": "subclouds_r2_x128", "chips": 1,
                 "check_steps": 3},
        "config": {"config": {
            "model_name": "MultiLabel", "label": "subcloud", "in_radius": 2,
            "has_text": False,
            "pointcloud_data": {"scale": 50, "val_reps": 3, "batch_size": 4,
                                "elastic_deformation": False},
            "pointcloud_model": {"name": "SparseConvFCNetDirectUpPoolLight",
                                 "m": 16, "dimension": 3, "full_scale": 4096,
                                 "block_reps": 2, "residual_blocks": True},
            "loss": {"Classification": True}, "epochs": 512,
            "engine": {"max_points": 1048576, "level_capacity_shrink": 2,
                       "min_level_capacity": 8192,
                       "compute_dtype": "bfloat16"}}},
    },
}


def _cell(name: str) -> harness.Cell:
    if name not in PARKED:
        return harness.load_cell(name)
    unet = harness.load_cell(cells()[0])
    spec = dict(PARKED[name]["spec"], limits=unet.spec["limits"])
    return harness.Cell(name=name, spec=spec,
                        config=copy.deepcopy(PARKED[name]["config"]),
                        mix=harness.load_json("traffic", spec["traffic"]),
                        end_to_end=unet.end_to_end, per_layer=unet.per_layer)


def tiny_cell(name: str) -> harness.Cell:
    cell = _cell(name)
    cfg = copy.deepcopy(cell.config)
    c = cfg["config"]
    c["pointcloud_data"]["batch_size"] = 2
    c["pointcloud_model"]["m"] = 4
    if c["pointcloud_model"]["name"] != "SparseConvUNet":
        c["pointcloud_model"]["n_planes"] = [8, 12, 16, 20]
    c["engine"].update(max_points=16384, min_level_capacity=256,
                       compute_dtype="float32", collate_workers=2)
    mix = dict(cell.mix)
    if mix["kind"] == "scenes":
        mix.update(num_scenes=8, points_per_scene=3000)
    else:
        mix.update(num_scenes=1, points_per_scene=20000, min_points=200,
                   num_subclouds=8)
    return harness.Cell(name=cell.name, spec=cell.spec, config=cfg, mix=mix,
                        end_to_end=cell.end_to_end, per_layer=cell.per_layer)


def cells():
    return [w["name"] for w in harness.benchmark_spec()["workloads"]]


def tiny_cells():
    """The cells of the benchmark and the parked ones."""
    return cells() + list(PARKED)
