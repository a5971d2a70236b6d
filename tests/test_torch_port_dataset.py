"""The port's dataset loading against the reference's, on ``.npz`` scenes
written to ``tmp_path`` (with pseudo labels, proposal boxes and text
files beside them): ``load_processed_dir``, ``expand_subclouds`` with the
same seed, and ``load_train_val`` (processed scenes with pseudo labels
and boxes, the synthetic fallback with the pseudo-label pickup, and the
subcloud expansion) give the same scenes, array for array."""

import dataclasses
import json
import os

import numpy as np
import pytest

from tdwss.config import load_config as ref_load_config
from tdwss.data import dataset as ref_ds
from tdwss_torch.config import load_config
from tdwss_torch.data import dataset as ds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("points", "colors", "labels", "name", "texts", "pseudo_labels",
          "boxes", "center", "align")


def assert_same_scenes(ref, port):
    assert len(ref) == len(port)
    for r, p in zip(ref, port):
        for f in FIELDS:
            rv, pv = getattr(r, f), getattr(p, f)
            if rv is None or isinstance(rv, (str, list)):
                assert rv == pv, (r.name, f)
            else:
                rv, pv = np.asarray(rv), np.asarray(pv)
                assert (rv.dtype, rv.shape) == (pv.dtype, pv.shape), f
                assert rv.tobytes() == pv.tobytes(), (r.name, f)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """data_root with 3 train and 2 val scenes, pseudo labels for 2 of
    the train scenes, boxes and a text file for one."""
    base = tmp_path_factory.mktemp("scannet")
    rng = np.random.default_rng(3)
    for split, names in (("train_processed", ["s0", "s1", "s2"]),
                         ("val_processed", ["v0", "v1"])):
        d = base / split
        d.mkdir()
        for i, name in enumerate(names):
            n = 12000 + 500 * i
            extra = {}
            if i == 0:
                extra = dict(center=rng.normal(size=3).astype(np.float32),
                             align=np.eye(4, dtype=np.float32))
            np.savez(d / f"{name}.npz",
                     points=rng.uniform(0, 6, (n, 3)).astype(np.float32),
                     colors=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                     labels=rng.integers(-1, 20, n).astype(np.int32),
                     **extra)
    (base / "train_processed" / "s1_text.json").write_text(
        json.dumps(["a chair by the wall"]))
    pseudo = base / "pseudo"
    pseudo.mkdir()
    for name, n in (("s0", 12000), ("s2", 13000)):
        np.save(pseudo / f"{name}_pseudo_label.npy",
                rng.integers(-100, 20, n).astype(np.int64))
    boxes = base / "boxes"
    boxes.mkdir()
    np.save(boxes / "s1_prop.npy", rng.normal(size=(7, 9)))
    return base


def test_load_processed_dir_matches_reference(root):
    kw = dict(has_text=True, pseudo_label_path=str(root / "pseudo"),
              box_path=str(root / "boxes"))
    d = str(root / "train_processed")
    ref = ref_ds.load_processed_dir(d, **kw)
    port = ds.load_processed_dir(d, **kw)
    assert_same_scenes(ref, port)
    assert port[1].texts and port[1].boxes.shape == (7, 6)
    assert port[0].pseudo_labels is not None and port[1].pseudo_labels is None


@pytest.mark.parametrize("seed", [0, 4])
def test_expand_subclouds_matches_reference(root, seed):
    scenes = ds.load_processed_dir(str(root / "train_processed"),
                                   pseudo_label_path=str(root / "pseudo"))
    ref_scenes = ref_ds.load_processed_dir(
        str(root / "train_processed"), pseudo_label_path=str(root / "pseudo"))
    port = ds.expand_subclouds(scenes, 2.0, seed=seed)
    ref = ref_ds.expand_subclouds(ref_scenes, 2.0, seed=seed)
    assert len(port) > 3
    assert_same_scenes(ref, port)
    np.testing.assert_array_equal(ds.get_anchors(scenes[0].points, 1.5),
                                  ref_ds.get_anchors(scenes[0].points, 1.5))


def _cfgs(path, **kw):
    return ref_load_config(path, **kw), load_config(path, **kw)


@pytest.mark.parametrize("case", ["processed", "subcloud", "synthetic"])
def test_load_train_val_matches_reference(root, tmp_path, case):
    base = os.path.join(REPO, "configs", "smoke_cpu_pseudo.yaml")
    if case == "processed":
        kw = dict(data_root=str(root), pseudo_label_path=str(root / "pseudo"),
                  box_path=str(root / "boxes"))
        ref_cfg, cfg = _cfgs(base, **kw)
        ref_cfg.pointcloud_data.with_boxes = True
        cfg.pointcloud_data.with_boxes = True
    elif case == "subcloud":
        ref_cfg, cfg = _cfgs(base, data_root=str(root), label="subcloud",
                             model_name="MultiLabel", in_radius=2.5)
    else:
        # synthetic fallback: labels written for two of its scenes
        names = [s.name for s in ds.make_dataset(8, num_points=20,
                                                 seed=1, with_text=False)]
        for name in names[:2]:
            np.save(tmp_path / f"{name}_pseudo_label.npy",
                    np.arange(20000, dtype=np.int32) % 20)
        ref_cfg, cfg = _cfgs(base, data_root=str(tmp_path / "absent"),
                             pseudo_label_path=str(tmp_path))
    ref_train, ref_val = ref_ds.load_train_val(ref_cfg)
    train, val = ds.load_train_val(cfg)
    assert_same_scenes(ref_train, train)
    assert_same_scenes(ref_val, val)
    if case == "synthetic":
        assert len(train) == 8 and len(val) == 2
        assert [s.pseudo_labels is not None for s in train] == (
            [True, True] + [False] * 6)
    if case == "subcloud":
        assert train and all("#sub" in s.name for s in train)
    if case == "processed":
        assert train[1].boxes is not None


def test_val_offsets_match_reference(root):
    scenes = ds.load_processed_dir(str(root / "val_processed"))
    ref = ref_ds.val_offsets(ref_ds.load_processed_dir(
        str(root / "val_processed")))
    for a, b in zip(ds.val_offsets(scenes), ref):
        np.testing.assert_array_equal(a, b)
    assert dataclasses.is_dataclass(scenes[0])
