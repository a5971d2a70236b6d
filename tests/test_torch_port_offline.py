"""The port's offline tools against the reference's, on the same inputs
and the same ``rng``: host numpy functions equal array for array
(``assert_array_equal`` or byte-equal files), the mask blur within 1e-6.

- GSS (``tdwss_torch.gss``): normals, region growing (the native
  library's, and its numpy version under ``native.disabled()`` id for
  id), ``attach_unassigned``, the merged regions, ``region_boxes``,
  ``_box_iou_3d``, ``nms_3d``, ``generate_proposals`` (both region
  growers) and ``run_scene``'s file; ``ARCalculator``,
  ``evaluate_proposals``, ``ensemble_proposals`` and the colour
  conversions;
- pseudo images: camera sampling in every mode, poses, text
  composition from an attribute file, sharding, the injected generator,
  the white-background filter, mask extraction, ``blur_masks`` and
  ``run_mask_pipeline`` (on the CPU);
- mesh rasterization and the cylinder mesh;
- PLY: the written file byte for byte, binary and ASCII reads with a
  face element skipped;
- prep: ``process_scene``'s ``.npz`` (an axis-align matrix, unknown NYU
  ids, a scene without labels), ``prepare_text``'s files, and
  ``python -m tdwss_torch.data.prep``;
- BPE training: the word counts and the merges of a small corpus, the
  shipped asset's merges reproduced by ``train_bpe(scannet_corpus(),
  2048)`` and written by ``python -m tdwss_torch.data.bpe_train --out``
  into ``tmp_path`` with the asset's text byte for byte.
"""

import dataclasses
import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tdwss import native as ref_native
from tdwss.data import bpe_train as ref_bpe
from tdwss.data import prep as ref_prep
from tdwss.gss import eval as ref_eval
from tdwss.gss import search as ref_search
from tdwss.ops import pseudo_images as ref_pi
from tdwss.utils import mesh as ref_mesh
from tdwss.utils import ply as ref_ply
from tdwss_torch import native
from tdwss_torch.data import bpe_train, prep
from tdwss_torch.data.tokenizer import DEFAULT_VOCAB_PATH
from tdwss_torch.gss import eval as gss_eval
from tdwss_torch.gss import search
from tdwss_torch.ops import pseudo_images as pi
from tdwss_torch.utils import mesh, ply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert (a.dtype, a.shape) == (b.dtype, b.shape)
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def scene():
    """Two touching coplanar patches, a parallel plane and a wall, with
    noise and labels: regions that merge and regions that do not."""
    rng = np.random.default_rng(0)
    p1 = rng.uniform(0, 2, (500, 3)); p1[:, 2] = 0.0
    p2 = rng.uniform(0, 2, (500, 3)); p2[:, 0] += 1.95; p2[:, 2] = 0.0
    p3 = rng.uniform(0, 2, (400, 3)); p3[:, 2] = 1.0
    p4 = rng.uniform(0, 2, (400, 3)); p4[:, 1] = 0.0
    pts = np.concatenate([p1, p2, p3, p4])
    pts += rng.normal(scale=0.002, size=pts.shape)
    labels = np.repeat(np.arange(4), [500, 500, 400, 400]).astype(np.int64)
    return pts.astype(np.float32), labels


def test_normals_and_region_growing(scene):
    pts, _ = scene
    normals = search.estimate_normals(pts)
    _eq(normals, ref_search.estimate_normals(pts))
    got = native.region_grow(pts, normals, min_region=50)
    want = ref_native.region_grow(pts, normals, min_region=50)
    assert got[1] == want[1] >= 3
    _eq(got[0], want[0])
    with native.disabled():
        got_np = native.region_grow(pts, normals, min_region=50)
    want_np = ref_native._region_grow_np(pts, normals, 12, 0.05, 20.0, 50)
    assert got_np[1] == want_np[1] >= 3
    _eq(got_np[0], want_np[0])
    _eq(search.attach_unassigned(pts, got[0]),
        ref_search.attach_unassigned(pts, want[0]))


def test_merged_regions_boxes_and_nms(scene):
    pts, labels = scene
    rid = np.repeat(np.arange(4), [500, 500, 400, 400]).astype(np.int32)
    got = search.hierarchical_segmentation(pts, rid, labels)
    want = ref_search.hierarchical_segmentation(pts, rid, labels)
    assert len(got) == len(want) > 4
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            _eq(getattr(g, f.name), getattr(w, f.name))
    boxes = search.region_boxes(got, np.random.default_rng(1))
    _eq(boxes, ref_search.region_boxes(want, np.random.default_rng(1)))
    _eq(search._box_iou_3d(boxes, boxes), ref_search._box_iou_3d(boxes, boxes))
    for thr in (0.1, 0.5, 0.75):
        _eq(search.nms_3d(boxes, thr), ref_search.nms_3d(boxes, thr))
    mask = search.SimilarityMask(size=False, fill=False)
    assert len(search.hierarchical_segmentation(pts, rid, None, mask)) == \
        len(ref_search.hierarchical_segmentation(
            pts, rid, None, ref_search.SimilarityMask(size=False, fill=False)))


@pytest.mark.parametrize("grower", ["native", "numpy"])
def test_generate_proposals(scene, grower, tmp_path, monkeypatch):
    pts, labels = scene
    timings = {}
    if grower == "numpy":
        monkeypatch.setattr(ref_native, "_load", lambda: None)
        with native.disabled():
            got = search.generate_proposals(pts, seg_labels=labels,
                                            rng=np.random.default_rng(2))
            want = ref_search.generate_proposals(
                pts, seg_labels=labels, rng=np.random.default_rng(2))
    else:
        got = search.generate_proposals(pts, seg_labels=labels,
                                        rng=np.random.default_rng(2),
                                        timings=timings)
        want = ref_search.generate_proposals(pts, seg_labels=labels,
                                             rng=np.random.default_rng(2))
        assert set(timings) == {"normals", "region_grow", "regions",
                                "merge", "merged", "nms"}
    assert got.shape[0] >= 2
    _eq(got, want)
    out = tmp_path / "sub" / "scene_prop.npy"
    search.run_scene(pts, str(out), rng=np.random.default_rng(2))
    _eq(np.load(out), want if grower == "native" else np.load(out))


def test_ar_calculator_and_ensembles():
    rng = np.random.default_rng(3)
    props = [np.concatenate([rng.uniform(0, 5, (k, 3)),
                             rng.uniform(0.2, 2, (k, 3)),
                             rng.uniform(0, 1, (k, 1))], 1)
             for k in (30, 0, 12)]
    gts = [np.concatenate([rng.uniform(0, 5, (k, 3)),
                           rng.uniform(0.2, 2, (k, 3))], 1) for k in (5, 3, 0)]
    classes = [rng.integers(0, 4, len(g)) for g in gts]
    for iou in (0.25, 0.5):
        got = gss_eval.evaluate_proposals(props, gts, classes, iou)
        assert got == ref_eval.evaluate_proposals(props, gts, classes, iou)
        got = gss_eval.evaluate_proposals(props, gts, None, iou)
        assert got == ref_eval.evaluate_proposals(props, gts, None, iou)
    corners = gss_eval.center_extent_to_corners(props[0])
    _eq(corners, ref_eval.center_extent_to_corners(props[0]))
    _eq(gss_eval.box_iou_3d_corners(corners, corners[:7]),
        ref_eval.box_iou_3d_corners(corners, corners[:7]))
    assert gss_eval.ARCalculator().compute() == \
        ref_eval.ARCalculator().compute()
    for cap in (1000, 10):
        _eq(gss_eval.ensemble_proposals(props, 0.3, cap,
                                        np.random.default_rng(4)),
            ref_eval.ensemble_proposals(props, 0.3, cap,
                                        np.random.default_rng(4)))
    _eq(gss_eval.ensemble_proposals([np.zeros((0, 7))]),
        ref_eval.ensemble_proposals([np.zeros((0, 7))]))


def test_colour_conversions():
    rng = np.random.default_rng(5)
    colors = rng.integers(0, 256, (500, 3)).astype(np.uint8)
    colors[:4] = [[0, 0, 0], [255, 255, 255], [10, 10, 10], [255, 0, 0]]
    for name in ("rgb", "lab", "rgi", "hsv", "nrgb", "hue"):
        _eq(gss_eval.convert_color(colors, name),
            ref_eval.convert_color(colors, name))


def test_camera_sampling_and_text(tmp_path):
    for mode in ("uniform", "normal", "hybrid", "spherical_uniform", "mean"):
        for seed in (0, 1):
            got = pi.sample_camera_positions(np.random.default_rng(seed), 6,
                                             r=1.3, mode=mode)
            want = ref_pi.sample_camera_positions(
                np.random.default_rng(seed), 6, r=1.3, mode=mode)
            for g, w in zip(got, want):
                _eq(g, w)
    got = pi.sample_camera_pose(np.random.default_rng(6), 4, radius=2.7)
    want = ref_pi.sample_camera_pose(np.random.default_rng(6), 4, radius=2.7)
    for g, w in zip(got, want):
        _eq(g, w)
    o = np.random.default_rng(7).normal(size=(3, 3))
    _eq(pi.create_cam2world_matrix(-o, o),
        ref_pi.create_cam2world_matrix(-o, o))
    path = tmp_path / "attr.json"
    path.write_text(json.dumps([
        {"object_name": "arm_chair", "object_attrbution":
         {"size": ["big"], "shape": ["round"], "color": ["red"]}},
        {"object_name": "tv stand", "object_attrbution": {"color": []}}]))
    assert pi.generate_text(str(path)) == ref_pi.generate_text(str(path))
    assert pi.read_attr(str(path)) == ref_pi.read_attr(str(path))
    with pytest.raises(ValueError):
        pi.compose_text([], mode="other")
    for args in ((0, 3, 10), (2, 3, 10), (1, 4, 3)):
        assert pi.shard_range(*args) == ref_pi.shard_range(*args)


def _images(seed=8, n=6, size=48):
    """White backgrounds with a filled coloured shape; one with a dark
    border (filtered out) and one all white (blurs to nothing)."""
    rng = np.random.default_rng(seed)
    imgs = np.full((n, size, size, 3), 255, np.uint8)
    yy, xx = np.mgrid[:size, :size]
    for i in range(n - 1):
        cy, cx, r = rng.integers(14, size - 14, 2).tolist() + [
            int(rng.integers(5, 12))]
        imgs[i][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.integers(
            0, 200, 3)
    imgs[1, :6] = 0
    return imgs


def test_generation_filter_and_masks():
    imgs = _images()
    texts = ["a chair", "a table", "a lamp", "a bed", "a sofa"]

    def gen(batch):
        return imgs[: len(batch)]

    got = pi.generate_images(texts, gen, device_num=1, total_devices=2)
    want = ref_pi.generate_images(texts, gen, device_num=1, total_devices=2)
    _eq(got[0], want[0])
    assert got[1] == want[1]
    with pytest.raises(RuntimeError):
        pi.generate_images(texts, None)
    cfg = pi.PseudoImageConfig(resolution=32)
    for img in imgs:
        assert pi.is_white_background(img) == ref_pi.is_white_background(img)
        _eq(pi.extract_mask(img), ref_pi.extract_mask(img))
    _eq(pi.filter_images(imgs, cfg), ref_pi.filter_images(imgs, cfg))
    raw = np.stack([pi.extract_mask(i) for i in imgs[:3]])
    want = ref_pi.blur_masks(raw, cfg)
    got = pi.blur_masks(raw, cfg, device="cpu")
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    keep, blurred = pi.run_mask_pipeline(imgs, cfg, device="cpu")
    ref_keep, ref_blurred = ref_pi.run_mask_pipeline(imgs, cfg)
    _eq(keep, ref_keep)
    assert 0 < len(keep) < len(imgs)
    assert np.abs(blurred - ref_blurred).max() <= 1e-6 * 255


def test_mesh():
    v, f = mesh.cylinder_mesh(np.asarray([0.5, -1.0, 2.0, 1.5, 0.4]), 16)
    rv, rf = ref_mesh.cylinder_mesh(np.asarray([0.5, -1.0, 2.0, 1.5, 0.4]),
                                    16)
    _eq(v, rv)
    _eq(f, rf)
    faces = np.concatenate([f, [[0, 0, 2]]])          # a degenerate face
    for dl in (0.05, 0.2, 5.0):
        for g, w in zip(mesh.rasterize_mesh(v, faces, dl),
                        ref_mesh.rasterize_mesh(rv, faces, dl)):
            _eq(g, w)


def _ply_columns(n=50, seed=9):
    rng = np.random.default_rng(seed)
    return ([rng.normal(size=(n, 3)).astype(np.float32),
             rng.integers(0, 255, (n, 3)).astype(np.uint8),
             rng.integers(0, 40, n).astype(np.int32),
             rng.normal(size=n),
             rng.integers(0, 9, n).astype(np.uint16)],
            ["x", "y", "z", "red", "green", "blue", "label", "w", "u"])


def test_ply_files(tmp_path):
    cols, names = _ply_columns()
    assert ply.write_ply(str(tmp_path / "a"), cols, names)
    ref_ply.write_ply(str(tmp_path / "b.ply"), cols, names)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    with pytest.raises(ValueError):
        ply.write_ply(str(tmp_path / "c.ply"), cols, names[:-1])
    # a face element after the vertices, and an ASCII file
    faces = (tmp_path / "f.ply")
    body = (tmp_path / "a.ply").read_bytes()
    head, data = body.split(b"end_header\n")
    tri = np.zeros(3, [("n", "u1"), ("i", "<i4"), ("j", "<i4"), ("k", "<i4")])
    tri["n"] = 3
    faces.write_bytes(head + b"element face 3\nproperty list uchar int "
                      b"vertex_indices\nend_header\n" + data + tri.tobytes())
    asc = tmp_path / "asc.ply"
    asc.write_text("ply\nformat ascii 1.0\ncomment hi\nelement vertex 2\n"
                   "property float x\nproperty uchar red\nend_header\n"
                   "1.5 7\n-2 255\n")
    for path in (tmp_path / "a.ply", faces, asc):
        got, want = ply.read_ply(str(path)), ref_ply.read_ply(str(path))
        assert list(got) == list(want)
        for k in want:
            _eq(got[k], want[k])
    bad = tmp_path / "bad.ply"
    bad.write_bytes(b"nope\n")
    with pytest.raises(ValueError):
        ply.read_ply(str(bad))


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    base = tmp_path_factory.mktemp("scans")
    rng = np.random.default_rng(10)
    for i, (meta, labelled) in enumerate(((True, True), (False, True),
                                          (True, False))):
        name = f"scene000{i}_00"
        d = base / name
        d.mkdir()
        n = 80 + i
        pts = (rng.normal(size=(n, 3)) + 5).astype(np.float32)
        colors = rng.integers(0, 255, (n, 3)).astype(np.uint8)
        ref_ply.write_ply(str(d / f"{name}_vh_clean_2.ply"), [pts, colors],
                          ["x", "y", "z", "red", "green", "blue"])
        if labelled:
            labels = rng.choice([0, 1, 4, 39, 40, 1163], n).astype(np.int32)
            ref_ply.write_ply(str(d / f"{name}_vh_clean_2.labels.ply"),
                              [pts, labels], ["x", "y", "z", "label"])
        if meta:
            m = np.eye(4)
            m[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            m[:3, 3] = rng.normal(size=3)
            (d / f"{name}.txt").write_text(
                "sceneType = Bedroom\naxisAlignment = "
                + " ".join(f"{x:.6f}" for x in m.reshape(-1)) + "\n")
    (base / "not_a_scene").mkdir()
    refer = [{"scene_id": "scene0000_00", "description": "a chair"},
             {"scene_id": "scene0002_00", "description": "the table"},
             {"scene_id": "scene0000_00", "description": "a bed"}]
    (base / "refer.json").write_text(json.dumps(refer))
    return base


def _npz_equal(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            _eq(x[k], y[k])


def test_prep_scene_and_text(scans, tmp_path):
    raw = np.asarray([0, 1, 2, 39, 40, 13, 14, 1163])
    _eq(prep.remap_labels(raw), ref_prep.remap_labels(raw))
    for i in range(3):
        name = f"scene000{i}_00"
        assert prep.process_scene(str(scans / name), str(tmp_path / "p")) \
            == ref_prep.process_scene(str(scans / name), str(tmp_path / "r"))
        _eq(prep.read_axis_align_matrix(str(scans / name / f"{name}.txt")),
            ref_prep.read_axis_align_matrix(str(scans / name /
                                                f"{name}.txt")))
        _npz_equal(tmp_path / "p" / f"{name}.npz",
                   tmp_path / "r" / f"{name}.npz")
    assert prep.process_scene(str(scans / "not_a_scene"), str(tmp_path)) \
        is None
    assert prep.prepare_text(str(scans / "refer.json"), str(tmp_path / "p")) \
        == ref_prep.prepare_text(str(scans / "refer.json"),
                                 str(tmp_path / "r")) == 2
    for name in ("scene0000_00", "scene0002_00"):
        f = f"{name}_text.json"
        assert (tmp_path / "p" / f).read_bytes() == \
            (tmp_path / "r" / f).read_bytes()


def test_prep_command(scans, tmp_path):
    out = tmp_path / "out"
    subprocess.run([sys.executable, "-m", "tdwss_torch.data.prep", "--scans",
                    str(scans), "--out", str(out), "--split", "val",
                    "--scanrefer", str(scans / "refer.json"),
                    "--workers", "1"], cwd=REPO, check=True,
                   capture_output=True, timeout=120)
    ref_out = tmp_path / "ref"
    for i in range(3):
        ref_prep.process_scene(str(scans / f"scene000{i}_00"), str(ref_out))
    got = sorted(os.listdir(out / "val_processed"))
    assert got == sorted([f"scene000{i}_00.npz" for i in range(3)]
                         + ["scene0000_00_text.json",
                            "scene0002_00_text.json"])
    for i in range(3):
        _npz_equal(out / "val_processed" / f"scene000{i}_00.npz",
                   ref_out / f"scene000{i}_00.npz")


def test_bpe_training_equal():
    corpus = ["aa aa aa ab", "the chair, the chair's leg!", "ba ab ab 12"]
    assert bpe_train.corpus_word_counts(corpus) == \
        ref_bpe.corpus_word_counts(corpus)
    for n in (1, 5, 40):
        assert bpe_train.train_bpe(corpus, n) == ref_bpe.train_bpe(corpus, n)
    assert bpe_train.scannet_corpus() == ref_bpe.scannet_corpus()


def test_shipped_asset_reproduced(tmp_path):
    merges = bpe_train.train_bpe(bpe_train.scannet_corpus(), 2048)
    assert merges == ref_bpe.train_bpe(ref_bpe.scannet_corpus(), 2048)
    with gzip.open(DEFAULT_VOCAB_PATH, "rb") as f:
        asset = f.read()
    text = tmp_path / "merges.txt"
    bpe_train.write_merges(merges, str(text))
    assert text.read_bytes() == asset
    out = tmp_path / "bpe_scannet.txt.gz"
    subprocess.run([sys.executable, "-m", "tdwss_torch.data.bpe_train",
                    "--out", str(out)], cwd=REPO, check=True,
                   capture_output=True, timeout=120)
    with gzip.open(out, "rb") as f:
        assert f.read() == asset
