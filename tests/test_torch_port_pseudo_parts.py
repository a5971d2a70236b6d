"""The point-level pieces of the pseudo-label round against the reference
on the same numpy-seeded inputs (f32):

- ``segment_mean_by_batch`` / ``segment_sum_by_batch``, rtol 1e-5 and
  atol 1e-5 of the largest value (sums of many rows cancel);
- ``masked_cross_entropy`` (with an all-ignored batch) and
  ``Classification`` with 1-D labels, rtol 1e-5;
- ``preprocess_logits``, ``get_pseudo_labels`` and
  ``assess_label_quality``, rtol 1e-5 on the scores, the labels and
  counts equal;
- ``devoxelize_seg``: the forward equal, the backward within 1e-5 of
  max|dvox| of ``jax.vjp`` of the reference's (a cumsum difference
  against the port's left-to-right run sums), and bit for bit over two
  runs, on a voxelization whose capacity drops some voxels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdwss.ops.segment import segment_mean_by_batch as ref_seg_mean
from tdwss.ops.segment import segment_sum_by_batch as ref_seg_sum
from tdwss.ops.voxelize import devoxelize_seg as ref_devox_seg
from tdwss.utils.losses import Classification as ref_classification
from tdwss.utils.losses import masked_cross_entropy as ref_mce
from tdwss.utils import pseudo as ref_pseudo
from tdwss_torch.ops.host_plan import voxelize_np
from tdwss_torch.ops.segment import (segment_mean_by_batch,
                                     segment_sum_by_batch)
from tdwss_torch.ops.voxelize import devoxelize_seg
from tdwss_torch.utils.losses import Classification, masked_cross_entropy
from tdwss_torch.utils import pseudo

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(11)
    n, b = 2000, 3
    logits = rng.normal(size=(n, 20)).astype(np.float32)
    batch_idx = rng.integers(0, b, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    labels = rng.integers(0, 20, n).astype(np.int32)
    labels[rng.random(n) < 0.3] = -100
    scene_label = (rng.random((b, 20)) < 0.4).astype(np.float32)
    return dict(logits=logits, batch_idx=batch_idx, valid=valid,
                labels=labels, scene_label=scene_label, b=b)


@pytest.mark.parametrize("masked", [False, True])
def test_segment_by_batch_matches_reference(points, masked):
    p = points
    valid = p["valid"] if masked else None
    for ref_fn, fn in ((ref_seg_mean, segment_mean_by_batch),
                       (ref_seg_sum, segment_sum_by_batch)):
        ref = ref_fn(jnp.asarray(p["logits"]), jnp.asarray(p["batch_idx"]),
                     p["b"] + 1, None if valid is None
                     else jnp.asarray(valid))
        got = fn(_t(p["logits"]), _t(p["batch_idx"]), p["b"] + 1,
                 None if valid is None else _t(valid))
        ref = np.asarray(ref)
        # sums of ~700 rows of normals cancel: atol at RTOL of the largest
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL,
                                   atol=RTOL * np.abs(ref).max())
    # the padded scene (index b) has no rows: its mean is 0
    assert not segment_mean_by_batch(_t(p["logits"]), _t(p["batch_idx"]),
                                     p["b"] + 1)[-1].any()


@pytest.mark.parametrize("case", ["mixed", "all_ignored", "no_valid_mask"])
def test_masked_cross_entropy_matches_reference(points, case):
    p = points
    labels = p["labels"].copy()
    valid = p["valid"]
    if case == "all_ignored":
        labels[:] = -100
    if case == "no_valid_mask":
        valid = None
    ref = ref_mce(jnp.asarray(p["logits"]), jnp.asarray(labels),
                  None if valid is None else jnp.asarray(valid))
    got = masked_cross_entropy(_t(p["logits"]), _t(labels),
                               None if valid is None else _t(valid))
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)
    if case == "all_ignored":
        assert float(got) == 0.0
    # Classification dispatches 1-D labels to the point cross-entropy
    got_c = Classification(_t(p["logits"]), _t(labels),
                           mask=None if valid is None else _t(valid))
    ref_c = ref_classification(jnp.asarray(p["logits"]), jnp.asarray(labels),
                               mask=None if valid is None
                               else jnp.asarray(valid))
    np.testing.assert_allclose(float(got_c), float(ref_c), rtol=RTOL)
    assert float(got_c) == float(got)


def test_pseudo_label_math_matches_reference(points):
    p = points
    args_ref = (jnp.asarray(p["logits"]), jnp.asarray(p["scene_label"]),
                jnp.asarray(p["batch_idx"]))
    args = (_t(p["logits"]), _t(p["scene_label"]), _t(p["batch_idx"]))
    np.testing.assert_allclose(
        pseudo.preprocess_logits(*args).numpy(),
        np.asarray(ref_pseudo.preprocess_logits(*args_ref)), rtol=RTOL)
    for th in (0.5, 0.62, 0.71):
        ref_l, ref_n = ref_pseudo.get_pseudo_labels(
            *args_ref, threshold=th, valid=jnp.asarray(p["valid"]))
        got_l, got_n = pseudo.get_pseudo_labels(
            *args, threshold=th, valid=_t(p["valid"]))
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
        assert int(got_n) == int(ref_n)
        for valid in (None, p["valid"]):
            ref_q = ref_pseudo.assess_label_quality(
                ref_l, jnp.asarray(p["labels"]),
                None if valid is None else jnp.asarray(valid))
            got_q = pseudo.assess_label_quality(
                got_l, _t(p["labels"]), None if valid is None else _t(valid))
            assert [int(x) for x in got_q] == [int(x) for x in ref_q]


def test_store_pseudo_label_matches_reference(points, tmp_path):
    labels = points["labels"]
    names, offsets = ["a", "b", "c"], [0, 700, 1500, 2000]
    ref_pseudo.store_pseudo_label(labels, names, offsets, str(tmp_path / "r"))
    pseudo.store_pseudo_label(labels, names, offsets, str(tmp_path / "p"))
    for name in names:
        f = name + "_pseudo_label.npy"
        np.testing.assert_array_equal(np.load(tmp_path / "p" / f),
                                      np.load(tmp_path / "r" / f))


@pytest.fixture(scope="module")
def voxels():
    """A voxelization of 6,000 points (some invalid) into a capacity that
    drops some voxels; the reference's forward and VJP on it."""
    rng = np.random.default_rng(5)
    n, c = 6000, 24
    coords = np.concatenate([rng.integers(0, 12, (n, 3)),
                             rng.integers(0, 2, (n, 1))], 1).astype(np.int32)
    valid = rng.random(n) < 0.9
    grid, _, p2v, perm = voxelize_np(coords, None, valid, 2500,
                                     return_order=True)
    assert int(grid.num_valid) > 2500             # the capacity drops some
    vox = rng.normal(size=(2500, c)).astype(np.float32)
    dpts = rng.normal(size=(n, c)).astype(np.float32)
    fwd, vjp = jax.vjp(lambda v: ref_devox_seg(
        v, jnp.asarray(p2v), jnp.asarray(perm), jnp.asarray(grid.counts)),
        jnp.asarray(vox))
    (dvox,) = vjp(jnp.asarray(dpts))
    return dict(vox=vox, dpts=dpts, p2v=p2v, perm=perm, counts=grid.counts,
                ref_fwd=np.asarray(fwd), ref_dvox=np.asarray(dvox))


def _port_devox(v):
    vox = _t(v["vox"]).requires_grad_(True)
    out = devoxelize_seg(vox, _t(v["p2v"]), _t(v["perm"]), _t(v["counts"]))
    out.backward(_t(v["dpts"]))
    return out.detach().numpy(), vox.grad.numpy()


def test_devoxelize_seg_backward_matches_reference(voxels):
    out, dvox = _port_devox(voxels)
    np.testing.assert_array_equal(out, voxels["ref_fwd"])
    ref = voxels["ref_dvox"]
    scale = np.abs(ref).max()
    assert np.abs(dvox - ref).max() <= 1e-5 * scale
    # dropped voxels' rows and empty capacity rows get no gradient
    assert not dvox[voxels["counts"] == 0].any()
    out2, dvox2 = _port_devox(voxels)
    assert dvox.tobytes() == dvox2.tobytes()
