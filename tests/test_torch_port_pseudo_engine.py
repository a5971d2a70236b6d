"""The pseudo-label stage against the reference, with the same seeded
parameters (carried over by ``flax_to_state_dict``), the same scenes and
the same thresholds, at ``configs/smoke_cpu.yaml``'s size (MultiLabel
over SparseConvFCNet, m=4, depth 3) on 3 synthetic scenes of 3,000
points:

- ``threshold_sweep``: per threshold, the generated and correct counts;
- ``generate_pseudo_labels``: every scene's label file, and the returned
  counts.

The two packages' logits agree to f32 rounding, so a point may fall on
the other side of a threshold where its confidence lies within 1e-5 of
it, or take the other label where its top two scores lie within 1e-5 of
each other.  The counts and labels must be equal except at such points
(counted from the reference's scores), and those must stay under 0.1%
of the points.  The train-augmented sweep is held to the reference's in
the same way, on the train loader's augmented views; both refuse it
under label ``pseudo``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests._torch_port_common import _random_variables
from tdwss.config import load_config as ref_load_config
from tdwss.data.dataset import val_offsets as ref_val_offsets
from tdwss.data.loader import train_batches as ref_train_batches
from tdwss.data.loader import val_batches as ref_val_batches
from tdwss.data.synthetic import make_dataset as ref_make_dataset
from tdwss.engine import pseudo as ref_pseudo
from tdwss.engine.steps import make_eval_step
from tdwss.models import build_model as ref_build_model
from tdwss.ops.host_plan import reset_sticky_plans as ref_reset
from tdwss.ops.sparse_conv import force_einsum
from tdwss_torch.config import load_config
from tdwss_torch.convert import flax_to_state_dict
from tdwss_torch.data.synthetic import make_dataset
from tdwss_torch.engine import pseudo
from tdwss_torch.models.meta_arch import build_model
from tdwss_torch.ops.host_plan import reset_sticky_plans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "smoke_cpu.yaml")
NEAR = 1e-5
THRESHOLDS = np.linspace(0.5, 0.6, 5)
GEN_THRESHOLD = 0.55


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    ref_cfg = ref_load_config(CONFIG, plan_cache_batches=0,
                              collate_workers=1)
    cfg = load_config(CONFIG)
    ref_scenes = ref_make_dataset(3, num_points=3000, seed=77,
                                  with_text=False)
    scenes = make_dataset(3, num_points=3000, seed=77, with_text=False)
    offsets, gt = ref_val_offsets(ref_scenes)
    ref_reset()
    batches = [jax.tree_util.tree_map(jnp.asarray, b) for b in
               ref_val_batches(ref_scenes, ref_cfg, offsets, 0,
                               prefetch=False)]
    model = ref_build_model(ref_cfg)
    with force_einsum():
        shapes = jax.eval_shape(
            lambda r, b: model.init(r, b, istrain=False),
            jax.random.PRNGKey(0), batches[0])
    rng = np.random.default_rng(2)
    params = _random_variables(shapes["params"], rng)
    stats = _random_variables(shapes["batch_stats"], rng)
    # the reference's per-point scores on the val views, by point id
    logits_fn = jax.jit(make_eval_step(model))
    conf_all = np.full(int(offsets[-1]), np.nan, np.float32)
    gap_all = np.full(int(offsets[-1]), np.inf, np.float32)
    for b in batches:
        s = np.asarray(ref_pseudo.preprocess_logits(
            logits_fn(params, stats, b), b.scene_label, b.coords[:, 3]))
        top2 = -np.sort(-s, axis=1)[:, :2]
        pid = np.asarray(b.point_ids)
        ok = np.asarray(b.valid) & (pid >= 0)
        conf_all[pid[ok]] = top2[ok, 0]
        gap_all[pid[ok]] = (top2[:, 0] - top2[:, 1])[ok]
    out = tmp_path_factory.mktemp("pseudo")
    ref_reset()
    sweep = ref_pseudo.threshold_sweep(
        ref_cfg, model, params, stats, ref_scenes, thresholds=THRESHOLDS,
        plot_path=str(out / "ref.jpg"), verbose=False)
    ref_reset()
    gen = ref_pseudo.generate_pseudo_labels(
        ref_cfg, model, params, stats, ref_scenes, threshold=GEN_THRESHOLD,
        saving_path=str(out / "ref"), verbose=False)
    port = build_model(cfg, device="cpu")
    port.load_state_dict(flax_to_state_dict(params, stats))
    return dict(cfg=cfg, ref_cfg=ref_cfg, scenes=scenes, model=port,
                ref_model=model, params=params, stats=stats,
                ref_scenes=ref_scenes, conf=conf_all, gap=gap_all, gt=gt,
                sweep=sweep, gen=gen, out=out, offsets=offsets)


def _near(setup, thresholds):
    """Points within NEAR of any of ``thresholds``, and points whose top
    two scores lie within NEAR of each other."""
    conf = setup["conf"]
    near_t = np.zeros(conf.shape, bool)
    for t in thresholds:
        near_t |= np.abs(conf - np.float32(t)) <= NEAR
    return near_t, setup["gap"] <= NEAR


def test_threshold_sweep_matches_reference(setup):
    reset_sticky_plans()
    got = pseudo.threshold_sweep(
        setup["cfg"], setup["model"], setup["scenes"],
        thresholds=THRESHOLDS, plot_path=str(setup["out"] / "port.jpg"),
        verbose=False, device="cpu")
    ref = setup["sweep"]
    total = got["total"]
    near_t, tie = _near(setup, THRESHOLDS)
    assert (near_t | tie).sum() <= 1e-3 * setup["conf"].shape[0]
    ref_gen = np.round(ref["labelnum_prop"] * total).astype(np.int64)
    np.testing.assert_array_equal(got["thresholds"], ref["thresholds"])
    assert np.abs(got["generated"] - ref_gen).max() <= near_t.sum()
    ref_corr = np.round(ref["correct_prop"]
                        * np.maximum(ref_gen, 1)).astype(np.int64)
    assert np.abs(got["correct"] - ref_corr).max() <= (near_t | tie).sum()
    assert got["generated"][0] > got["generated"][-1] > 0
    np.testing.assert_allclose(got["labelnum_prop"],
                               got["generated"] / total)


def test_generate_pseudo_labels_matches_reference(setup):
    reset_sticky_plans()
    out = setup["out"] / "port"
    got = pseudo.generate_pseudo_labels(
        setup["cfg"], setup["model"], setup["scenes"],
        threshold=GEN_THRESHOLD, saving_path=str(out), verbose=False,
        device="cpu")
    near_t, tie = _near(setup, [GEN_THRESHOLD])
    amb = near_t | tie
    assert amb.sum() <= 1e-3 * amb.shape[0]
    ref_gen, ref_corr, ref_total = setup["gen"]
    assert got[2] == ref_total
    assert abs(got[0] - ref_gen) <= near_t.sum()
    assert abs(got[1] - ref_corr) <= amb.sum()
    assert got[0] > 0
    off = setup["offsets"]
    suffix = setup["cfg"].suffix
    for i, scene in enumerate(setup["scenes"]):
        mine = np.load(out / (scene.name + suffix))
        ref = np.load(setup["out"] / "ref" / (scene.name + suffix))
        assert mine.dtype == ref.dtype and mine.shape == ref.shape
        differ = mine != ref
        assert not (differ & ~amb[off[i]:off[i + 1]]).any(), scene.name


def test_train_augmented_sweep_refused_under_pseudo_labels(setup):
    cfg = load_config(CONFIG, label="pseudo")
    ref_cfg = ref_load_config(CONFIG, label="pseudo")
    with pytest.raises(ValueError, match="ground-truth"):
        pseudo.threshold_sweep(cfg, setup["model"], setup["scenes"],
                               train_augmented=True, device="cpu",
                               verbose=False)
    with pytest.raises(ValueError, match="ground-truth"):
        ref_pseudo.threshold_sweep(ref_cfg, setup["ref_model"],
                                   setup["params"], setup["stats"],
                                   setup["ref_scenes"], train_augmented=True,
                                   verbose=False)


def test_train_augmented_sweep_runs(setup):
    """The train-augmented sweep against the reference's on the same
    augmented views (the two train loaders give equal batches), with the
    near-threshold and tie allowance counted from the reference's scores
    on those views."""
    ref_cfg = dataclasses.replace(
        setup["ref_cfg"], engine=dataclasses.replace(
            setup["ref_cfg"].engine, slim_train_batch=False))
    logits_fn = jax.jit(make_eval_step(setup["ref_model"]))
    ref_reset()
    near_t = tie = n_valid = 0
    for b in ref_train_batches(setup["ref_scenes"], ref_cfg, epoch=0,
                               prefetch=False):
        b = jax.tree_util.tree_map(jnp.asarray, b)
        s = np.asarray(ref_pseudo.preprocess_logits(
            logits_fn(setup["params"], setup["stats"], b), b.scene_label,
            b.coords[:, 3]))
        top2 = -np.sort(-s, axis=1)[:, :2]
        ok = np.asarray(b.valid)
        n_valid += int(ok.sum())
        near = np.zeros(ok.shape, bool)
        for t in THRESHOLDS:
            near |= np.abs(top2[:, 0] - np.float32(t)) <= NEAR
        near_t += int((near & ok).sum())
        tie += int((((top2[:, 0] - top2[:, 1]) <= NEAR) & ok & ~near).sum())
    assert near_t + tie <= 1e-3 * n_valid
    ref_reset()
    ref = ref_pseudo.threshold_sweep(
        setup["ref_cfg"], setup["ref_model"], setup["params"],
        setup["stats"], setup["ref_scenes"], thresholds=THRESHOLDS,
        plot_path=str(setup["out"] / "ref_aug.jpg"), verbose=False,
        train_augmented=True)
    reset_sticky_plans()
    got = pseudo.threshold_sweep(
        setup["cfg"], setup["model"], setup["scenes"],
        thresholds=THRESHOLDS, plot_path=str(setup["out"] / "aug.jpg"),
        verbose=False, train_augmented=True, device="cpu")
    assert got["total"] == n_valid
    assert got["generated"].shape == (len(THRESHOLDS),)
    assert (np.diff(got["generated"]) <= 0).all()
    assert got["generated"][0] > got["generated"][-1] > 0
    ref_gen = np.round(ref["labelnum_prop"] * n_valid).astype(np.int64)
    assert np.abs(got["generated"] - ref_gen).max() <= near_t
    ref_corr = np.round(ref["correct_prop"]
                        * np.maximum(ref_gen, 1)).astype(np.int64)
    assert np.abs(got["correct"] - ref_corr).max() <= near_t + tie
