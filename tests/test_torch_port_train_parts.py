"""The training step's parts against the reference: scene pooling, the
loss, the train augmentation and collate, the train-batch slimming, the
learning-rate schedule and the state_dict <-> flax conversion.

Tolerances: pooling and loss f32 rtol = atol = 1e-6 (the same f32
reductions in another order); augmentation and collate exact (the same
numpy draws in the same order); the schedule exact.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_common import _cfgs
from tdwss.data.augment import color_jitter as ref_color_jitter
from tdwss.data.augment import elastic as ref_elastic
from tdwss.data.augment import train_transform as ref_train_transform
from tdwss.data.collate import train_collate as ref_train_collate
from tdwss.data.plans import attach_host_plans as ref_attach
from tdwss.data.plans import slim_batch_for_train as ref_slim
from tdwss.data.synthetic import make_dataset as ref_make_dataset
from tdwss.engine.steps import make_lr_schedule as ref_schedule
from tdwss.ops.host_plan import reset_sticky_plans as ref_reset
from tdwss.ops.segment import segment_mean_weighted as ref_pool
from tdwss.utils.losses import Classification as ref_classification
from tdwss_torch.convert import flax_to_state_dict, state_dict_to_flax
from tdwss_torch.data.augment import color_jitter, elastic, train_transform
from tdwss_torch.data.collate import train_collate
from tdwss_torch.data.plans import attach_host_plans, slim_batch_for_train
from tdwss_torch.data.synthetic import make_dataset
from tdwss_torch.engine.steps import make_lr_schedule, make_optimizer
from tdwss_torch.models.meta_arch import build_model
from tdwss_torch.ops.host_plan import reset_sticky_plans
from tdwss_torch.ops.segment import segment_mean_weighted
from tdwss_torch.utils.losses import Classification

TIGHT = dict(rtol=1e-6, atol=1e-6)


def test_segment_mean_weighted_matches_reference():
    rng = np.random.default_rng(0)
    n, b = 500, 4
    feats = rng.normal(size=(n, 7)).astype(np.float32)
    ids = rng.integers(0, b - 1, n).astype(np.int16)    # scene 3 empty
    counts = rng.integers(0, 5, n).astype(np.int32)
    valid = rng.random(n) > 0.2
    ref = ref_pool(jnp.asarray(feats), jnp.asarray(ids).astype(jnp.int32),
                   jnp.asarray(counts), b, jnp.asarray(valid))
    out = segment_mean_weighted(torch.from_numpy(feats),
                                torch.from_numpy(ids),
                                torch.from_numpy(counts), b,
                                torch.from_numpy(valid))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TIGHT)
    assert not out[3].any()


@pytest.mark.parametrize("masked", [False, True])
def test_classification_loss_and_gradient_match_reference(masked):
    import jax

    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(5, 20)) * 3).astype(np.float32)
    labels = (rng.random((5, 20)) > 0.7).astype(np.float32)
    mask = np.array([True, True, False, True, True]) if masked else None
    ref, ref_g = jax.value_and_grad(lambda x: ref_classification(
        x, jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask)))(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    out = Classification(x, torch.from_numpy(labels),
                         None if mask is None else torch.from_numpy(mask))
    out.backward()
    np.testing.assert_allclose(float(out.detach()), float(ref), **TIGHT)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_g), **TIGHT)
    # 1-D labels dispatch to the point cross-entropy, as the reference's
    point_labels = np.array([3, -100, 7, 0, 19])
    got = Classification(x.detach(), torch.from_numpy(point_labels))
    want = ref_classification(jnp.asarray(logits), jnp.asarray(point_labels))
    np.testing.assert_allclose(float(got), float(want), **TIGHT)


def test_train_transform_and_jitter_match_reference():
    pts = np.random.default_rng(2).normal(size=(3000, 3)).astype(np.float32)
    cols = np.random.default_rng(3).uniform(-1, 1, (3000, 3)).astype(
        np.float32)
    a, keep, tf = train_transform(pts, 20, 4096, np.random.default_rng(4))
    ra, rkeep, rtf = ref_train_transform(pts, 20, 4096,
                                         np.random.default_rng(4))
    np.testing.assert_array_equal(a, ra)
    np.testing.assert_array_equal(keep, rkeep)
    np.testing.assert_array_equal(tf["rot_inv"], rtf["rot_inv"])
    np.testing.assert_array_equal(tf["offset"], rtf["offset"])
    np.testing.assert_array_equal(
        color_jitter(cols, np.random.default_rng(5)),
        ref_color_jitter(cols, np.random.default_rng(5)))
    # elastic runs before the translation, on points of a few metres
    # times the scale (its noise grid spans max|x| / granularity cells)
    x = pts[:500] * 20
    np.testing.assert_array_equal(
        elastic(x, 20 * 6 // 50, 40 * 20 / 50, np.random.default_rng(6)),
        ref_elastic(x, 20 * 6 // 50, 40 * 20 / 50, np.random.default_rng(6)))


@pytest.fixture(scope="module")
def batches():
    ref_cfg, port_cfg = _cfgs("float32")
    ref_cfg.engine.compute_dtype = port_cfg.engine.compute_dtype = "bfloat16"
    ref_scenes = ref_make_dataset(2, num_points=3000, seed=103,
                                  with_text=False)
    scenes = make_dataset(2, num_points=3000, seed=103, with_text=False)
    ref_reset()
    ref_b = ref_attach(ref_train_collate(ref_scenes, ref_cfg,
                                         np.random.default_rng(9)), ref_cfg)
    reset_sticky_plans()
    port_b = attach_host_plans(train_collate(scenes, port_cfg,
                                             np.random.default_rng(9)),
                               port_cfg)
    return ref_cfg, port_cfg, ref_b, port_b


def test_train_collate_matches_reference(batches):
    _, _, ref_b, port_b = batches
    for name in ("coords", "feats", "valid", "scene_label", "scene_mask",
                 "point_label", "point_ids", "vox_feats", "point2voxel",
                 "point_perm"):
        np.testing.assert_array_equal(getattr(port_b, name),
                                      np.asarray(getattr(ref_b, name)),
                                      err_msg=name)
    for ref_l, lvl in zip(ref_b.plans.levels, port_b.plans.levels):
        np.testing.assert_array_equal(lvl.grid.valid, ref_l.grid.valid)
        assert (lvl.win is None) == (ref_l.win is None)
        if lvl.win is not None:
            np.testing.assert_array_equal(lvl.win.rb_local,
                                          ref_l.win.rb_local)


def test_slim_batch_for_train_matches_reference(batches):
    ref_cfg, port_cfg, ref_b, port_b = batches
    ref_s = ref_slim(ref_b, ref_cfg)
    port_s = slim_batch_for_train(port_b, port_cfg)
    for name in ("coords", "feats", "valid", "point_label", "point_ids",
                 "point2voxel", "point_perm", "scene_label", "scene_mask"):
        got, want = getattr(port_s, name), np.asarray(getattr(ref_s, name))
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert port_s.vox_feats.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        port_s.vox_feats.float().numpy(),
        np.asarray(ref_s.vox_feats).astype(np.float32))
    moved = port_s.to("cpu")
    assert moved.vox_feats.dtype == torch.bfloat16
    assert moved.plans.levels[0].win.rb_local.dtype == torch.int32


@pytest.mark.parametrize("label", ["scene_level", "pseudo"])
@pytest.mark.parametrize("model_name", ["MultiLabel", "MultiLabelContrastive",
                                        "FullySupervised"])
def test_slim_batch_keeps_what_each_model_reads(batches, model_name, label):
    """Which point leaves survive follows the model's training step, as
    the reference's registry flags decide it."""
    ref_cfg, port_cfg, ref_b, port_b = batches
    ref_cfg, port_cfg = copy.deepcopy(ref_cfg), copy.deepcopy(port_cfg)
    ref_cfg.model_name = port_cfg.model_name = model_name
    ref_cfg.label = port_cfg.label = label
    ref_s = ref_slim(ref_b, ref_cfg)
    port_s = slim_batch_for_train(port_b, port_cfg)
    for name in ("coords", "valid", "point_label", "point2voxel",
                 "point_perm"):
        got, want = getattr(port_s, name), np.asarray(getattr(ref_s, name))
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_lr_schedule_and_optimizer_match_reference():
    _, port_cfg = _cfgs("float32")
    ref_cfg, _ = _cfgs("float32")
    ours, ref = make_lr_schedule(port_cfg, 7), ref_schedule(ref_cfg, 7)
    for step in (0, 1, 699, 700, 1400, 2099, 5000):
        assert ours(step) == float(ref(step)), step
    model = torch.nn.Linear(2, 2)
    opt, sched = make_optimizer(port_cfg, model, 7)
    lrs = []
    for _ in range(1401):
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    assert lrs[0] == lrs[699] == port_cfg.lr
    assert lrs[700] == ours(700) and lrs[1400] == ours(1400)
    group = opt.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8


def test_state_dict_round_trips_through_flax_layout():
    _, port_cfg = _cfgs("float32")
    model = build_model(port_cfg, seed=3, device="cpu")
    sd = model.state_dict()
    params, stats = state_dict_to_flax(sd)
    assert params["linear"]["kernel"].shape == (8, 20)
    assert "scale" in params["pc_encoder"]["final_bnrelu"]["bn"]
    assert "mean" in stats["pc_encoder"]["final_bnrelu"]["bn"]
    back = flax_to_state_dict(params, stats)
    assert back.keys() == sd.keys()
    for name, t in sd.items():
        torch.testing.assert_close(back[name], t, rtol=0, atol=0)
