"""``MultiLabelContrastive`` and its batch against the reference.

- The text collate: ``train_collate``'s ``TextBatch`` (a scene whose
  descriptions are cropped to ``cropped_texts``, one with padded slots,
  one without texts) bit for bit equal to the reference's, with the rest
  of the batch unchanged; ``slim_batch_for_train`` and ``.to`` keep it,
  its tokens int32.
- One f32 training step (UNet m=4, full_scale 64, a 2-layer text tower
  of width 64, vocab 1,000, 4 slots of 16 tokens, Classification +
  TextContrastive, Adam) against the reference's ``make_train_step`` from
  the same seeded parameters: the loss and its ``cls_loss`` /
  ``text_loss`` parts within rtol 1e-5, every parameter gradient and
  every batch-norm statistic after the step within rtol = atol = 1e-4,
  as in ``test_torch_port_train.py``.
- Three Adam steps on that batch, and on an FCNet case whose text loss
  rises after the first step in both packages, each taken by the port
  from the reference's state: loss parts, gradients and statistics as
  above, and the port's Adam given the reference's gradient lands every
  parameter within rtol = atol = 1e-4 of the reference's.
- The same step with ``TextContrastive`` off leaves the text tower's
  parameters where they were (no gradient; Adam skips them), as the
  reference's zero gradients leave them.
- ``convert.py`` carries every leaf of the model's tree, text tower
  included, both ways exactly.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_common import _random_variables
from tdwss.config import Config as RefConfig
from tdwss.config import EngineConfig as RefEngine
from tdwss.config import LossConfig as RefLoss
from tdwss.config import PointcloudDataConfig as RefPcData
from tdwss.config import PointcloudModelConfig as RefPcModel
from tdwss.config import TextDataConfig as RefTextData
from tdwss.config import TextModelConfig as RefTextModel
from tdwss.data.collate import train_collate as ref_train_collate
from tdwss.data.plans import attach_host_plans as ref_attach
from tdwss.data.plans import slim_batch_for_train as ref_slim
from tdwss.data.synthetic import make_dataset as ref_make_dataset
from tdwss.engine.steps import TrainState, make_train_step
from tdwss.engine.steps import make_optimizer as ref_make_optimizer
from tdwss.models import build_model as ref_build_model
from tdwss.ops.host_plan import reset_sticky_plans as ref_reset
from tdwss.ops.sparse_conv import force_einsum
from tdwss_torch import config as pc
from tdwss_torch.convert import flax_to_state_dict, state_dict_to_flax
from tdwss_torch.data.batch import TextBatch
from tdwss_torch.data.collate import train_collate
from tdwss_torch.data.plans import attach_host_plans, slim_batch_for_train
from tdwss_torch.data.synthetic import make_dataset
from tdwss_torch.engine.steps import make_optimizer, train_step
from tdwss_torch.models.meta_arch import MultiLabelContrastive, build_model
from tdwss_torch.ops.host_plan import reset_sticky_plans

LOSS_RTOL = 1e-5
F32_TOL = dict(rtol=1e-4, atol=1e-4)
STEPS_PER_EPOCH = 100
SLOTS, LENGTH = 4, 16
REPEAT_STEPS = 3
# The FCNet case's point-cloud gradients, per tensor: at its first step one
# level-0 batch-norm output lies 1.1e-6 from the ReLU's kink and falls on
# either side in the two packages; that row's gradient (0.0085) is the
# whole difference (0.5% of the batch-norm bias's norm).  A wrong tap or
# row tile moves a tensor's gradient by tens of percent.
NORM_RTOL = 1e-2


def _leaves(tree, prefix=()):
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _cfgs(batch_size=2, model=None):
    kw = dict(
        data=dict(scale=20, batch_size=batch_size),
        text_data=dict(max_seq_len=LENGTH, cropped_texts=SLOTS),
        model=model or dict(name="SparseConvUNet", m=4, full_scale=64),
        text_model=dict(name="TextTransformer", context_length=LENGTH,
                        width=64, layers=2, vocab_size=1000),
        loss=dict(Classification=True, TextContrastive=True),
        engine=dict(max_points=8192, min_level_capacity=256,
                    compute_dtype="float32"))
    common = dict(model_name="MultiLabelContrastive", has_text=True,
                  label="scene_level")
    ref = RefConfig(pointcloud_data=RefPcData(**kw["data"]),
                    text_data=RefTextData(**kw["text_data"]),
                    pointcloud_model=RefPcModel(**kw["model"]),
                    text_model=RefTextModel(**kw["text_model"]),
                    loss=RefLoss(**kw["loss"]),
                    engine=RefEngine(**kw["engine"], plan_cache_batches=0,
                                     collate_workers=1), **common)
    port = pc.Config(pointcloud_data=pc.PointcloudDataConfig(**kw["data"]),
                     text_data=pc.TextDataConfig(**kw["text_data"]),
                     pointcloud_model=pc.PointcloudModelConfig(**kw["model"]),
                     text_model=pc.TextModelConfig(**kw["text_model"]),
                     loss=pc.LossConfig(**kw["loss"]),
                     engine=pc.EngineConfig(**kw["engine"]), **common)
    return ref, port


def _scenes(make, n, keep_texts):
    """Synthetic scenes with their texts cut to ``keep_texts[i]``."""
    scenes = make(n, num_points=3000, seed=104, with_text=True)
    for scene, k in zip(scenes, keep_texts):
        assert len(scene.texts) >= k
        scene.texts = scene.texts[:k]
    return scenes


@pytest.mark.parametrize("vocab_size", [49408, 1000])
def test_text_collate_matches_reference(vocab_size):
    ref_cfg, port_cfg = _cfgs(batch_size=3)
    ref_cfg.text_model.vocab_size = port_cfg.text_model.vocab_size = \
        vocab_size
    keep = (6, 2, 0)              # cropped, padded slots, no texts
    ref_b = ref_train_collate(_scenes(ref_make_dataset, 3, keep), ref_cfg,
                              np.random.default_rng(3))
    port_b = train_collate(_scenes(make_dataset, 3, keep), port_cfg,
                           np.random.default_rng(3))
    assert isinstance(port_b.text, TextBatch)
    for f in dataclasses.fields(TextBatch):
        got, want = getattr(port_b.text, f.name), getattr(ref_b.text, f.name)
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    tokens = port_b.text.tokens
    assert tokens.shape == (3, SLOTS, LENGTH) and tokens.dtype == np.int32
    slots = (tokens != 0).any(-1).sum(-1)
    assert slots.tolist() == [SLOTS, 2, 0]
    assert port_b.text.valid.tolist() == [True, True, False]
    for name in ("coords", "feats", "valid", "scene_label", "scene_mask",
                 "point_label", "point_ids"):
        np.testing.assert_array_equal(getattr(port_b, name),
                                      getattr(ref_b, name), err_msg=name)

    # a config without text draws the same batch and carries no text
    plain = copy.deepcopy(port_cfg)
    plain.has_text = False
    other = train_collate(_scenes(make_dataset, 3, keep), plain,
                          np.random.default_rng(3))
    assert other.text is None
    np.testing.assert_array_equal(other.coords, port_b.coords)


def test_slim_and_to_keep_the_text():
    _, port_cfg = _cfgs()
    reset_sticky_plans()
    host = slim_batch_for_train(attach_host_plans(train_collate(
        _scenes(make_dataset, 2, (2, 6)), port_cfg,
        np.random.default_rng(0)), port_cfg), port_cfg)
    assert host.text is not None and host.text.tokens.dtype == np.int32
    assert host.coords.shape[0] == 0          # the point leaves are gone
    dev = host.to("cpu", non_blocking=True)
    assert isinstance(dev.text, TextBatch)
    assert dev.text.tokens.dtype == torch.int32
    assert dev.text.has_text.dtype == torch.int32
    assert dev.text.valid.dtype == torch.bool
    np.testing.assert_array_equal(dev.text.tokens.numpy(), host.text.tokens)
    names = {id(t) for t in dev.tensors()}
    assert all(id(getattr(dev.text, f.name)) in names
               for f in dataclasses.fields(TextBatch))


def _reference_steps(ref_cfg, port_cfg):
    """REPEAT_STEPS reference steps on one batch from seeded parameters:
    every state along the way and each step's loss parts, with the port's
    batch from the same scenes and rng."""
    keep = (2, 6)
    ref_reset()
    ref_b = ref_slim(ref_attach(ref_train_collate(
        _scenes(ref_make_dataset, 2, keep), ref_cfg,
        np.random.default_rng(5)), ref_cfg), ref_cfg)
    reset_sticky_plans()
    port_b = slim_batch_for_train(attach_host_plans(train_collate(
        _scenes(make_dataset, 2, keep), port_cfg,
        np.random.default_rng(5)), port_cfg), port_cfg)
    ref_bj = jax.tree_util.tree_map(jnp.asarray, ref_b)
    model = ref_build_model(ref_cfg)
    with force_einsum():
        shapes = jax.eval_shape(
            lambda r, b: model.init(r, b, istrain=True),
            jax.random.PRNGKey(0), ref_bj)
    rng = np.random.default_rng(4)
    params = _random_variables(shapes["params"], rng)
    stats = _random_variables(shapes["batch_stats"], rng)
    tx = ref_make_optimizer(ref_cfg, STEPS_PER_EPOCH)
    states = [TrainState(params=params, batch_stats=stats,
                         opt_state=tx.init(params),
                         step=jnp.zeros((), jnp.int32))]
    ref_step = jax.jit(make_train_step(ref_cfg, model, tx))
    auxes = []
    for _ in range(REPEAT_STEPS):
        state, aux = ref_step(states[-1], ref_bj)
        states.append(state)
        auxes.append({k: float(v) for k, v in aux.items()})
    states = jax.device_get(states)
    return dict(port_cfg=port_cfg, port_b=port_b.to("cpu"), params=params,
                stats=stats, aux=auxes[0],
                grads=jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                             states[1].opt_state[0].mu),
                new_stats=states[1].batch_stats, states=states, auxes=auxes)


@pytest.fixture(scope="module")
def step():
    return _reference_steps(*_cfgs())


@pytest.fixture(scope="module")
def fcnet_step():
    """SparseConvFCNet (m=4, depth 7, full_scale 128: embed_length 112 =
    its width) under the same text tower.  As on the card at full width,
    the text loss rises after the first Adam step here, in both packages
    (unnormalised similarities of 112-wide pooled features)."""
    return _reference_steps(*_cfgs(model=dict(name="SparseConvFCNet", m=4,
                                              full_scale=128)))


def _port_model(step, cfg):
    model = build_model(cfg, device="cpu")
    assert isinstance(model, MultiLabelContrastive)
    model.load_state_dict(flax_to_state_dict(step["params"], step["stats"]))
    return model


def test_contrastive_step_matches_reference(step):
    cfg = step["port_cfg"]
    model = _port_model(step, cfg)
    opt, sched = make_optimizer(cfg, model, STEPS_PER_EPOCH)
    loss, aux = train_step(cfg, model, opt, sched, step["port_b"])
    assert torch.isfinite(loss)
    assert set(aux) == set(step["aux"]) == {"loss", "cls_loss", "text_loss"}
    for key, ref in step["aux"].items():
        np.testing.assert_allclose(float(aux[key]), ref, rtol=LOSS_RTOL,
                                   err_msg=key)
    grads, _ = state_dict_to_flax(
        {n: p.grad for n, p in model.named_parameters()})
    got, want = dict(_leaves(grads)), dict(_leaves(step["grads"]))
    assert got.keys() == want.keys()
    assert any(p[0] == "text_encoder" for p in got)
    for path, g in got.items():
        np.testing.assert_allclose(g, want[path], **F32_TOL,
                                   err_msg="/".join(path))
    _, stats = state_dict_to_flax(model.state_dict())
    got, want = dict(_leaves(stats)), dict(_leaves(step["new_stats"]))
    assert got.keys() == want.keys()
    for path, s in got.items():
        np.testing.assert_allclose(s, want[path], **F32_TOL,
                                   err_msg="/".join(path))


def _load_reference_state(model, opt, state):
    """The reference's parameters, statistics and Adam moments into the
    port's model and optimizer (the schedule's rate is ``cfg.lr`` over
    these steps in both)."""
    model.load_state_dict(flax_to_state_dict(state.params, state.batch_stats))
    adam = state.opt_state[0]
    if int(adam.count) == 0:
        return
    mu = flax_to_state_dict(adam.mu, state.batch_stats)
    nu = flax_to_state_dict(adam.nu, state.batch_stats)
    for name, p in model.named_parameters():
        opt.state[p] = dict(step=torch.tensor(float(adam.count)),
                            exp_avg=mu[name].clone(),
                            exp_avg_sq=nu[name].clone())


def _assert_tree_close(tree, ref, what, by_norm=()):
    """Every leaf within F32_TOL; leaves under a ``by_norm`` prefix within
    NORM_RTOL of their norm instead."""
    got, want = dict(_leaves(tree)), dict(_leaves(ref))
    assert got.keys() == want.keys()
    for path, value in got.items():
        name = f"{what}: " + "/".join(path)
        if path[0] in by_norm:
            ref_norm = np.linalg.norm(want[path])
            assert np.linalg.norm(value - want[path]) <= NORM_RTOL * ref_norm, name
        else:
            np.testing.assert_allclose(value, want[path], **F32_TOL,
                                       err_msg=name)


@pytest.mark.parametrize("case", ["step", "fcnet_step"])
def test_contrastive_steps_track_reference(case, request):
    """Each of REPEAT_STEPS Adam steps on one batch, taken by the port
    from the reference's state before it (parameters, statistics, Adam
    moments): the loss parts within LOSS_RTOL, every gradient (the
    reference's from its moments, (mu' - b1 mu) / (1 - b1)) and the
    statistics after within F32_TOL; and the port's Adam, given the
    reference's gradient, lands every parameter within F32_TOL of the
    reference's.  (Adam applied to each package's own gradient is not
    compared per element: where a gradient is near Adam's eps, as the
    attention key biases' is, zero in exact arithmetic, the update
    normalises rounding noise to up to lr.)  In the FCNet case the
    point-cloud encoder's gradients are held per tensor (NORM_RTOL)."""
    step = request.getfixturevalue(case)
    cfg = step["port_cfg"]
    states, auxes = step["states"], step["auxes"]
    print(f"{case}: reference loss parts per step: {auxes}")
    if case == "fcnet_step":
        assert auxes[1]["text_loss"] > auxes[0]["text_loss"]
    by_norm = ("pc_encoder",) if case == "fcnet_step" else ()
    b1 = 0.9
    for i, (aux_ref, before, after) in enumerate(
            zip(auxes, states, states[1:])):
        model = build_model(cfg, device="cpu")
        opt, sched = make_optimizer(cfg, model, STEPS_PER_EPOCH)
        _load_reference_state(model, opt, before)
        _, aux = train_step(cfg, model, opt, sched, step["port_b"])
        assert aux.keys() == aux_ref.keys()
        for key, ref in aux_ref.items():
            np.testing.assert_allclose(float(aux[key]), ref, rtol=LOSS_RTOL,
                                       err_msg=f"step {i + 1} {key}")
        grads, _ = state_dict_to_flax(
            {n: p.grad for n, p in model.named_parameters()})
        _, stats = state_dict_to_flax(model.state_dict())
        ref_grads = jax.tree_util.tree_map(
            lambda m1, m0: (np.asarray(m1) - b1 * np.asarray(m0)) / (1 - b1),
            after.opt_state[0].mu, before.opt_state[0].mu)
        _assert_tree_close(grads, ref_grads, f"step {i + 1} gradient",
                           by_norm)
        _assert_tree_close(stats, after.batch_stats,
                           f"statistics after step {i + 1}")

        model = build_model(cfg, device="cpu")
        opt, _ = make_optimizer(cfg, model, STEPS_PER_EPOCH)
        _load_reference_state(model, opt, before)
        ref_sd = flax_to_state_dict(ref_grads, after.batch_stats)
        for name, p in model.named_parameters():
            p.grad = ref_sd[name].clone()
        opt.step()
        params, _ = state_dict_to_flax(dict(model.named_parameters()))
        _assert_tree_close(params, after.params,
                           f"parameters after step {i + 1}")


def test_text_tower_stays_without_the_text_loss(step):
    cfg = copy.deepcopy(step["port_cfg"])
    cfg.loss.TextContrastive = False
    model = _port_model(step, cfg)
    text = {n: p.detach().clone() for n, p in model.named_parameters()
            if n.startswith(("text_encoder.", "text_linear."))}
    assert len(text) == 2 * 16 + 2 + 2 + 2  # blocks, embeddings, ln, linear
    opt, sched = make_optimizer(cfg, model, STEPS_PER_EPOCH)
    _, aux = train_step(cfg, model, opt, sched, step["port_b"])
    assert set(aux) == {"loss", "cls_loss"}
    for n, p in model.named_parameters():
        if n in text:
            assert p.grad is None, n
            assert torch.equal(p.detach(), text[n]), n
    assert not torch.equal(model.linear.weight.detach(),
                           torch.from_numpy(step["params"]["linear"]
                                            ["kernel"].T.copy()))


def test_contrastive_tree_converts_both_ways(step):
    sd = flax_to_state_dict(step["params"], step["stats"])
    model = build_model(step["port_cfg"], device="cpu")
    want = model.state_dict()
    assert sd.keys() == want.keys()
    for name, t in sd.items():
        assert t.shape == want[name].shape, name
    params, stats = state_dict_to_flax(sd)
    for got, ref in ((params, step["params"]), (stats, step["stats"])):
        got, ref = dict(_leaves(got)), dict(_leaves(ref))
        assert got.keys() == ref.keys()
        for path, value in got.items():
            assert value.shape == ref[path].shape, path
            np.testing.assert_array_equal(value, ref[path],
                                          err_msg="/".join(path))
    text_leaves = [p for p in dict(_leaves(step["params"]))
                   if p[0] in ("text_encoder", "text_linear")]
    assert {p[-1] for p in text_leaves} == {
        "embedding", "positional_embedding", "scale", "bias", "kernel"}


def test_text_linear_width_must_be_the_encoders():
    """FCNet's registry ``embed_length`` (28 m) is its output width only at
    depth 7; elsewhere the model is refused, naming both widths."""
    _, cfg = _cfgs()
    cfg.pointcloud_model = pc.PointcloudModelConfig(
        name="SparseConvFCNet", m=4, depth=3, full_scale=64)
    with pytest.raises(ValueError, match="embed_length 112.*width is 24"):
        build_model(cfg, device="cpu")
