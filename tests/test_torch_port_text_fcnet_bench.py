"""The text-supervised model of the benchmark's ``text_fcnet`` cell
(``MultiLabelContrastive`` over SparseConvFCNet with a ``TextTransformer``)
against the benchmark's plain reference (``portbench/reference/
text_model.py``), on the CPU without JAX, at a tiny size: m=4, depth 7,
``full_scale`` 128, a 2-layer tower of width 64 over 16 tokens, 2 rooms
of 3,000 points a batch, f32, seeded random weights.

One training step of each side on the same batch and weights: the text
features, ``TextContrastive``, the total loss, the scene logits, every
leaf's gradient (the text tower's included) and every leaf after one
Adam step.  Each side sums in its own order (the program's windowed
conv routes and its fused LayerNorm against the reference's per-tap
``index_add`` and plain LayerNorm), so each comparison has a limit a few
times above f32 rounding, and the reference with its text tower in bf16
and the reference with each scene paired with the next scene's
descriptions fall outside them.  Besides: the reference's frozen
tokenizer gives the program's ids, and the traffic generator gives the
same rooms and texts for a seed and others for another.
"""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from portbench.reference import collate, text_check
from portbench.reference.check import collate_params
from portbench.reference.model import Adam, draw_weights, geometry, soft_margin
from portbench.reference.text_collate import (Tokenizer, text_params,
                                              text_rows, tokenize)
from portbench.reference.text_model import (FCNet, TextTower, param_spec,
                                            text_contrastive)
from portbench.traffic.generate_text import generate_text
from tdwss_torch.config import config_from_dict
from tdwss_torch.data.loader import train_batches
from tdwss_torch.data.synthetic import Scene
from tdwss_torch.data.tokenizer import get_tokenizer
from tdwss_torch.data.tokenizer import tokenize as program_tokenize
from tdwss_torch.engine.steps import make_optimizer, text_mask
from tdwss_torch.models.meta_arch import build_model
from tdwss_torch.utils.losses import Classification, TextContrastive

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**31 + 1234

# f32 on both sides, summed in other orders; read at this size: text
# features 6.9e-7, logits 7.1e-6, losses 2.2e-6-3.7e-6, the worst leaf's
# gradient 7.4e-5, a leaf after Adam 3.3e-8 (the bf16 tower reads 1.5e-2
# on the features, the rolled pairing 0.33 on the text loss)
FEATURE_TOL = 1e-5          # max |d| / max |ref|, text features
LOSS_TOL = 3e-5             # relative, TextContrastive and the total
LOGIT_TOL = 1e-4            # max |d| / max |ref|, scene logits
GRAD_TOL = 1e-3             # max |d| / max |ref| per leaf
STEP_TOL = 1e-6             # max |d| per leaf after Adam (lr 1e-3)
# A leaf whose reference gradient's norm is under this share of the
# median leaf's holds rounding noise only (the attention's key bias:
# the softmax ignores a shift that all keys share): its gradient is held
# to that bound on both sides, and it is left out after Adam, whose
# first step (-lr * g / (|g| + eps)) follows the noise's sign.  So are
# entries of other leaves under QUIET of their leaf's largest.
QUIET_LEAF = 1e-3
QUIET = 1e-4


def _load(kind, name):
    with open(os.path.join(REPO, "portbench", kind, name + ".json")) as f:
        return json.load(f)


def _cfgd():
    c = copy.deepcopy(_load("configs", "text_fcnet")["config"])
    c["pointcloud_data"]["batch_size"] = 2
    c["pointcloud_model"].update(m=4, depth=7, full_scale=128)
    c["text_model"].update(width=64, layers=2, context_length=16)
    c["text_data"].update(max_seq_len=16)
    c["engine"].update(max_points=16384, min_level_capacity=256,
                       compute_dtype="float32", collate_workers=1)
    return dict(c, seed=SEED, training_name="text_fcnet_bench")


def _mix(**kw):
    return dict(_load("traffic", "scannet_text_150k_x64"), **kw)


@pytest.fixture(scope="module")
def setup():
    cfgd = _cfgd()
    scenes = generate_text(_mix(num_scenes=2, points_per_scene=3000,
                                texts_per_scene=12), SEED)
    weights = draw_weights(param_spec(cfgd), SEED, "cpu")
    return cfgd, scenes, weights


def _grads_and_step(params, loss, step):
    """Every leaf's gradient, and every leaf after ``step`` (Adam)."""
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in params.items()}
    step()
    return grads, {n: p.detach().clone() for n, p in params.items()}


@pytest.fixture(scope="module")
def program(setup):
    torch.manual_seed(0)
    cfgd, scenes, weights = setup
    cfg = config_from_dict(cfgd)
    model = build_model(cfg, device="cpu")
    params = dict(model.named_parameters())
    assert {n: tuple(p.shape) for n, p in params.items()} == \
        {n: tuple(w.shape) for n, w in weights.items()}
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(weights[n])
    port = [Scene(points=s.points, colors=s.colors, labels=s.labels,
                  name=s.name, texts=list(s.texts)) for s in scenes]
    batch = next(iter(train_batches(port, cfg, 1, prefetch=False))).to(
        torch.device("cpu"))
    opt, _ = make_optimizer(cfg, model, 10)
    model.train()
    logits, (gfeats, tfeats, owners) = model(batch, istrain=True)
    text_loss = TextContrastive(gfeats, tfeats, owners,
                                text_mask=text_mask(batch.text),
                                scene_mask=batch.scene_mask)
    loss = Classification(logits, batch.scene_label, batch.scene_mask) \
        + text_loss
    out = dict(feats=tfeats.detach(), text_loss=float(text_loss.detach()),
               loss=float(loss.detach()), logits=logits.detach())
    out["grads"], out["after"] = _grads_and_step(params, loss, opt.step)
    return out


def _reference(setup, text_precision="float32", rolled=False):
    torch.manual_seed(0)
    cfgd, scenes, weights = setup
    params = {n: w.clone().requires_grad_(True) for n, w in weights.items()}
    net = FCNet(cfgd["pointcloud_model"], params)
    tower = TextTower(cfgd["text_model"], params, text_precision)
    b = collate.train_batch(scenes, collate_params(cfgd), SEED, 1, 0)
    rows = text_rows(scenes, text_params(cfgd), SEED, 1, 0, Tokenizer(),
                     rolled=rolled)
    g = geometry(torch.from_numpy(b.coords), text_check.plan_capacities(cfgd))
    pooled = net.scene_features(g, torch.from_numpy(b.feats),
                                b.scene_label.shape[0])
    logits = net.head(pooled)
    feats = tower.features(torch.from_numpy(rows.tokens))
    text_loss = text_contrastive(pooled, feats, torch.from_numpy(rows.mask))
    loss = soft_margin(logits, torch.from_numpy(b.scene_label)) + text_loss
    out = dict(feats=feats.detach(), text_loss=float(text_loss.detach()),
               loss=float(loss.detach()), logits=logits.detach())
    for p in params.values():
        p.grad = None
    opt = Adam(params, lr=cfgd.get("lr", 1e-3))
    out["grads"], out["after"] = _grads_and_step(
        params, loss, lambda: opt.step({n: p.grad for n, p in
                                        params.items()}))
    return out


@pytest.fixture(scope="module")
def reference(setup):
    return _reference(setup)


def _gap(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def test_text_features(program, reference):
    assert _gap(program["feats"], reference["feats"]) < FEATURE_TOL


@pytest.mark.parametrize("name", ["text_loss", "loss"])
def test_losses(program, reference, name):
    assert abs(program[name] - reference[name]) \
        < LOSS_TOL * abs(reference[name])


def test_scene_logits(program, reference):
    assert _gap(program["logits"], reference["logits"]) < LOGIT_TOL


def _quiet(grads):
    norms = {n: float(g.norm()) for n, g in grads.items()}
    bound = QUIET_LEAF * float(np.median(list(norms.values())))
    return {n for n, v in norms.items() if v < bound}, bound


def test_every_gradient(program, reference):
    quiet, bound = _quiet(reference["grads"])
    assert quiet <= {n for n in reference["grads"] if n.endswith(
        "attn.key.bias")}
    gaps = {n: _gap(program["grads"][n], g)
            for n, g in reference["grads"].items() if n not in quiet}
    assert max(gaps.values()) < GRAD_TOL, sorted(
        gaps.items(), key=lambda kv: -kv[1])[:5]
    assert any(n.startswith("text_encoder.") for n in gaps)
    for n in quiet:
        assert float(program["grads"][n].norm()) < bound, n


def test_every_leaf_after_adam(program, reference):
    quiet, _ = _quiet(reference["grads"])
    for n, after in reference["after"].items():
        if n in quiet:
            continue
        g = reference["grads"][n]
        loud = g.abs() >= QUIET * g.abs().max()
        d = (program["after"][n] - after).abs()[loud]
        assert float(d.max()) < STEP_TOL, n


def test_bf16_text_tower_falls_outside(setup, program):
    bf16 = _reference(setup, text_precision="bf16")
    assert _gap(program["feats"], bf16["feats"]) > 10 * FEATURE_TOL


def test_rolled_pairing_falls_outside(setup, program):
    rolled = _reference(setup, rolled=True)
    assert abs(program["text_loss"] - rolled["text_loss"]) \
        > 10 * LOSS_TOL * abs(rolled["text_loss"])


@pytest.mark.parametrize("length,vocab", [(120, 49408), (16, 49408),
                                          (24, 500)])
def test_frozen_tokenizer_gives_the_programs_ids(length, vocab):
    scenes = generate_text(_mix(num_scenes=3, points_per_scene=2000), 7)
    texts = [t for s in scenes for t in s.texts] + ["café, naïve & <b>"]
    ours = tokenize(Tokenizer(), texts, length, vocab)
    theirs = program_tokenize(texts, length, tokenizer=get_tokenizer(),
                              vocab_size=vocab)
    np.testing.assert_array_equal(ours, theirs)


def test_generator_repeats_a_seed_and_not_another():
    mix = _mix(num_scenes=3, points_per_scene=2000)
    a, b, c = (generate_text(mix, s) for s in (SEED, SEED, SEED + 1))
    for x, y in zip(a, b):
        assert x.texts == y.texts
        np.testing.assert_array_equal(x.points, y.points)
    assert all(x.texts != z.texts for x, z in zip(a, c))
    assert all(len(s.texts) >= 10 for s in a + c)


def test_description_lengths():
    """The mix's lengths in words: mean near ScanRefer's 20 and a tail
    past 60 (4,096 descriptions)."""
    scenes = generate_text(_mix(points_per_scene=500), 11)
    words = np.array([len(t.split()) for s in scenes for t in s.texts])
    assert words.size == 64 * 64
    assert 18 < words.mean() < 23 and words.max() > 60 and words.min() >= 3


def test_config_is_the_yaml():
    from tdwss_torch.config import load_config

    ours = config_from_dict(_load("configs", "text_fcnet")["config"])
    yaml = load_config(os.path.join(
        REPO, "configs", "3DUNetWithText_scannet_fcnet.yaml"))
    assert dataclasses.replace(ours, training_name=yaml.training_name) \
        == yaml
