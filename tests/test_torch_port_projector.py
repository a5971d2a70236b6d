"""The port's box projector against the reference's.

- ``crop_box``: byte-equal coordinates and features for several boxes
  over two scenes, under a random augmentation and axis alignment, with
  a box that holds no point;
- ``voxelize_views`` at resolution 32 with several boxes, some points
  invalid, f32: max|d| <= 1e-6 * max|ref| per view order (HWZ, ZH, W);
- ``Projector`` with the reference's weights converted by
  ``flax_to_state_dict``: the views as above, and the gradients of a
  weighted sum of them with respect to the matting weights and the point
  features against ``jax.grad``, max|d| <= 1e-5 * max|ref|;
- a tie: points of equal matted value in one pixel, where both packages
  split the gradient of the max evenly (the scatter-max fills with
  ``finfo.min`` and includes it);
- ``project_from_batch`` on a collated batch with boxes, with converted
  weights, and the gradient reaching per-point features given as a
  tensor; ``state_dict_to_flax`` gives the reference's tree back;
- the projector refuses ``cuda`` without a card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdwss.config import (Config as RefConfig, EngineConfig as RefEngine,
                          PointcloudDataConfig as RefData,
                          PointcloudModelConfig as RefModel)
from tdwss.data.collate import train_collate as ref_collate
from tdwss.data.synthetic import make_dataset as ref_make_dataset
from tdwss.models import projector as ref
from tdwss_torch import config as pc
from tdwss_torch.convert import flax_to_state_dict, state_dict_to_flax
from tdwss_torch.data.collate import train_collate
from tdwss_torch.data.synthetic import make_dataset
from tdwss_torch.models import projector

RES = 32


def _rot(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * rng.uniform(0.9, 1.1)


def _transform(rng, b):
    rots = np.stack([_rot(rng) for _ in range(b)])
    align = np.tile(np.eye(4), (b, 1, 1))
    align[:, :3, :3] = np.stack([_rot(rng) for _ in range(b)])
    align[:, :3, 3] = rng.normal(size=(b, 3))
    return (align.astype(np.float32),
            rng.normal(size=(b, 3)).astype(np.float32),
            np.linalg.inv(rots).astype(np.float32),
            rng.uniform(10, 50, (b, 3)).astype(np.float32))


def _crop_case(seed=0, n=3000, c=6):
    rng = np.random.default_rng(seed)
    coords = np.concatenate([rng.uniform(0, 60, (n, 3)).round(),
                             rng.integers(0, 2, (n, 1))], 1).astype(np.int32)
    feats = rng.normal(size=(n, c)).astype(np.float32)
    tf = _transform(rng, 2)
    # boxes around the world positions of random points, one far away
    world = []
    for b in range(2):
        sel = coords[coords[:, 3] == b, :3].astype(np.float64)
        pcw = (sel - tf[3][b]) @ tf[2][b] + tf[1][b]
        pcw = np.concatenate([pcw, np.ones((len(pcw), 1))], 1) @ tf[0][b].T
        world.append(pcw[:, :3])
    boxes = []
    for b, k in ((0, 3), (1, 2)):
        for i in rng.choice(len(world[b]), k, replace=False):
            boxes.append(np.concatenate([world[b][i],
                                         rng.uniform(5, 30, 3), [b]]))
    boxes.append([1e4, 1e4, 1e4, 1, 1, 1, 0])
    return coords, feats, np.asarray(boxes, np.float32), tf


def test_crop_box_byte_equal():
    coords, feats, boxes, tf = _crop_case()
    want = ref.crop_box(coords, feats, boxes, tf)
    got = projector.crop_box(coords, feats, boxes, tf)
    assert want[0].shape[0] > 100
    assert len(np.unique(want[0][:, 3])) == len(boxes) - 1
    for w, g in zip(want, got):
        assert (w.dtype, w.shape) == (g.dtype, g.shape)
        assert w.tobytes() == g.tobytes()
    empty = projector.crop_box(coords, feats, boxes[-1:], tf)
    ref_empty = ref.crop_box(coords, feats, boxes[-1:], tf)
    for w, g in zip(ref_empty, empty):
        assert (w.dtype, w.shape) == (g.dtype, g.shape)


def _views_case(seed=1, n=4000, c=5, num_boxes=4):
    rng = np.random.default_rng(seed)
    coords = np.concatenate([rng.uniform(0, 1, (n, 3)),
                             rng.integers(0, num_boxes, (n, 1))], 1)
    coords = coords.astype(np.float32)
    feats = rng.normal(size=(n, c)).astype(np.float32)
    valid = rng.random(n) > 0.1
    return coords, feats, valid, num_boxes


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    d = np.abs(got - want).max()
    assert d <= tol * np.abs(want).max(), (d, np.abs(want).max())


@pytest.mark.parametrize("view", ["HWZ", "ZH", "W"])
def test_voxelize_views(view):
    coords, feats, valid, nb = _views_case()
    want = ref.voxelize_views(jnp.asarray(coords), jnp.asarray(feats),
                              jnp.asarray(valid), RES, nb, view)
    got = projector.voxelize_views(torch.from_numpy(coords),
                                   torch.from_numpy(feats),
                                   torch.from_numpy(valid), RES, nb, view)
    assert got.shape == (len(view) * nb, feats.shape[1], RES, RES)
    assert (np.asarray(want) == 0).mean() > 0.2     # empty pixels occur
    _close(got.numpy(), want, 1e-6)


def _ref_projector(c, seed=0):
    model = ref.Projector(out_channels=2, resolution=RES, view="HWZ")
    rng = np.random.default_rng(seed)
    params = {"matting": {"model": {
        "kernel": rng.normal(size=(c, 2)).astype(np.float32),
        "bias": rng.normal(size=(2,)).astype(np.float32)}}}
    return model, {"params": params}


def _port_projector(c, variables):
    proj = projector.Projector(c, 2, resolution=RES, view="HWZ",
                               device="cpu")
    proj.load_state_dict(flax_to_state_dict(variables["params"]))
    return proj


def _grads_against_jax(coords, feats, valid, nb, seed=2):
    c = feats.shape[1]
    model, variables = _ref_projector(c)
    weight = np.random.default_rng(seed).normal(
        size=(3 * nb, 2, RES, RES)).astype(np.float32)

    def loss(params, f):
        out = model.apply({"params": params}, jnp.asarray(coords), f,
                          jnp.asarray(valid), nb)
        return jnp.sum(out * weight), out

    (_, want), (g_params, g_feats) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(feats))
    proj = _port_projector(c, variables)
    f = torch.from_numpy(feats).requires_grad_(True)
    out = proj(torch.from_numpy(coords), f, torch.from_numpy(valid), nb)
    (out * torch.from_numpy(weight)).sum().backward()
    _close(out.detach().numpy(), want, 1e-6)
    got = {"matting.model.weight": proj.matting.model.weight.grad,
           "matting.model.bias": proj.matting.model.bias.grad}
    want_sd = flax_to_state_dict(jax.device_get(g_params))
    assert set(want_sd) == set(got)
    for k, w in want_sd.items():
        _close(got[k].numpy(), w.numpy(), 1e-5)
    _close(f.grad.numpy(), g_feats, 1e-5)
    return f.grad.numpy(), np.asarray(g_feats)


def test_projector_views_and_gradients():
    coords, feats, valid, nb = _views_case(seed=3, n=3000, c=20)
    _grads_against_jax(coords, feats, valid, nb)


def test_tied_maxima_split_the_gradient():
    # four points: two in one voxel (their mean), and two more voxels in
    # the same Z-view pixel with the same features, so their matted
    # values tie in that pixel
    coords = np.asarray([[0.50, 0.50, 0.10, 0], [0.50, 0.50, 0.10, 0],
                         [0.50, 0.50, 0.60, 0], [0.50, 0.50, 0.90, 0],
                         [0.20, 0.70, 0.30, 1]], np.float32)
    feats = np.asarray([[1.0, 2.0], [1.0, 2.0], [1.0, 2.0], [1.0, 2.0],
                        [0.5, -1.0]], np.float32)
    valid = np.ones(5, bool)
    g, g_ref = _grads_against_jax(coords, feats, valid, 2)
    # the Z view's tied pixel sends a third of its cotangent to each of
    # the three voxels; the two points of one voxel share their third
    assert np.abs(g[0] - g[1]).max() == 0
    assert np.abs(g_ref[0] - g_ref[1]).max() == 0


def _batch_pair():
    kw = dict(data=dict(scale=10, batch_size=2, with_boxes=True,
                        max_boxes=3),
              model=dict(name="SparseConvFCNet", m=4, full_scale=256,
                         block_reps=1, residual_blocks=False, depth=3),
              engine=dict(max_points=4096, min_level_capacity=256))
    ref_cfg = RefConfig(model_name="MultiLabel",
                        pointcloud_data=RefData(**kw["data"]),
                        pointcloud_model=RefModel(**kw["model"]),
                        engine=RefEngine(**kw["engine"]))
    cfg = pc.Config(model_name="MultiLabel",
                    pointcloud_data=pc.PointcloudDataConfig(**kw["data"]),
                    pointcloud_model=pc.PointcloudModelConfig(**kw["model"]),
                    engine=pc.EngineConfig(**kw["engine"]))

    def boxes(scenes):
        out = []
        for s in scenes:
            lo, hi = s.points.min(0), s.points.max(0)
            b = np.stack([np.concatenate([(lo + hi) / 2, (hi - lo) * 1.2]),
                          np.concatenate([s.points.mean(0) + 0.5,
                                          np.full(3, 1.0)])])
            out.append(dataclasses.replace(s, boxes=b.astype(np.float32)))
        return out

    ref_b = ref_collate(boxes(ref_make_dataset(2, 1500, seed=13,
                                               with_text=False)),
                        ref_cfg, np.random.default_rng(1))
    b = train_collate(boxes(make_dataset(2, 1500, seed=13, with_text=False)),
                      cfg, np.random.default_rng(1))
    return ref_b, b


def test_project_from_batch_with_converted_weights():
    ref_b, b = _batch_pair()
    n, c = b.coords.shape[0], 20
    feats = np.random.default_rng(6).normal(size=(n, c)).astype(np.float32)
    model, variables = _ref_projector(c, seed=4)
    want = ref.project_from_batch(ref_b, feats, variables, model)
    proj = _port_projector(c, variables)
    f = torch.from_numpy(feats).requires_grad_(True)
    got = projector.project_from_batch(b.to("cpu"), f, proj)
    m = b.box.concat_boxes().shape[0]
    assert got.shape == (3 * m, 2, RES, RES) == tuple(want.shape)
    _close(got.detach().numpy(), want, 1e-6)
    got.sum().backward()
    assert (f.grad[~torch.from_numpy(b.valid)] == 0).all()
    assert f.grad.abs().sum() > 0
    with pytest.raises(ValueError):
        projector.project_from_batch(dataclasses.replace(b, box=None), f,
                                     proj)
    params, _ = state_dict_to_flax(proj.state_dict())
    for k in ("kernel", "bias"):
        np.testing.assert_array_equal(
            params["matting"]["model"][k],
            variables["params"]["matting"]["model"][k])


def test_projector_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        projector.Projector(4)
