"""The port's point -> 2D mask rendering against the reference's.

- ``projection``: f32, max|d| <= 1e-6 * max|ref|;
- ``ball_query_2d``: indices equal (the first ``nsample`` hits in index
  order among ``supports[:points_num]``), on random clouds, on a grid
  whose distances fall on the radius exactly, and with small query
  bands and blocks (the same indices); and against the
  reference's compiled query at a pair whose fused squared distance is
  the radius's square;
- ``point2mask_module``: masks within 1e-6 of the reference's, and the
  gradient of a weighted sum of the masks with respect to ``features``
  against ``jax.grad``, max|d| <= 1e-5 * max|ref|; ``neighbours`` and
  ``masks_from_neighbours`` give the module's masks;
- the three front ends (``Point2Mask`` over instance labels, ``Box2Mask``
  over corner boxes with the purity and density filters, ``Pixel2Mask``
  over binary images): masks within 1e-6 of max|ref|;
- each front end refuses ``cuda`` without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdwss.ops import point2mask as ref
from tdwss_torch.ops import point2mask as p2m


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    d = np.abs(got - want).max() if got.size else 0.0
    assert d <= tol * max(np.abs(want).max(), 1e-30), (d, np.abs(want).max())


def test_projection():
    rng = np.random.default_rng(0)
    pc = rng.normal(size=(2, 300, 3)).astype(np.float32)
    theta = rng.uniform(0, 6, 4).astype(np.float32)
    phi = rng.uniform(-1, 1, 4).astype(np.float32)
    want = ref.projection(jnp.asarray(pc), jnp.asarray(theta),
                          jnp.asarray(phi), 1.3)
    got = p2m.projection(torch.from_numpy(pc), torch.from_numpy(theta),
                         torch.from_numpy(phi), 1.3)
    _close(got.numpy(), want, 1e-6)


@pytest.mark.parametrize("chunk", [None, (13, 7 * 5)])
def test_ball_query_2d_indices_equal(chunk, monkeypatch):
    if chunk is not None:
        monkeypatch.setattr(p2m, "_QUERY_CHUNK", chunk[0])
        monkeypatch.setattr(p2m, "_CHUNK_ELEMS", chunk[1])
    rng = np.random.default_rng(1)
    cases = [(rng.uniform(0, 10, (200, 2)), rng.uniform(0, 10, (97, 2)),
              1.5, 4, 80)]
    # integer grids: many distances land on the radius exactly
    g = np.stack(np.meshgrid(np.arange(12), np.arange(12)), -1).reshape(-1, 2)
    cases.append((g + 0.5, rng.permutation(g)[:97] + 0.5, 2.0, 5, 97))
    cases.append((g.astype(float), g[::-1].astype(float), 1.0, 3, 50))
    for q, s, radius, ns, pn in cases:
        q, s = q.astype(np.float32), s.astype(np.float32)
        want = ref.ball_query_2d(jnp.asarray(q), jnp.asarray(s), radius, ns,
                                 pn)
        got = p2m.ball_query_2d(torch.from_numpy(q), torch.from_numpy(s),
                                radius, ns, pn)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got.numpy() >= 0).any() and (got.numpy() == -1).any()


def test_ball_query_2d_at_the_radius_as_compiled():
    """The reference's compiled ball query computes fma(dy, dy, dx * dx);
    at a radius whose square is that value exactly, and one f32 ulp
    below the unfused ``dx * dx + dy * dy``, the pair is a hit in both
    packages."""
    rng = np.random.default_rng(6)
    q = rng.uniform(0, 32, (40, 2)).astype(np.float32)
    s = rng.uniform(0, 32, (60, 2)).astype(np.float32)
    dx = q[:, None, 0] - s[None, :, 0]
    dy = q[:, None, 1] - s[None, :, 1]
    plain = dx * dx + dy * dy
    fused = (dy.astype(np.float64) ** 2 + (dx * dx)).astype(np.float32)
    i, j = np.argwhere(plain > fused)[0]
    radius = float(np.sqrt(np.float64(fused[i, j])))
    assert np.float32(radius * radius) == fused[i, j]
    compiled = jax.jit(ref.ball_query_2d, static_argnums=(2, 3, 4))
    want = np.asarray(compiled(jnp.asarray(q), jnp.asarray(s), radius, 60,
                               60))
    got = p2m.ball_query_2d(torch.from_numpy(q), torch.from_numpy(s), radius,
                            60, 60).numpy()
    np.testing.assert_array_equal(got, want)
    assert j in got[i]


def _module_case(seed=2, b=3, n=60, c=5):
    rng = np.random.default_rng(seed)
    coords = rng.normal(size=(b, n, 2)).astype(np.float32)
    feats = rng.normal(size=(b, n, c)).astype(np.float32)
    pn = np.asarray([n, n - 7, n // 2], np.int32)[:b]
    return coords, feats, pn


@pytest.mark.parametrize("res,radius,nsample", [((16, 16), 2.0, 3),
                                                ((12, 20), 3.0, 5)])
def test_point2mask_module_masks_and_gradients(res, radius, nsample):
    coords, feats, pn = _module_case()
    weight = np.random.default_rng(3).normal(
        size=(coords.shape[0],) + res + (2,)).astype(np.float32)

    def loss(f):
        m = ref.point2mask_module(jnp.asarray(coords), f, res,
                                  jnp.asarray(pn), radius=radius,
                                  nsample=nsample)
        return jnp.sum(m * weight), m

    (_, want), g_ref = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(feats))
    f = torch.from_numpy(feats).requires_grad_(True)
    got = p2m.point2mask_module(torch.from_numpy(coords), f, res,
                                torch.from_numpy(pn), radius=radius,
                                nsample=nsample)
    (got * torch.from_numpy(weight)).sum().backward()
    _close(got.detach().numpy(), want, 1e-6)
    assert (np.asarray(want)[..., 0] == 1).any()      # background pixels
    _close(f.grad.numpy(), g_ref, 1e-5)
    assert np.abs(np.asarray(g_ref)).max() > 0
    idx = p2m.neighbours(torch.from_numpy(coords), res, torch.from_numpy(pn),
                         radius, nsample)
    again = p2m.masks_from_neighbours(idx, torch.from_numpy(feats), res)
    assert torch.equal(again, got.detach())


def test_point2mask_front_end():
    rng = np.random.default_rng(4)
    xyz = rng.normal(size=(2, 200, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 200, 6)).astype(np.float32)
    labels = rng.integers(0, 3, (2, 200))
    theta = rng.uniform(0, 6, 2).astype(np.float32)
    phi = rng.uniform(-1, 1, 2).astype(np.float32)
    want = ref.Point2Mask(radius=4, nsample=3)(xyz, feats, labels, 16,
                                               theta, phi)
    got = p2m.Point2Mask(radius=4, nsample=3, device="cpu")(
        xyz, feats, labels, 16, theta, phi)
    assert got.shape == (12, 3, 16, 16)
    _close(got.numpy(), want, 1e-6)


def test_box2mask_front_end():
    rng = np.random.default_rng(5)
    xyz = rng.uniform(0, 1, (2, 400, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 400, 4)).astype(np.float32)
    feats[0, :200, 0] += 3.0                    # a pure half-scene
    boxes = np.asarray([[[0, 0, 0, 0.5, 1, 1], [0, 0, 0, 1, 1, 1],
                         [5, 5, 5, 6, 6, 6]],
                        [[0.2, 0.2, 0.2, 0.8, 0.8, 0.8], [0, 0, 0, 1, 1, 1],
                         [0, 0, 0, 0.1, 0.1, 0.1]]], np.float32)
    theta = np.asarray([0.3, 2.0, 4.0], np.float32)
    phi = np.asarray([0.1, -0.4, 0.7], np.float32)
    for bar in ({}, {"purity_lwbnd": 0.4, "density_lwbnd": 300.0}):
        want = ref.Box2Mask(radius=4, nsample=3)(
            xyz, feats, boxes, 16, theta, phi, box_filter_bar=bar)
        got = p2m.Box2Mask(radius=4, nsample=3, device="cpu")(
            xyz, feats, boxes, 16, theta, phi, box_filter_bar=bar)
        assert got.shape == tuple(want.shape) and got.shape[0] > 0
        _close(got.numpy(), want, 1e-6)
    far = np.full((2, 1, 6), 9.0, np.float32)
    empty = p2m.Box2Mask(radius=4, nsample=3, device="cpu")(
        xyz, feats, far, 8, theta, phi)
    assert empty.shape == (0, 3, 8, 8)


def test_pixel2mask_front_end():
    img = np.zeros((3, 32, 32, 3), np.int32)
    img[0, 8:-8, 8:-8] = 255
    img[1, 3:12, 5:30] = 255
    yy, xx = np.mgrid[:32, :32]
    img[2][(yy - 16) ** 2 + (xx - 12) ** 2 < 64] = 255
    for res in (32, 24):
        want = ref.Pixel2Mask(radius=4, nsample=3)(img, res)
        got = p2m.Pixel2Mask(radius=4, nsample=3, device="cpu")(img, res)
        _close(got.numpy(), want, 1e-6)


@pytest.mark.parametrize("cls", [p2m.Point2Mask, p2m.Box2Mask,
                                 p2m.Pixel2Mask])
def test_front_ends_need_a_card_for_cuda(cls):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        cls(radius=4, nsample=3)
