"""The KPConv host side and ops against the reference
(``tdwss.models.kpconv``), on seeded numpy inputs.

- Kernel points: ``load_kernels`` (repulsion and spherical Lloyd, every
  fixing) and ``spherical_lloyd`` bit for bit.
- Native bindings: ``grid_subsample`` (points, features, labels) and
  ``radius_neighbors`` (rows that overflow included) byte-equal to
  ``tdwss.native``; ``segmentation_inputs`` byte-equal on every
  ``KPBatch`` field and ``calibrate_neighbors`` equal; the numpy
  ``grid_subsample`` inside ``native.disabled()`` only.
- ``PotentialSampler``: the same draws for the same seed.
- Ops, f32: ``kpconv_apply`` for each influence (constant, linear,
  gaussian) x aggregation (sum, closest), rigid, with offsets, and with
  offsets and modulations; neighbour lists hold each query itself (a
  zero distance to the centre kernel point, and, where a row's offsets
  at the centre point are 0, a zero distance under ``sqrt`` in the
  deformable case) and shadows; the output, the aux and the gradients
  (features, weights, offsets, modulations) vs ``jax.grad``, NaN where
  the reference gives NaN; ``max_pool``, ``closest_pool``,
  ``global_average`` and ``p2p_fitting_regularizer`` values and
  gradients.  Tolerance: |d| <= 1e-5 * max|ref| + 1e-5 * |ref| (the same
  f32 products summed in another order).
- Ops, f64 (a dtype the reference never runs): ``kpconv_apply`` against
  a direct numpy f64 computation at 1e-12, so no part of it drops to
  f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdwss import native as ref_native
from tdwss.models.kpconv import kernel_points as ref_kp
from tdwss.models.kpconv import ops as ref_ops
from tdwss.models.kpconv.config import KPConvConfig as RefConfig
from tdwss.models.kpconv.pyramid import \
    calibrate_neighbors as ref_calibrate
from tdwss.models.kpconv.pyramid import \
    segmentation_inputs as ref_segmentation_inputs
from tdwss.models.kpconv.sampler import PotentialSampler as RefSampler
from tdwss_torch import native
from tdwss_torch.models.kpconv import kernel_points, ops
from tdwss_torch.models.kpconv.config import KPConvConfig
from tdwss_torch.models.kpconv.pyramid import (calibrate_neighbors,
                                               segmentation_inputs)
from tdwss_torch.models.kpconv.sampler import PotentialSampler

TOL = 1e-5


def _close(got, want, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    scale = np.abs(want[fin]).max() if fin.any() else 1.0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               equal_nan=True, err_msg=err_msg)


@pytest.mark.parametrize("fixed", ["center", "verticals", "none"])
@pytest.mark.parametrize("lloyd", [False, True])
def test_load_kernels_bit_equal(fixed, lloyd):
    want = ref_kp.load_kernels(1.3, 15, fixed=fixed, lloyd=lloyd)
    got = kernel_points.load_kernels(1.3, 15, fixed=fixed, lloyd=lloyd)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


def test_spherical_lloyd_and_optimization_bit_equal():
    for k, kw in ((7, dict(max_iter=40, approx_n=1500, seed=3)),
                  (15, dict(fixed="verticals", max_iter=30, approx_n=1000))):
        assert np.array_equal(kernel_points.spherical_lloyd(k, **kw),
                              ref_kp.spherical_lloyd(k, **kw))
    assert np.array_equal(
        kernel_points.kernel_point_optimization(9, num_iter=50, seed=5),
        ref_kp.kernel_point_optimization(9, num_iter=50, seed=5))


def _cloud(rng, n=6000, side=3.0):
    pts = rng.uniform(0, side, size=(n, 3)).astype(np.float32)
    feats = rng.normal(size=(n, 4)).astype(np.float32)
    labels = rng.integers(0, 20, n).astype(np.int32)
    return pts, feats, labels


def test_native_bindings_byte_equal():
    rng = np.random.default_rng(0)
    pts, feats, labels = _cloud(rng)
    for dl in (0.04, 0.1):
        want = ref_native.grid_subsample(pts, feats, labels, cell_size=dl)
        got = native.grid_subsample(pts, feats, labels, cell_size=dl)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    sub = native.grid_subsample(pts, cell_size=0.1)[0]
    for radius, nmax in ((0.15, 8), (0.25, 30), (0.4, 64)):
        want = ref_native.radius_neighbors(sub, sub, radius, nmax)
        got = native.radius_neighbors(sub, sub, radius, nmax)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    over = (native.radius_neighbors(sub, sub, 0.4, 64) >= 0).all(axis=1)
    assert over.any()                       # rows that overflow occur
    q = rng.uniform(0, 3, size=(500, 3)).astype(np.float32)
    assert np.array_equal(native.radius_neighbors(q, sub, 0.3, 20),
                          ref_native.radius_neighbors(q, sub, 0.3, 20))


def test_native_numpy_versions_only_when_switched_off():
    rng = np.random.default_rng(1)
    pts, feats, labels = _cloud(rng, n=800)
    with native.disabled():
        got = native.grid_subsample(pts, feats, labels, cell_size=0.2)
        neigh = native.radius_neighbors(pts[:50], pts, 0.2, 16)
        grown = native.region_grow(pts, feats[:, :3], min_region=5)
    assert np.array_equal(grown[0], ref_native._region_grow_np(
        pts, feats[:, :3], 12, 0.05, 20.0, 5)[0])
    want = ref_native._grid_subsample_np(pts, feats, labels, 0.2)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    lib = native.radius_neighbors(pts[:50], pts, 0.2, 16)
    assert np.array_equal(np.sort(neigh, 1), np.sort(lib, 1))


def test_region_grow_binding_equal():
    rng = np.random.default_rng(2)
    pts = rng.uniform(0, 2, size=(3000, 3)).astype(np.float32)
    pts[:1500, 2] = 0.0                         # a plane
    normals = rng.normal(size=(3000, 3)).astype(np.float32)
    normals[:1500] = (0.0, 0.0, 1.0)
    got = native.region_grow(pts, normals, min_region=20)
    want = ref_native.region_grow(pts, normals, min_region=20)
    assert got[1] == want[1] > 0 and np.array_equal(got[0], want[0])


_ARCH = ("simple", "resnetb", "resnetb_deformable", "resnetb_strided",
         "resnetb", "max_pool", "resnetb_deformable",
         "resnetb_deformable_strided", "resnetb", "nearest_upsample",
         "unary", "nearest_upsample", "unary", "nearest_upsample", "unary")


def _cfg_pair(**kw):
    kw = dict(dict(architecture=_ARCH, num_classes=5, first_features_dim=16,
                   num_kernel_points=7, first_subsampling_dl=0.1,
                   default_neighbor_limit=12), **kw)
    return KPConvConfig(**kw), RefConfig(**kw)


def _clouds(rng, n_clouds=2, n_pts=300):
    clouds = []
    for _ in range(n_clouds):
        pts = rng.uniform(0, 1.2, size=(n_pts, 3)).astype(np.float32)
        feats = np.concatenate(
            [np.ones((n_pts, 1), np.float32),
             rng.uniform(size=(n_pts, 3)).astype(np.float32)], axis=1)
        labels = rng.integers(0, 5, size=(n_pts,)).astype(np.int32)
        labels[:5] = -100
        clouds.append({"points": pts, "features": feats, "labels": labels})
    return clouds


def test_segmentation_inputs_byte_equal():
    cfg, ref_cfg = _cfg_pair()
    clouds = _clouds(np.random.default_rng(3))
    limits = calibrate_neighbors(clouds, cfg)
    assert limits == ref_calibrate(clouds, ref_cfg)
    for kw in ({}, {"neighbor_limits": limits}):
        got = segmentation_inputs(clouds, cfg, **kw)
        want = ref_segmentation_inputs(clouds, ref_cfg, **kw)
        assert got.num_scenes == want.num_scenes == 2
        for field in got._fields[:-1]:
            a, b = getattr(got, field), getattr(want, field)
            for x, y in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                assert x.dtype == y.dtype and np.array_equal(x, y), field


def test_potential_sampler_same_draws():
    clouds = _clouds(np.random.default_rng(4), n_clouds=3, n_pts=400)
    ours = PotentialSampler(clouds, in_radius=0.4, potential_dl=0.1, seed=5)
    ref = RefSampler(clouds, in_radius=0.4, potential_dl=0.1, seed=5)
    for (ci, c, idx), (rci, rc, ridx) in zip(
            ours.sample_batch(12, min_points=5),
            ref.sample_batch(12, min_points=5)):
        assert ci == rci and np.array_equal(c, rc)
        assert np.array_equal(idx, ridx)
    for a, b in zip(ours.potentials, ref.potentials):
        assert np.array_equal(a, b)


def _op_inputs(seed, deform, modulate):
    rng = np.random.default_rng(seed)
    ns, nq, nn, cin, cout, k = 40, 16, 9, 6, 5, 7
    s = rng.normal(scale=0.4, size=(ns, 3)).astype(np.float32)
    q = s[:nq].copy()
    inds = rng.integers(0, ns, size=(nq, nn)).astype(np.int32)
    inds[:, 0] = np.arange(nq)                   # each query itself
    inds[0, -3:] = ns                            # shadows
    inds[1, 1:] = ns
    x = rng.normal(size=(ns, cin)).astype(np.float32)
    kp = ref_kp.load_kernels(0.5, k)
    w = (rng.normal(size=(k, cin, cout)) * 0.3).astype(np.float32)
    args = dict(q=q, s=s, inds=inds, x=x, kp=kp, w=w)
    if deform:
        off = (rng.normal(size=(nq, k, 3)) * 0.05).astype(np.float32)
        off[:4, 0] = 0.0                         # zero distance under sqrt
        args["offsets"] = off
    if modulate:
        args["modulations"] = rng.uniform(0.2, 1.8, (nq, k)).astype(
            np.float32)
    return args


_DIFF = ("x", "w", "offsets", "modulations")


@pytest.mark.parametrize("variant", ["rigid", "offsets", "modulated"])
@pytest.mark.parametrize("aggregation", ["sum", "closest"])
@pytest.mark.parametrize("influence", ["constant", "linear", "gaussian"])
def test_kpconv_apply_matches_reference(influence, aggregation, variant):
    a = _op_inputs(7, variant != "rigid", variant == "modulated")
    names = [n for n in _DIFF if n in a]
    kw = dict(kp_extent=0.6, influence=influence, aggregation=aggregation)

    def ref_fn(*vals):
        d = dict(zip(names, vals))
        out, aux = ref_ops.kpconv_apply(
            jnp.asarray(a["q"]), jnp.asarray(a["s"]), jnp.asarray(a["inds"]),
            d["x"], jnp.asarray(a["kp"]), d["w"], offsets=d.get("offsets"),
            modulations=d.get("modulations"), **kw)
        extra = 0.0
        if aux.min_d2 is not None:
            extra = jnp.sum(aux.min_d2 * 0.1) + jnp.sum(aux.deformed_kp)
        return jnp.sum(out * jnp.cos(out)) + extra, (out, aux)

    (_, (want, want_aux)), want_g = jax.value_and_grad(
        ref_fn, argnums=tuple(range(len(names))), has_aux=True)(
        *[jnp.asarray(a[n]) for n in names])

    t = {n: torch.tensor(a[n], requires_grad=True) for n in names}
    out, aux = ops.kpconv_apply(
        torch.from_numpy(a["q"]), torch.from_numpy(a["s"]),
        torch.from_numpy(a["inds"]), t["x"], torch.from_numpy(a["kp"]),
        t["w"], offsets=t.get("offsets"), modulations=t.get("modulations"),
        **kw)
    extra = 0.0
    if aux.min_d2 is not None:
        _close(aux.min_d2.detach(), want_aux.min_d2)
        _close(aux.deformed_kp.detach(), want_aux.deformed_kp)
        extra = torch.sum(aux.min_d2 * 0.1) + torch.sum(aux.deformed_kp)
    else:
        assert want_aux.min_d2 is None
    _close(out.detach(), want)
    (torch.sum(out * torch.cos(out)) + extra).backward()
    for n, g in zip(names, want_g):
        _close(t[n].grad, g, err_msg=n)
    if variant != "rigid" and influence == "linear":
        # the reference's sqrt at an exact zero gives NaN offset gradients
        assert np.isnan(np.asarray(want_g[names.index("offsets")])).any()


def _np_kpconv(a, kp_extent, influence):
    """``kpconv_apply`` computed directly in numpy f64: the distances as
    differences, not the expansion, shadows appended as rows."""
    f64 = np.float64
    s = np.concatenate([a["s"], np.full((1, 3), ops.SHADOW_COORD)]).astype(f64)
    x = np.concatenate([a["x"], np.zeros((1, a["x"].shape[1]))]).astype(f64)
    inds = np.where(a["inds"] < a["s"].shape[0], a["inds"], a["s"].shape[0])
    rel = s[inds] - a["q"].astype(f64)[:, None]                  # (N, n, 3)
    kp = a["kp"].astype(f64)[None] + a.get("offsets", np.zeros(1)).astype(f64)
    d2 = ((rel[:, :, None] - kp[:, None]) ** 2).sum(-1)          # (N, n, K)
    if influence == "linear":
        w = np.maximum(1.0 - np.sqrt(d2) / kp_extent, 0.0)
    else:
        w = np.exp(-d2 / (2.0 * (kp_extent * 0.3) ** 2 + 1e-9))
    weighted = np.einsum("vnk,vnc->vkc", w, x[inds])
    if "modulations" in a:
        weighted = weighted * a["modulations"].astype(f64)[:, :, None]
    return np.einsum("vkc,kco->vo", weighted, a["w"].astype(f64))


@pytest.mark.parametrize("variant", ["rigid", "offsets", "modulated"])
@pytest.mark.parametrize("influence", ["linear", "gaussian"])
def test_kpconv_apply_f64_is_f64_all_through(influence, variant):
    """In f64 (the yardstick of ``tools.kpconv_grads``; a dtype the
    reference never runs) the distances, influences and products stay
    f64: the output equals a direct numpy f64 computation at 1e-12."""
    a = _op_inputs(8, variant != "rigid", variant == "modulated")
    t = {n: torch.from_numpy(v).double() if n != "inds"
         else torch.from_numpy(v) for n, v in a.items()}
    out, _ = ops.kpconv_apply(
        t["q"], t["s"], t["inds"], t["x"], t["kp"], t["w"], kp_extent=0.6,
        influence=influence, offsets=t.get("offsets"),
        modulations=t.get("modulations"))
    assert out.dtype == torch.float64
    want = _np_kpconv(a, 0.6, influence)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_gather_never_wraps():
    x = torch.arange(12.0).reshape(4, 3)
    idx = torch.tensor([[0, 4, -1, 3]])
    got = ops.gather_feats(x, idx)[0]
    assert torch.equal(got[1], torch.zeros(3))
    assert torch.equal(got[2], torch.zeros(3))       # not x[-1]
    coords = ops.gather_coords(x, idx)[0]
    assert torch.equal(coords[1], torch.full((3,), ops.SHADOW_COORD))
    assert torch.equal(coords[3], x[3])


def test_pools_and_global_average_match_reference():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(10, 4)).astype(np.float32)
    x[3] = x[5]                                       # a tie in a max pool
    inds = np.array([[0, 1, 10], [2, 10, 10], [3, 5, 9], [10, 10, 10]],
                    np.int32)
    bid = np.array([0, 0, 1, 1, 1, 0, 2, 2, 1, 0], np.int32)
    valid = np.array([1, 1, 1, 1, 1, 0, 1, 1, 0, 1], bool)
    cot = rng.normal(size=(4, 4)).astype(np.float32)
    cot3 = rng.normal(size=(3, 4)).astype(np.float32)

    def ref_fns(xj):
        return (ref_ops.max_pool(xj, jnp.asarray(inds)),
                ref_ops.closest_pool(xj, jnp.asarray(inds)),
                ref_ops.global_average(xj, jnp.asarray(bid),
                                       jnp.asarray(valid), 3))

    def port_fns(xt):
        return (ops.max_pool(xt, torch.from_numpy(inds)),
                ops.closest_pool(xt, torch.from_numpy(inds)),
                ops.global_average(xt, torch.from_numpy(bid),
                                   torch.from_numpy(valid), 3))

    cots = (cot, cot, cot3)
    for i in range(3):
        want, vjp = jax.vjp(lambda xj: ref_fns(xj)[i], jnp.asarray(x))
        xt = torch.tensor(x, requires_grad=True)
        got = port_fns(xt)[i]
        _close(got.detach(), want)
        got.backward(torch.from_numpy(cots[i]))
        _close(xt.grad, vjp(jnp.asarray(cots[i]))[0])


def test_p2p_fitting_regularizer_matches_reference():
    rng = np.random.default_rng(9)
    min_d2s = [rng.uniform(0, 0.3, (20, 7)).astype(np.float32)
               for _ in range(2)]
    dkps = [(rng.normal(size=(20, 7, 3)) * 0.4).astype(np.float32)
            for _ in range(2)]
    dkps[0][0, 1] = dkps[0][0, 2]                  # two coincident points
    extents = [0.3, 0.6]
    kw = dict(repulse_extent=1.2, deform_fitting_power=1.0)

    def ref_fn(m0, m1, d0, d1):
        return ref_ops.p2p_fitting_regularizer([m0, m1], [d0, d1], extents,
                                               **kw)

    want, want_g = jax.value_and_grad(ref_fn, argnums=(0, 1, 2, 3))(
        *[jnp.asarray(v) for v in min_d2s + dkps])
    t = [torch.tensor(v, requires_grad=True) for v in min_d2s + dkps]
    got = ops.p2p_fitting_regularizer(t[:2], t[2:], extents, **kw)
    _close(got.detach(), want)
    got.backward()
    for tt, g in zip(t, want_g):
        _close(tt.grad, g)
