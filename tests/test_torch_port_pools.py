"""The rulebook pools of the port (``max_pool``, ``avg_pool``) and
``gather_neighbors`` against the reference's on a real ``build_plans``
level (the port's, whose rulebooks other tests hold byte for byte to the
reference's): the level-0 ``down_rb`` of a padded grid (coarse rows with
no live child) and its fine voxels' features, with planted cases: ties
among live children (features on a coarse grid of values, so two, three
or more children tie), a coarse voxel whose children are all removed, a
``-1`` entry and an entry >= V, and a live child equal to the dtype's
``finfo.min``.  In f32 and bf16, values and gradients (``jax.grad`` of
the sum against a random cotangent) are equal bit for bit: a max that
ties among 2, 3 or 4 children splits its cotangent by the same division
on both sides (``torch.amax``'s backward and ``jnp.max``'s VJP both
compute ``g / count * mask``).  ``gather_neighbors`` over the level's
subm rulebook, where a voxel is read by up to 27 entries and its
gradient is their sum: values bit for bit; gradients bit for bit in
bf16 (both sides add in bf16 in the same order) and within
SUBM_GRAD_TOL_F32 of max|reference| in f32, where the two add in
another order (measured 1.4e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdwss.ops.sparse_conv import avg_pool as ref_avg_pool
from tdwss.ops.sparse_conv import gather_neighbors as ref_gather_neighbors
from tdwss.ops.sparse_conv import max_pool as ref_max_pool
from tdwss_torch.ops import build_plans, gather_neighbors, max_pool, voxelize
from tdwss_torch.ops.sparse_conv import avg_pool

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# a sum of up to 27 f32 entries in another order: at worst 26 * 2^-24
# (1.5e-6) of the sum of their magnitudes apart; the cases read 1.4e-7
# of max|reference|; the limit is the card check's (chip_smoke.py
# POOL_SUM_TOL, f32)
SUBM_GRAD_TOL_F32 = 1e-6


@pytest.fixture(scope="module")
def level():
    """(fine features (V, C) f32, down_rb (Vc, 8) int32) of a real level 0
    with the planted cases, the rows that hold them, and the level's subm
    rulebook (V, 27) int32."""
    rng = np.random.default_rng(0)
    n, extent, c = 3000, 14, 6
    coords = np.concatenate([rng.integers(0, extent, (n, 3)),
                             rng.integers(0, 2, (n, 1))], 1).astype(np.int32)
    valid = rng.random(n) < 0.9
    grid, _, _ = voxelize(torch.from_numpy(coords), torch.zeros((n, 1)),
                          torch.from_numpy(valid), n)
    plans = build_plans(grid, 2, [n, n])
    rb = plans.levels[0].down_rb.numpy().astype(np.int32)
    subm = plans.levels[0].subm_rb.numpy().astype(np.int32)
    v = int(grid.valid.shape[0])
    # values on a grid of quarters: many ties among a voxel's children
    feats = (rng.integers(-4, 5, (v, c)) / 4.0).astype(np.float32)
    live = (rb >= 0).sum(1)
    assert (live == 0).any(), "the padded level has coarse rows with no child"
    rows = np.nonzero(live >= 3)[0]
    planted = {}
    # three children equal in every channel
    r = rows[0]
    kids = rb[r][rb[r] >= 0]
    feats[kids[1]] = feats[kids[0]]
    feats[kids[2]] = feats[kids[0]]
    feats[kids[0], 0] = 5.0          # above every other value: a tie of 3
    feats[kids[1], 0] = 5.0
    feats[kids[2], 0] = 5.0
    planted["tie of 3"] = r
    # a coarse voxel whose children are all removed
    r = rows[1]
    rb[r] = -1
    planted["no live child"] = r
    # a -1 entry and an entry >= V beside live ones
    r = rows[2]
    taken = np.nonzero(rb[r] >= 0)[0]
    rb[r, taken[0]] = -1
    rb[r, taken[1]] = v + 5
    planted["-1 and >= V"] = r
    # every live child at finfo.min in channel 1 (they tie with the
    # missing ones: the output is 0), and one live child at finfo.min
    # beside larger ones in channel 2; -inf stands for the dtype's finfo.min
    r = rows[3]
    feats[rb[r][rb[r] >= 0], 1] = -np.inf
    planted["children at finfo.min"] = r
    r = rows[4]
    feats[rb[r][rb[r] >= 0][0], 2] = -np.inf
    planted["child at finfo.min"] = r
    return feats, rb, planted, subm


def _cases(feats, rb, jdt, tdt):
    f = np.where(np.isneginf(feats), float(torch.finfo(tdt).min), feats)
    jf = jnp.asarray(f, dtype=jdt)
    tf = torch.tensor(f).to(tdt)
    assert np.array_equal(np.asarray(jf.astype(jnp.float32)),
                          tf.float().numpy())
    return jf, tf, jnp.asarray(rb), torch.from_numpy(rb)


FUNCS = {"max_pool": (ref_max_pool, max_pool),
         "avg_pool": (ref_avg_pool, avg_pool),
         "gather_neighbors": (ref_gather_neighbors, gather_neighbors)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(FUNCS))
def test_pool_values_equal_the_reference(level, name, dtype):
    feats, rb, planted, _ = level
    jf, tf, jrb, trb = _cases(feats, rb, *DTYPES[dtype])
    ref_fn, port_fn = FUNCS[name]
    want = np.asarray(ref_fn(jf, jrb).astype(jnp.float32))
    got = port_fn(tf, trb)
    assert got.dtype == DTYPES[dtype][1]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)
    if name == "max_pool":
        out = got.float().numpy()
        assert (out[planted["no live child"]] == 0).all()
        assert out[planted["tie of 3"], 0] == 5.0
        # the channel whose live values are all at finfo.min comes out 0
        assert out[planted["children at finfo.min"], 1] == 0
        assert out[planted["child at finfo.min"], 2] > -2


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(FUNCS))
def test_pool_gradients_equal_the_reference(level, name, dtype):
    feats, rb, planted, _ = level
    jdt, tdt = DTYPES[dtype]
    jf, tf, jrb, trb = _cases(feats, rb, jdt, tdt)
    ref_fn, port_fn = FUNCS[name]
    out_shape = np.asarray(ref_fn(jf, jrb)).shape
    cot = np.random.default_rng(1).normal(size=out_shape).astype(np.float32)
    jcot = jnp.asarray(cot, dtype=jdt)
    want = np.asarray(jax.grad(
        lambda x: jnp.sum((ref_fn(x, jrb) * jcot).astype(jnp.float32)))(
            jf).astype(jnp.float32))
    x = tf.clone().requires_grad_(True)
    tcot = torch.tensor(np.asarray(jcot.astype(jnp.float32))).to(tdt)
    (port_fn(x, trb) * tcot).float().sum().backward()
    got = x.grad.float().numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    if name == "max_pool":
        # ties of 2, 3 and 4 among live children occur
        live = (rb >= 0) & (rb < len(feats))
        vals = np.where(live[..., None],
                        np.asarray(jf.astype(jnp.float32))[np.where(
                            live, rb, 0)], -np.inf)
        ties = (vals == vals.max(1, keepdims=True)).sum(1)[live.any(1)]
        assert {2, 3, 4} <= set(ties.ravel().tolist())
        # the planted tie of 3 splits the cotangent in thirds
        r = planted["tie of 3"]
        kids = rb[r][rb[r] >= 0][:3]
        np.testing.assert_array_equal(got[kids, 0], got[kids[0], 0])
        assert got[kids[0], 0] != 0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gather_neighbors_over_the_subm_rulebook(level, dtype):
    feats, _, _, subm = level
    jdt, tdt = DTYPES[dtype]
    jf, tf, jrb, trb = _cases(feats, subm, jdt, tdt)
    reads = np.bincount(subm[subm >= 0].ravel())
    assert reads.max() >= 8, "a voxel is read by several entries"
    want = np.asarray(ref_gather_neighbors(jf, jrb).astype(jnp.float32))
    x = tf.clone().requires_grad_(True)
    got = gather_neighbors(x, trb)
    np.testing.assert_array_equal(got.detach().float().numpy(), want)
    cot = np.random.default_rng(1).normal(size=want.shape).astype(np.float32)
    jcot = jnp.asarray(cot, dtype=jdt)
    gwant = np.asarray(jax.grad(lambda f: jnp.sum(
        (ref_gather_neighbors(f, jrb) * jcot).astype(jnp.float32)))(
            jf).astype(jnp.float32))
    tcot = torch.tensor(np.asarray(jcot.astype(jnp.float32))).to(tdt)
    (got * tcot).float().sum().backward()
    ggot = x.grad.float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(ggot, gwant)
    else:
        err = np.abs(ggot - gwant).max() / np.abs(gwant).max()
        assert err <= SUBM_GRAD_TOL_F32, err
