"""Plain versions of the backward kernels K2, K3 and K5 against the
reference's Pallas kernels in interpret mode.

K2 (``windowed_bwd_gather``, both ``flip_taps`` settings), K3
(``windowed_dw_sub``) and K5 (``windowed_dw``) on random windows and
locals (sentinels included), in the 27-tap form at nwin 9 and 3 and in
the cross-domain WindowedGather form; the reference's lane padding is
stripped before the comparison.  float32, rtol = atol = 1e-5: the same
f32 products summed in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdwss.ops.pallas_subm import (pad_w9, windowed_bwd_gather, windowed_dw,
                                   windowed_dw_sub)
from tdwss_torch.ops import windowed as port_win

TOL = dict(rtol=1e-5, atol=1e-5)

FORMS = {
    # v_src, v_out, tile, window, sub, subwin, c, cout, k, nwin
    "w27_nwin9": (128, 128, 32, 48, 8, 16, 12, 8, 27, 9),
    "w27_nwin3": (128, 128, 32, 48, 8, 16, 6, 10, 27, 3),
    "cross_domain": (128, 64, 16, 48, 8, 16, 12, 8, 8, 2),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _case(form, seed, flat=False):
    v_src, v_out, tile, window, sub, swk, c, cout, k, nwin = FORMS[form]
    rng = np.random.default_rng(seed)
    tiles = v_out // tile
    starts = (rng.integers(0, (v_src - window) // 8 + 1,
                           size=(tiles, nwin)) * 8).astype(np.int32)
    sub_off = (rng.integers(0, (window - swk) // 8 + 1,
                            size=(tiles * (tile // sub), nwin)) * 8
               ).astype(np.int32)
    if flat:
        rb = rng.integers(0, window + 1, size=(v_out, k)).astype(np.int32)
    else:
        rb = rng.integers(0, swk + 1, size=(v_out, k)).astype(np.int32)
    return dict(v_src=v_src, v_out=v_out, tile=tile, window=window, sub=sub,
                subwin=swk, c=c, cout=cout, k=k, rng=rng,
                starts=starts.reshape(-1), soff=sub_off.reshape(-1),
                rb_t=np.ascontiguousarray(rb.T))


@pytest.mark.parametrize("flip_taps", [True, False])
@pytest.mark.parametrize("form", ["w27_nwin9", "cross_domain"])
def test_k2_plain_matches_pallas(form, flip_taps):
    cs = _case(form, 31)
    rng = cs["rng"]
    # K2's gather source is the cotangent (width cout), its dense rows the
    # primal feats (width c)
    dout = rng.normal(size=(cs["v_src"], cs["cout"])).astype(np.float32)
    feats = rng.normal(size=(cs["v_out"], cs["c"])).astype(np.float32)
    wt = rng.normal(size=(cs["k"], cs["cout"], cs["c"])).astype(np.float32)
    geo = dict(window=cs["window"], tile=cs["tile"], sub=cs["sub"],
               subwin=cs["subwin"])
    ref_dx, ref_dw = windowed_bwd_gather(
        jnp.asarray(dout), jnp.asarray(feats), jnp.asarray(cs["starts"]),
        jnp.asarray(cs["soff"]), jnp.asarray(cs["rb_t"]),
        pad_w9(jnp.asarray(wt)), cout=cs["cout"], flip_taps=flip_taps,
        interpret=True, **geo)
    dx, dw = port_win.windowed_bwd_gather(
        _t(dout), _t(feats), _t(cs["starts"]), _t(cs["soff"]),
        _t(cs["rb_t"]), _t(wt), flip_taps=flip_taps, **geo)
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(ref_dw), **TOL)
    # dW alone (the stem: its input needs no gradient)
    none, dw_only = port_win.windowed_bwd_gather(
        _t(dout), _t(feats), _t(cs["starts"]), _t(cs["soff"]),
        _t(cs["rb_t"]), _t(wt), flip_taps=flip_taps, need_dfeats=False,
        **geo)
    assert none is None
    np.testing.assert_array_equal(dw_only.numpy(), dw.numpy())


@pytest.mark.parametrize("form", ["w27_nwin9", "cross_domain"])
def test_k3_plain_matches_pallas(form):
    cs = _case(form, 32)
    rng = cs["rng"]
    x = rng.normal(size=(cs["v_src"], cs["c"])).astype(np.float32)
    dout = rng.normal(size=(cs["v_out"], cs["cout"])).astype(np.float32)
    geo = dict(window=cs["window"], tile=cs["tile"], sub=cs["sub"],
               subwin=cs["subwin"])
    ref = windowed_dw_sub(jnp.asarray(x), jnp.asarray(cs["starts"]),
                          jnp.asarray(cs["soff"]), jnp.asarray(cs["rb_t"]),
                          jnp.asarray(dout), interpret=True, **geo)
    dw = port_win.windowed_dw_sub(_t(x), _t(cs["starts"]), _t(cs["soff"]),
                                  _t(cs["rb_t"]), _t(dout), **geo)
    np.testing.assert_allclose(dw.numpy(), np.asarray(ref)[:, :cs["c"]],
                               **TOL)


@pytest.mark.parametrize("form", ["w27_nwin9", "w27_nwin3", "cross_domain"])
def test_k5_plain_matches_pallas(form):
    cs = _case(form, 33, flat=True)
    rng = cs["rng"]
    x = rng.normal(size=(cs["v_src"], cs["c"])).astype(np.float32)
    dout = rng.normal(size=(cs["v_out"], cs["cout"])).astype(np.float32)
    ref = windowed_dw(jnp.asarray(x), jnp.asarray(cs["starts"]),
                      jnp.asarray(cs["rb_t"]), jnp.asarray(dout),
                      window=cs["window"], tile=cs["tile"], interpret=True)
    dw = port_win.windowed_dw(_t(x), _t(cs["starts"]), _t(cs["rb_t"]),
                              _t(dout), window=cs["window"], tile=cs["tile"])
    np.testing.assert_allclose(dw.numpy(), np.asarray(ref)[:, :cs["c"]],
                               **TOL)
    # the transposed view of a (V, K) array is accepted as well
    dw_t = port_win.windowed_dw(_t(x), _t(cs["starts"]),
                                _t(cs["rb_t"].T.copy()).t(), _t(dout),
                                window=cs["window"], tile=cs["tile"])
    np.testing.assert_array_equal(dw_t.numpy(), dw.numpy())


def test_bwd_wrappers_validate_arguments():
    x = torch.zeros(64, 4)
    starts = torch.zeros(4 * 9, dtype=torch.int32)
    soff = torch.zeros(8 * 9, dtype=torch.int32)
    rb = torch.zeros(27, 64, dtype=torch.int32)
    with pytest.raises(ValueError):                      # dout rows != V_out
        port_win.windowed_dw(x, starts, rb, torch.zeros(32, 8), window=24,
                             tile=16)
    with pytest.raises(TypeError):                       # int32 locals
        port_win.windowed_dw_sub(x, starts, soff, rb.long(),
                                 torch.zeros(64, 8), window=24, tile=16,
                                 sub=8, subwin=16)
    with pytest.raises(ValueError):                      # wt (K, Cout, Cin)
        port_win.windowed_bwd_gather(x, torch.zeros(64, 3), starts, soff, rb,
                                     torch.zeros(27, 5, 3), window=24,
                                     tile=16, sub=8, subwin=16)
    with pytest.raises(ValueError):                      # sub form only
        port_win.windowed_bwd_gather(x, torch.zeros(64, 3), starts, None, rb,
                                     torch.zeros(27, 4, 3), window=24,
                                     tile=16, sub=8, subwin=16)


def test_dw_chunking_stays_in_bounds():
    """Chunk counts for the card's dW partials: at least one chunk, none
    empty of rows beyond V_out, partials within their memory cap."""
    for v_out, c, cout, k in [(786432, 32, 32, 27), (4096, 384, 192, 27),
                              (16, 3, 32, 27), (1, 8, 8, 8)]:
        n = port_win._nchunks(v_out, c, cout, k)
        assert 1 <= n <= v_out
        assert n == 1 or n * k * c * cout * 4 <= port_win._PART_BYTES
