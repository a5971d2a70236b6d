"""Gradients of the port's windowed submanifold conv against the reference.

``subm_conv_apply`` on real host-built plans (a tight window and
sub-window, so the compact spill list is populated, and an active prefix
shorter than the capacity; the heavy tiers are held against the
reference in ``test_torch_port_bwd_wg.py``), through the port's
``torch.autograd.Function`` on each backward route:

- K2 (``windowed_bwd_gather``, flipped taps) with the flipped spill dW;
- K3 (``windowed_dw_sub``) with K1 on the cotangent, forced by lowering
  the K2 width gate to 0;
- K5 (``windowed_dw``) with K4 on the cotangent, on a flat-form plan;

against ``jax.grad`` through the reference with its Pallas route forced on
the CPU (interpret mode), as ``tests/test_sparse_conv.py:748-808`` does;
the reference's K3 route is selected with its own ablation switches.
float32, rtol = atol = 2e-4: the spill tiers and the windows sum in
another order in the two packages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_common import count_route_calls, port_plan_of
from tdwss.ops import pallas_subm as ps
from tdwss.ops import sparse_conv as ref_sc
from tdwss.ops.host_plan import (build_subm_rulebook_np,
                                 build_windowed_subm27, reset_sticky_plans,
                                 voxelize_np)
from tdwss_torch.ops import plan as port_plan
from tdwss_torch.ops import sparse_conv as port_sc

GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
PALLAS_FNS = ("windowed_bwd_gather", "windowed_matmul_sub", "windowed_matmul",
              "windowed_dw_sub", "windowed_dw")


@pytest.fixture(scope="module")
def plans():
    reset_sticky_plans()
    rng = np.random.default_rng(11)
    n = 512
    coords = np.concatenate([rng.integers(0, 16, (n, 3)),
                             rng.integers(0, 3, (n, 1))], 1).astype(np.int32)
    valid = rng.random(n) > 0.05
    grid, _, _ = voxelize_np(coords, None, valid, n + 128)  # padded tail
    rb = build_subm_rulebook_np(grid, 3)
    sub = build_windowed_subm27(rb, grid, tile=128, window=128,
                                res_cap=27 * n, sub=32, subwin=32)
    flat = build_windowed_subm27(rb, grid, tile=128, window=96,
                                 res_cap=27 * n)
    reset_sticky_plans()
    return dict(rb=rb, valid=np.asarray(grid.valid), sub=sub, flat=flat)


def _force_reference_pallas(monkeypatch):
    monkeypatch.setattr(
        ref_sc, "_use_pallas_kernel",
        lambda v, tiles, window, nanchor=27, c3=0, cout=0, v_out=0:
        tiles > 0 and v % tiles == 0 and window % 8 == 0 and v % 8 == 0)
    for name in PALLAS_FNS:
        monkeypatch.setattr(ps, name, functools.partial(
            getattr(ps, name), interpret=True))


def _grads(plans, key, seed, cin, cout):
    rng = np.random.default_rng(seed)
    v = plans["rb"].shape[0]
    feats = (rng.normal(size=(v, cin)) * plans["valid"][:, None]
             ).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) * 0.2).astype(np.float32)
    r = rng.normal(size=(v, cout)).astype(np.float32)
    win = plans[key]
    winj = jax.tree_util.tree_map(jnp.asarray, win)
    rbj = jnp.asarray(plans["rb"])
    ref = jax.grad(lambda f, w_: jnp.sum(
        ref_sc.subm_conv_apply(f, rbj, w_, winj) * r), argnums=(0, 1))(
        jnp.asarray(feats), jnp.asarray(w))
    pwin = port_plan_of(win, port_plan.Windowed27)
    ft = torch.tensor(feats, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    port_sc.subm_conv_apply(ft, torch.from_numpy(plans["rb"]), wt,
                            pwin).backward(torch.from_numpy(r))
    return ref, (ft.grad, wt.grad)


def _check(ref, port):
    np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[0]),
                               **GRAD_TOL)
    np.testing.assert_allclose(port[1].numpy(), np.asarray(ref[1]),
                               **GRAD_TOL)


def test_plans_have_spills_and_an_active_prefix(plans):
    sub, flat = plans["sub"], plans["flat"]
    v = plans["rb"].shape[0]
    assert sub.sub and not flat.sub
    assert 0 < sub.v_active < v
    for win in (sub, flat):                  # spills in the compact list
        assert (win.res_ovf[:, 0] < v).sum() > 0


def test_k2_route_gradients_match_reference(plans, monkeypatch):
    _force_reference_pallas(monkeypatch)
    calls = count_route_calls(monkeypatch, ["windowed_bwd_gather",
                                       "windowed_dw_sub"])
    ref, port = _grads(plans, "sub", 41, 8, 8)
    assert calls == {"windowed_bwd_gather": 1, "windowed_dw_sub": 0}
    _check(ref, port)


def test_k3_route_gradients_match_reference(plans, monkeypatch):
    _force_reference_pallas(monkeypatch)
    monkeypatch.setenv("TDWSS_NO_GATHER_BWD", "1")
    monkeypatch.setenv("TDWSS_NO_FUSED_BWD", "1")
    monkeypatch.setattr(port_sc, "_GATHER_MAX_C", 0)
    calls = count_route_calls(monkeypatch, ["windowed_bwd_gather",
                                       "windowed_dw_sub",
                                       "windowed_matmul_sub"])
    ref, port = _grads(plans, "sub", 42, 6, 10)
    assert calls == {"windowed_bwd_gather": 0, "windowed_dw_sub": 1,
                     "windowed_matmul_sub": 2}       # forward + dfeats
    _check(ref, port)


def test_k5_route_gradients_match_reference(plans, monkeypatch):
    _force_reference_pallas(monkeypatch)
    calls = count_route_calls(monkeypatch, ["windowed_dw", "windowed_matmul"])
    ref, port = _grads(plans, "flat", 43, 8, 8)
    assert calls == {"windowed_dw": 1, "windowed_matmul": 2}
    _check(ref, port)
