"""KPFCNN against the reference's (``tdwss.models.kpconv``).

A tiny KPFCNN with every block kind the segmentation architecture can
hold (simple, resnetb, resnetb_strided, resnetb_deformable,
resnetb_deformable_strided, max_pool, nearest_upsample, unary): 4
layers, first_features_dim 16, 7 kernel points, 5 classes, 2 clouds of
300 points through both packages' ``segmentation_inputs``; the
reference's initial variables are loaded through ``flax_to_state_dict``,
whose block names must walk flax's automatic naming exactly.

- eval logits and the deformable convs' auxes: f32, |d| <= 1e-5 *
  max|ref| + 1e-5 * |ref|;
- a train forward: logits and the running statistics after it
  (1e-4: batch norm sums in another order), ``kpfcnn_loss``
  (CE + regulariser, rtol 1e-5), every parameter gradient at
  |d| <= 1e-3 * max|ref| per tensor (measured up to ~1e-4: batch-norm
  statistics summed in another order, through 4 layers) and NaN exactly
  where the reference's is: with padding rows in the pyramid, the
  reference's offset gradients are NaN (a padding row's neighbours are
  all shadows at its own coordinate, so its centre kernel point, offset
  0 at init, sits at distance 0 under ``sqrt``); the port computes the
  same;
- the loss with class weights, values and gradients at 1e-5;
- 3 Adam steps with the deform group at ``lr * deform_lr_factor``
  against ``optax.multi_transform`` over ``deform_param_labels``, on the
  same clouds padded to their exact sizes (no padding rows, no NaN):
  each step from the reference's parameters, the gradients held as
  above, then the port's Adam on the reference's gradient against
  optax's update (|d| <= 1e-4 * lr + 1e-6 * |p|: the two compute
  Adam's update with other roundings, measured 6.6e-6 * lr).
- ``tools.kpconv_grads``: recording and replaying a step's selections
  give the step back bit for bit, with no flip; the backward-only fault
  leaves the forward bit for bit and moves the gradients by more than
  1e-2 of a tensor's norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tdwss.models.kpconv import KPFCNN as RefKPFCNN
from tdwss.models.kpconv import deform_param_labels as ref_labels
from tdwss.models.kpconv import kpfcnn_loss as ref_loss
from tdwss.models.kpconv import segmentation_inputs as ref_seg
from tdwss.models.kpconv.config import KPConvConfig as RefConfig
from tests.test_torch_port_kpconv_ops import _ARCH, _clouds
from tdwss_torch.convert import flax_to_state_dict, state_dict_to_flax
from tdwss_torch.models.kpconv import (KPFCNN, KPConvConfig,
                                       deform_param_labels, kpfcnn_loss,
                                       param_groups, segmentation_inputs)
from tdwss_torch.tools.kpconv_grads import (Selections, grad_errors,
                                            row0_takes_no_gradient,
                                            step_outputs)

TOL = 1e-5
STATS_TOL = 1e-4
GRAD_TOL = 1e-3
LR = 1e-3


def _close(got, want, tol=TOL, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    scale = np.abs(want[fin]).max() if fin.any() else 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               equal_nan=True, err_msg=err_msg)


def _leaves(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def setup():
    kw = dict(architecture=_ARCH, num_classes=5, first_features_dim=16,
              num_kernel_points=7, first_subsampling_dl=0.1,
              default_neighbor_limit=12)
    cfg, ref_cfg = KPConvConfig(**kw), RefConfig(**kw)
    clouds = _clouds(np.random.default_rng(3))
    ref_b = ref_seg(clouds, ref_cfg)
    exact = [int(v.sum()) for v in ref_b.valids]
    ref_exact = ref_seg(clouds, ref_cfg, capacities=exact)

    def dev(b):
        return jax.tree_util.tree_map(jnp.asarray, b)._replace(num_scenes=2)

    ref_bj, ref_ej = dev(ref_b), dev(ref_exact)
    model = RefKPFCNN(config=ref_cfg)
    variables = jax.jit(lambda b: model.init(jax.random.PRNGKey(0), b,
                                             train=False))(ref_bj)

    @jax.jit
    def grad_fn(p, s, b):
        """(loss, (logits, new batch_stats)), grads of one train step."""
        def loss_fn(p):
            (logits, aux), new = model.apply(
                {"params": p, "batch_stats": s}, b, train=True,
                mutable=["batch_stats"])
            return ref_loss(logits, b.labels, aux, ref_cfg), (logits, new)
        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    return dict(
        cfg=cfg, ref_cfg=ref_cfg, model=model, variables=variables,
        grad_fn=grad_fn,
        ref_bj=ref_bj, ref_ej=ref_ej,
        batch=segmentation_inputs(clouds, cfg).to("cpu"),
        exact=segmentation_inputs(clouds, cfg, capacities=exact).to("cpu"))


def _port(setup, params=None, stats=None):
    params = setup["variables"]["params"] if params is None else params
    stats = setup["variables"]["batch_stats"] if stats is None else stats
    model = KPFCNN(setup["cfg"], device="cpu")
    model.load_state_dict(flax_to_state_dict(jax.device_get(params),
                                             jax.device_get(stats)))
    return model


def test_converter_walks_flax_block_names(setup):
    model = _port(setup)
    names = set(dict(model.named_children()))
    for block in ("SimpleBlock_0", "ResnetBottleneckBlock_6",
                  "MaxPoolBlock_0", "NearestUpsampleBlock_2",
                  "_UnaryAdapter_2", "head_mlp", "head_softmax"):
        assert block in names
    flax_params = jax.device_get(setup["variables"]["params"])
    assert set(flax_params) == {n for n in names if any(
        True for _ in getattr(model, n).parameters())}
    params, stats = state_dict_to_flax(model.state_dict())
    for got, want in ((params, flax_params),
                      (stats, jax.device_get(
                          setup["variables"]["batch_stats"]))):
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
        assert len(flat_got) == len(flat_want)
        for path, leaf in flat_got:
            assert np.array_equal(leaf, np.asarray(flat_want[path]))


def test_eval_forward_matches_reference(setup):
    logits, auxes = setup["model"].apply(setup["variables"], setup["ref_bj"],
                                         train=False)
    with torch.no_grad():
        got, got_aux = _port(setup)(setup["batch"], train=False)
    _close(got, logits)
    assert len(got_aux) == len(auxes) == 3
    for (a, ext), (b, ref_ext) in zip(got_aux, auxes):
        assert ext == ref_ext
        _close(a.min_d2, b.min_d2)
        _close(a.deformed_kp, b.deformed_kp)


def test_train_step_matches_reference(setup):
    cfg, variables = setup["cfg"], setup["variables"]
    (loss, (logits, new)), grads = setup["grad_fn"](
        variables["params"], variables["batch_stats"], setup["ref_bj"])
    port = _port(setup)
    got_logits, auxes = port(setup["batch"], train=True)
    got = kpfcnn_loss(got_logits, setup["batch"].labels, auxes, cfg)
    got.backward()
    _close(got_logits.detach(), logits, STATS_TOL)
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=TOL)
    want_g = _leaves(flax_to_state_dict(jax.device_get(grads)))
    nan_params = []
    for n, p in port.named_parameters():
        _close(p.grad, want_g[n], GRAD_TOL, err_msg=n)
        if np.isnan(want_g[n]).any():
            nan_params.append(n)
    assert nan_params and all("offset" in n for n in nan_params)
    want_s = _leaves(flax_to_state_dict({}, jax.device_get(
        new["batch_stats"])))
    got_s = _leaves(port.state_dict())
    for k, v in want_s.items():
        _close(got_s[k], v, STATS_TOL, err_msg=k)


def test_loss_with_class_weights(setup):
    rng = np.random.default_rng(11)
    logits = rng.normal(size=(50, 5)).astype(np.float32)
    labels = rng.integers(-1, 5, 50).astype(np.int32)
    cw = (0.5, 1.0, 2.0, 1.5, 0.25)
    cfg = KPConvConfig(num_classes=5, class_w=cw)
    ref_cfg = RefConfig(num_classes=5, class_w=cw)
    want, want_g = jax.value_and_grad(
        lambda lo: ref_loss(lo, jnp.asarray(labels), [], ref_cfg))(
        jnp.asarray(logits))
    t = torch.tensor(logits, requires_grad=True)
    got = kpfcnn_loss(t, torch.from_numpy(labels), [], cfg)
    got.backward()
    _close(got.detach(), want)
    _close(t.grad, want_g)


def test_three_adam_steps_with_the_deform_group(setup):
    cfg, ref_cfg = setup["cfg"], setup["ref_cfg"]
    params = setup["variables"]["params"]
    stats = setup["variables"]["batch_stats"]
    labels = ref_labels(params)
    tx = optax.multi_transform(
        {"main": optax.adam(LR),
         "deform": optax.adam(LR * ref_cfg.deform_lr_factor)}, labels)
    opt_state = tx.init(params)

    port = _port(setup)
    port_labels = deform_param_labels(port)
    flat_labels = _leaves(flax_to_state_dict(jax.tree_util.tree_map(
        lambda lab: np.float32(lab == "deform"), labels)))
    assert {n: "deform" if flat_labels[n] else "main"
            for n in port_labels} == port_labels
    assert sorted(set(port_labels.values())) == ["deform", "main"]
    opt = torch.optim.Adam(param_groups(port, LR), betas=(0.9, 0.999),
                           eps=1e-8)
    assert [g["lr"] for g in opt.param_groups] == [
        LR, LR * cfg.deform_lr_factor]
    for _ in range(3):
        (loss, (_, new)), grads = setup["grad_fn"](params, stats,
                                                  setup["ref_ej"])
        port.load_state_dict(flax_to_state_dict(jax.device_get(params),
                                                jax.device_get(stats)))
        opt.zero_grad()
        logits, auxes = port(setup["exact"], train=True)
        got = kpfcnn_loss(logits, setup["exact"].labels, auxes, cfg)
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(loss), rtol=TOL)
        want_g = _leaves(flax_to_state_dict(jax.device_get(grads)))
        for n, p in port.named_parameters():
            assert np.isfinite(want_g[n]).all(), n
            _close(p.grad, want_g[n], GRAD_TOL, err_msg=n)
            p.grad = torch.from_numpy(want_g[n].copy())
        opt.step()
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        stats = new["batch_stats"]
        want_p = _leaves(flax_to_state_dict(jax.device_get(params)))
        for n, p in port.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want_p[n],
                                       rtol=1e-6, atol=1e-4 * LR,
                                       err_msg=n)


def test_grads_tool_replay_and_backward_fault(setup):
    """``tools.kpconv_grads``, which the KPConv chip phase's limits rest
    on: recording a step's selections leaves the step as it is,
    replaying them gives it back with no flip, and the backward-only
    fault leaves the forward as it is and moves the gradients."""
    cfg, b = setup["cfg"], setup["exact"]
    plain = step_outputs(cfg, b, "cpu", torch.float32)
    tape = Selections()
    recorded = step_outputs(cfg, b, "cpu", torch.float32, selections=tape)
    replay = Selections(replay=tape)
    replayed = step_outputs(cfg, b, "cpu", torch.float32, selections=replay)
    assert sum(replay.entries.values()) > 0 and not +replay.flips
    for run in (recorded, replayed):
        assert torch.equal(run[0], plain[0]) and run[1] == plain[1]
        assert grad_errors(run[2], plain[2])[0][0] == 0.0
    fault = step_outputs(cfg, b, "cpu", torch.float32,
                         take=row0_takes_no_gradient)
    assert torch.equal(fault[0], plain[0]) and fault[1] == plain[1]
    assert grad_errors(fault[2], plain[2])[0][0] > 1e-2
