"""The small model helpers and the MegaMulAdd count.

- ``Result`` in list and dict mode against the reference's, call for
  call.
- ``interpolate_pos_encoding`` against the reference's
  ``jax.image.resize(method="cubic")`` for an upscale, a downscale, an
  anisotropic grid and the identity: f32, max|d| <= 1e-5 * max|ref|
  (the two contract the same float32 weights in another order).
- ``mega_mul_add``: the port's count, made from the plans and the module
  tree without running anything, equals a count made independently from
  one forward of the same batch (forward hooks on every conv, NIN and
  linear layer, and the unpool calls, reading the shapes that ran and
  which inputs needed a gradient), exactly, for MultiLabel over
  SparseConvFCNet (``configs/smoke_cpu.yaml``: windowed unpools), over
  the small residual UNet (NINs, deconvs), on the plans-free branch, for
  FullySupervised, for MultiLabelContrastive (the text tower's linear
  layers over every token row), and in eval.  Beside the reference's
  figure for the same ``smoke_cpu.yaml`` step (XLA's flops / 2 of the
  compiled step, every op of it, the convs as the CPU's dense einsums):
  both positive, the reference's the larger; ``-s`` prints the two.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tdwss.models.misc import Result as RefResult
from tdwss.models.misc import interpolate_pos_encoding as ref_interpolate
from tests._torch_port_common import _cfgs
from tdwss_torch.config import load_config
from tdwss_torch.data.collate import train_collate
from tdwss_torch.data.plans import attach_host_plans, slim_batch_for_train
from tdwss_torch.data.synthetic import make_dataset
from tdwss_torch.models import sparse_encoders
from tdwss_torch.models.layers import (Deconv, NetworkInNetwork,
                                       StridedConv, SubmConv)
from tdwss_torch.models.meta_arch import build_model
from tdwss_torch.models.misc import Result, interpolate_pos_encoding
from tdwss_torch.ops.host_plan import reset_sticky_plans
from tdwss_torch.utils.flops import mega_mul_add, step_mul_adds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("as_dict", [False, True])
def test_result_matches_reference(as_dict):
    ours, ref = Result(as_dict), RefResult(as_dict)
    for r in (ours, ref):
        if as_dict:
            r.append(1, name="a")
            r.update(b=2, c=3)
        else:
            r.append(1)
            r.update(b=2, c=3)
    assert ours.as_dict == ref.as_dict == as_dict
    assert ours.as_output() == ref.as_output()
    assert ours.as_return() == ref.as_return()
    single, ref_single = Result(as_dict), RefResult(as_dict)
    if as_dict:
        for r in (single, ref_single):
            with pytest.raises(ValueError):
                r.append(1)
    else:
        for r in (single, ref_single):
            r.append(7)
        assert single.as_return() == ref_single.as_return() == 7


@pytest.mark.parametrize("side,target", [(4, (6, 6, 6)), (6, (3, 3, 3)),
                                         (5, (7, 3, 5)), (4, (4, 4, 4))],
                         ids=["upscale", "downscale", "anisotropic",
                              "identity"])
def test_interpolate_pos_encoding_matches_jax_resize(side, target):
    rng = np.random.default_rng(side)
    pe = rng.normal(size=(1, side ** 3, 16)).astype(np.float32)
    want = np.asarray(ref_interpolate(jnp.asarray(pe), *target))
    got = interpolate_pos_encoding(torch.from_numpy(pe), *target).numpy()
    assert got.shape == want.shape == (1, int(np.prod(target)), 16)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    if target == (side,) * 3:
        assert np.array_equal(got, pe)


def _hooked_count(model, batch, train):
    """Multiply-adds of one forward (and, with ``train``, its backward)
    from the shapes that ran: each conv's output rows x taps x Cin x Cout,
    each NIN's and linear layer's rows x in x out, each windowed unpool's
    rows x taps x C x C; per pass, one for the forward, and in training
    one more for each of dW (where the weight takes a gradient) and
    dfeats (where the input needs one)."""
    total = [0]

    def passes(inp, weight):
        if not train:
            return 1
        return 1 + int(weight.requires_grad) + int(inp.requires_grad)

    def conv_hook(mod, args, out):
        k, cin, cout = mod.kernel.shape
        total[0] += (passes(args[0], mod.kernel) * out.shape[0] * k * cin
                     * cout)

    def nin_hook(mod, args, out):
        a, b = mod.kernel.shape
        total[0] += passes(args[0], mod.kernel) * out.shape[0] * a * b

    def linear_hook(mod, args, out):
        rows = int(np.prod(out.shape[:-1]))
        total[0] += (passes(args[0], mod.weight) * rows * mod.in_features
                     * mod.out_features)

    hooks = []
    for mod in model.modules():
        if isinstance(mod, (SubmConv, StridedConv, Deconv)):
            hooks.append(mod.register_forward_hook(conv_hook))
        elif isinstance(mod, NetworkInNetwork):
            hooks.append(mod.register_forward_hook(nin_hook))
        elif isinstance(mod, nn.Linear):
            hooks.append(mod.register_forward_hook(linear_hook))
    wg_unpool = sparse_encoders.wg_unpool_apply

    def counted_unpool(h, wg_up, wg_down=None):
        taps = wg_up.rb_local.shape[1]
        total[0] += ((1 + int(train and h.requires_grad))
                     * wg_up.rb_local.shape[0] * taps * h.shape[1] ** 2)
        return wg_unpool(h, wg_up, wg_down)

    sparse_encoders.wg_unpool_apply = counted_unpool
    try:
        with torch.set_grad_enabled(train):
            model(batch, istrain=train, train=train)
    finally:
        sparse_encoders.wg_unpool_apply = wg_unpool
        for h in hooks:
            h.remove()
    return total[0]


def _smoke(**engine):
    cfg = load_config(os.path.join(REPO, "configs", "smoke_cpu.yaml"))
    cfg.engine = dataclasses.replace(cfg.engine, **engine)
    return cfg


def _unet():
    return _cfgs("float32")[1]


def _text():
    from tdwss_torch import config as pc

    return pc.Config(
        model_name="MultiLabelContrastive", has_text=True,
        label="scene_level",
        pointcloud_data=pc.PointcloudDataConfig(scale=20, batch_size=2),
        text_data=pc.TextDataConfig(max_seq_len=16, cropped_texts=3),
        pointcloud_model=pc.PointcloudModelConfig(
            name="SparseConvUNet", m=4, full_scale=64),
        text_model=pc.TextModelConfig(context_length=16, width=64,
                                      layers=2, vocab_size=1000),
        loss=pc.LossConfig(Classification=True, TextContrastive=True),
        engine=pc.EngineConfig(max_points=8192, min_level_capacity=256))


def _pseudo():
    return load_config(os.path.join(REPO, "configs",
                                    "smoke_cpu_pseudo.yaml"))


CASES = {
    "fcnet": (_smoke, True),
    "fcnet-eval": (_smoke, False),
    "unet": (_unet, True),
    "plans-free": (lambda: _smoke(host_plans=False), True),
    "fully-supervised": (_pseudo, True),
    "text": (_text, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mega_mul_add_equals_a_count_from_the_forward(case):
    make, train = CASES[case]
    cfg = make()
    scenes = make_dataset(2, num_points=3000, seed=106,
                          with_text=cfg.has_text)
    if cfg.label == "pseudo":
        for s in scenes:
            s.pseudo_labels = s.labels.copy()
    reset_sticky_plans()
    batch = train_collate(scenes, cfg, np.random.default_rng(8))
    if cfg.engine.host_plans:
        batch = slim_batch_for_train(attach_host_plans(batch, cfg), cfg)
    batch = batch.to("cpu")
    model = build_model(cfg, device="cpu")
    count = step_mul_adds(model, batch, train=train)
    assert count > 0
    assert count == _hooked_count(model, batch, train)
    bs = cfg.pointcloud_data.batch_size
    assert mega_mul_add(model, batch, per=bs, train=train) == \
        count / 1e6 / bs


def test_mega_mul_add_beside_the_reference():
    import jax

    from tdwss.config import load_config as ref_load_config
    from tdwss.data.collate import train_collate as ref_train_collate
    from tdwss.data.plans import attach_host_plans as ref_attach
    from tdwss.data.plans import slim_batch_for_train as ref_slim
    from tdwss.data.synthetic import make_dataset as ref_make_dataset
    from tdwss.engine.steps import TrainState, make_train_step
    from tdwss.engine.steps import make_optimizer as ref_make_optimizer
    from tdwss.models import build_model as ref_build_model
    from tdwss.ops.host_plan import reset_sticky_plans as ref_reset
    from tdwss.utils.flops import mega_mul_add as ref_mega_mul_add

    path = os.path.join(REPO, "configs", "smoke_cpu.yaml")
    ref_cfg, cfg = ref_load_config(path), load_config(path)
    ref_cfg.engine.plan_cache_batches = 0
    ref_cfg.engine.collate_workers = 1
    ref_reset()
    ref_b = ref_slim(ref_attach(ref_train_collate(
        ref_make_dataset(2, num_points=3000, seed=106, with_text=False),
        ref_cfg, np.random.default_rng(8)), ref_cfg), ref_cfg)
    ref_bj = jax.tree_util.tree_map(jnp.asarray, ref_b)
    model = ref_build_model(ref_cfg)
    variables = model.init(jax.random.PRNGKey(0), ref_bj, istrain=True)
    tx = ref_make_optimizer(ref_cfg, 100)
    state = TrainState(params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]),
                       step=jnp.zeros((), jnp.int32))
    bs = cfg.pointcloud_data.batch_size
    ref = ref_mega_mul_add(jax.jit(make_train_step(ref_cfg, model, tx)),
                           state, ref_bj, per=bs)
    reset_sticky_plans()
    batch = slim_batch_for_train(attach_host_plans(train_collate(
        make_dataset(2, num_points=3000, seed=106, with_text=False), cfg,
        np.random.default_rng(8)), cfg), cfg).to("cpu")
    ours = mega_mul_add(build_model(cfg, device="cpu"), batch, per=bs)
    print(f"MegaMulAdd per scene, smoke_cpu.yaml step: the reference's "
          f"(XLA) {ref:.1f}, the port's (plans) {ours:.1f}")
    assert 0 < ours < ref
