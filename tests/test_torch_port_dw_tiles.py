"""How the weight-gradient kernels K3 (``windowed_dw_sub``) and K5
(``windowed_dw``, its flat form) pick their body and tile, checked on the
CPU (no card is needed: the choices are pure functions of shapes and
dtypes).

- ``windowed.bwd_tile``: for every (C, Cout, K) that a config which runs
  on the port, or the bench UNet, sends to K3 or K5 (its convs' kernels
  from the built model: the backward of a conv that takes neither K2,
  by ``sparse_conv._gather_route``, nor K6, a 27-tap subm conv; nothing is
  planned), bf16 takes the tensor-core dW tile, whose sides are 32 or 64
  and cover the widths up to 64; f32 keeps the CUDA-core tile.
- The dW partials: the chunk count derived from the tile stays within
  ``_PART_BYTES`` (read when called) and within V_out.
- On CPU tensors both wrappers run their plain versions and count no
  launch, per kernel and per body; K5's plain version on flat locals
  equals K3's on the same windows bit for bit.
"""

import glob
import os

import pytest
import torch

from tdwss_torch.config import (Config, EngineConfig, LossConfig,
                                PointcloudDataConfig, PointcloudModelConfig,
                                load_config)
from tdwss_torch.models.meta_arch import build_model
from tdwss_torch.ops import sparse_conv
from tdwss_torch.ops import windowed as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_configs():
    out = []
    for path in sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))):
        cfg = load_config(path)
        if (cfg.model_name == "MultiLabel" and not cfg.has_text
                and cfg.label == "scene_level"):
            out.append(os.path.basename(path))
    return out


PORT_CONFIGS = _port_configs()


def _bench_unet():
    """The bench UNet (``bench.py``'s model: m=32, 7 levels, block_reps 2,
    residual blocks)."""
    return Config(
        model_name="MultiLabel", label="scene_level",
        pointcloud_data=PointcloudDataConfig(scale=50),
        pointcloud_model=PointcloudModelConfig(
            name="SparseConvUNet", m=32, full_scale=4096, block_reps=2,
            residual_blocks=True),
        loss=LossConfig(Classification=True),
        engine=EngineConfig(compute_dtype="bfloat16"))


def _dw_shapes(cfg):
    """(C, Cout, K) of every conv backward of the config's model that
    takes K3 (sub-form plans) or K5 (flat): neither K2 (both widths pass
    the gather gate) nor K6 (a 27-tap subm conv)."""
    model = build_model(cfg, device="cpu")
    out = set()
    for n, p in model.named_parameters():
        if not (n.endswith(".kernel") and p.dim() == 3):
            continue
        k, cin, cout = p.shape
        if not sparse_conv._gather_route(True, cin, cout) and k != 27:
            out.add((cin, cout, k))
    return sorted(out)


def _config(name):
    return (_bench_unet() if name == "bench UNet"
            else load_config(os.path.join(REPO, "configs", name)))


ALL = ["bench UNet"] + PORT_CONFIGS


def test_the_bench_unet_and_narrow_send_their_wide_cross_level_convs_to_k3():
    assert _dw_shapes(_bench_unet()) == [
        (128, 160, 8), (160, 128, 8), (160, 192, 8), (192, 160, 8),
        (192, 224, 8), (224, 192, 8)]
    assert _dw_shapes(load_config(os.path.join(
        REPO, "configs", "3DUNetWithText_scannet_fcnet_baseline_narrower.yaml"
    ))) == [(128, 192, 8), (192, 256, 8)]


@pytest.mark.parametrize("name", ALL)
def test_tiles_of_every_dw_shape_of_a_config(name):
    for c, cout, k in _dw_shapes(_config(name)):
        for kernel in (W.K3, W.K5):
            t = W.bwd_tile(kernel, c, cout, k, torch.bfloat16)
            assert set(t) == {"body", "tm", "tn"}
            assert t["body"] == W.BODY_MMA
            for side, width in ((t["tm"], c), (t["tn"], cout)):
                assert side in (32, 64)
                assert side >= min(width, 64)
                assert width > 32 or side == 32
            assert k <= W.KMAX
            f32 = W.bwd_tile(kernel, c, cout, k, torch.float32)
            assert f32 == {"body": W.BODY_FMA, **W._fma_dw_tile(c, cout)}


@pytest.mark.parametrize("name", ALL)
def test_dw_partials_of_every_dw_shape_stay_in_bounds(name):
    for c, cout, k in _dw_shapes(_config(name)):
        for dtype in (torch.bfloat16, torch.float32):
            tile = W.bwd_tile(W.K3, c, cout, k, dtype)
            for v_out in (786432, 32768, 4096, 257, 1):
                n = W._nchunks(v_out, c, cout, k, tile)
                assert 1 <= n <= v_out
                assert n == 1 or n * k * c * cout * 4 <= W._PART_BYTES


@pytest.mark.parametrize("kernel,c,cout,k,tm,tn", [
    (W.K3, 32, 32, 27, 32, 32),      # the bench level 0
    (W.K5, 32, 32, 27, 32, 32),
    (W.K3, 128, 160, 8, 64, 64),     # the bench UNet's strided conv 3 -> 4
    (W.K3, 224, 192, 8, 64, 64),     # its deconv 6 -> 5
    (W.K3, 192, 256, 8, 64, 64),     # Narrow's strided conv 3 -> 4
    (W.K5, 224, 192, 8, 64, 64),
    (W.K3, 3, 48, 27, 32, 64),
    (W.K5, 48, 16, 8, 64, 32),
])
def test_tile_choice_at_named_shapes(kernel, c, cout, k, tm, tn):
    assert W.bwd_tile(kernel, c, cout, k, torch.bfloat16) == {
        "body": W.BODY_MMA, "tm": tm, "tn": tn}


@pytest.mark.parametrize("kernel", [W.K3, W.K5])
@pytest.mark.parametrize("c,cout,side", [(32, 32, 32), (3, 32, 32),
                                         (64, 32, 64), (224, 192, 64)])
def test_f32_keeps_the_cuda_core_tile(kernel, c, cout, side):
    assert W.bwd_tile(kernel, c, cout, 8, torch.float32) == {
        "body": W.BODY_FMA, "tm": side, "tn": side}


def test_chunks_follow_the_tile():
    # enough chunks for the block target over a chunk's tiles, unless the
    # row floor or the partials' memory cap binds first
    def cap(c, cout, k):
        return W._PART_BYTES // (k * c * cout * 4)

    t = W.bwd_tile(W.K3, 32, 32, 27, torch.bfloat16)
    assert W._nchunks(638976, 32, 32, 27, t) == min(
        W._TARGET_BLOCKS, cap(32, 32, 27))
    t = W.bwd_tile(W.K3, 224, 192, 8, torch.bfloat16)       # 4 x 3 tiles
    assert W._nchunks(4096, 224, 192, 8, t) == min(
        -(-W._TARGET_BLOCKS // 12), 4096 // W._MIN_CHUNK_ROWS,
        cap(224, 192, 8))
    assert W._nchunks(100, 224, 192, 8, t) == 1


def test_chunks_read_the_partials_cap_when_called(monkeypatch):
    # the cap is looked up at each call, so a tool or test may set it
    t = W.bwd_tile(W.K3, 224, 192, 8, torch.bfloat16)
    monkeypatch.setattr(W, "_PART_BYTES", 3 * 8 * 224 * 192 * 4)
    assert W._nchunks(32768, 224, 192, 8, t) == 3


def test_tensor_core_body_refuses_indices_past_32_bits():
    rb = torch.empty((8, 0), dtype=torch.int32)
    W._check_mma_sizes(2 ** 31 - 1, 2 ** 31 - 1, rb)
    for v_out, v_src in ((2 ** 31, 1), (1, 2 ** 31)):
        with pytest.raises(ValueError):
            W._check_mma_sizes(v_out, v_src, rb)


def _sub_plan(gen, v_out=256, v_src=300, k=8, tile=64, sub=8, window=32,
              subwin=16):
    starts = torch.randint(-4, v_src - window + 4, (v_out // tile,),
                           generator=gen, dtype=torch.int32)
    soff = torch.randint(0, window - subwin + 1, (v_out // sub,),
                         generator=gen, dtype=torch.int32)
    rb = torch.randint(0, subwin + 1, (k, v_out), generator=gen,
                       dtype=torch.int32)
    rb[:, :16] = subwin                           # a block of sentinels
    return starts, soff, rb, dict(window=window, tile=tile, sub=sub,
                                  subwin=subwin)


def _flat_locals(soff, rb, geo):
    """The sub-form locals as flat-form locals on the same windows (one
    window per tile): local + the row's sub-window offset, a sentinel as
    ``window``."""
    big = soff.repeat_interleave(geo["sub"])[None, :]
    dead = (rb < 0) | (rb >= geo["subwin"])
    return torch.where(dead, torch.full_like(rb, geo["window"]),
                       rb + big).to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_take_the_plain_versions_and_count_nothing(dtype):
    gen = torch.Generator().manual_seed(0)
    starts, soff, rb, geo = _sub_plan(gen)
    x = torch.randn((300, 24), generator=gen).to(dtype)
    dout = torch.randn((256, 40), generator=gen).to(dtype)
    flat = _flat_locals(soff, rb, geo)
    W.reset_launches()
    got = W.windowed_dw_sub(x, starts, soff, rb, dout, **geo)
    assert torch.equal(got, W.windowed_dw_sub_plain(x, starts, soff, rb,
                                                    dout, **geo))
    got = W.windowed_dw(x, starts, flat, dout, geo["window"], geo["tile"])
    assert torch.equal(got, W.windowed_dw_plain(x, starts, flat, dout,
                                                geo["window"], geo["tile"]))
    assert got.dtype == torch.float32 and got.shape == (8, 24, 40)
    for kernel in (W.K3, W.K5):
        assert W.launches[kernel] == 0
        for body in (W.BODY_MMA, W.BODY_FMA):
            assert W.body_launches[f"{kernel}:{body}"] == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k5_plain_on_flat_locals_equals_k3_on_the_same_windows(dtype):
    gen = torch.Generator().manual_seed(1)
    starts, soff, rb, geo = _sub_plan(gen, v_out=512, v_src=480, k=27)
    x = torch.randn((480, 16), generator=gen).to(dtype)
    dout = torch.randn((512, 32), generator=gen).to(dtype)
    k3 = W.windowed_dw_sub_plain(x, starts, soff, rb, dout, **geo)
    k5 = W.windowed_dw_plain(x, starts, _flat_locals(soff, rb, geo), dout,
                             geo["window"], geo["tile"])
    assert torch.equal(k3, k5)
    assert k3.abs().sum() > 0
