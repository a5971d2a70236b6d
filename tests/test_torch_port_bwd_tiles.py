"""How the fused backward kernels K2 (``windowed_bwd_gather``) and K6
(``windowed_bwd_sub``) pick their body and tiles, checked on the CPU (no
card is needed: the choices are pure functions of shapes and dtypes).

- ``windowed.bwd_tile``: for every (Cin, Cout, K) that a config which runs
  on the port sends to K2 or K6 (its convs' kernels from the built model,
  routed by ``sparse_conv._gather_route`` on sub-form plans; nothing is
  planned), bf16 takes the tensor-core body: a dfeats column tile that is
  a legal ``mma.sync`` N and covers Cin, and a dW tile of (Cin, Cout)
  whose sides are 32 or 64 and cover the widths up to 64; f32 takes the
  CUDA-core body.
- The dW partials: the chunk count derived from the tile stays within
  ``_PART_BYTES`` (K2) or ``_SUB_PART_BYTES`` (K6) and within V_out.
- On CPU tensors both wrappers run their plain versions and count no
  launch.
"""

import glob
import os

import pytest
import torch

from tdwss_torch.config import load_config
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


def _bwd_shapes(cfg):
    """(kernel, Cin, Cout, K) of every K2 / K6 backward the config's model
    makes on sub-form plans: K2 where both widths pass the gather gate,
    else K6 for a 27-tap subm conv (a cross-level conv over the gate takes
    K3 and K1, which are not these kernels)."""
    model = build_model(cfg, device="cpu")
    out = set()
    for n, p in model.named_parameters():
        if not (n.endswith(".kernel") and p.dim() == 3):
            continue
        k, cin, cout = p.shape
        if sparse_conv._gather_route(True, cin, cout):
            out.add((W.K2, cin, cout, k))
        elif k == 27:
            out.add((W.K6, cin, cout, k))
    return sorted(out)


def _check_tile(kernel, cin, cout, k):
    t = W.bwd_tile(kernel, cin, cout, k, torch.bfloat16)
    assert set(t) == {"body", "n", "tm", "tn"} and t["body"] == W.BODY_MMA
    n = t["n"]
    # the dfeats product is K1's body over an output of width Cin
    assert t["n"] == W.fwd_tile(cout, cin, k, torch.bfloat16)["n"]
    assert n % 8 == 0 and n in (32, 64, 128, 256)
    tiles = -(-cin // n)
    assert n * tiles >= cin > n * (tiles - 1)
    # dW: sides 32 or 64, each warp a 32 x 32 tile (four n8 mma tiles)
    for side, width in ((t["tm"], cin), (t["tn"], cout)):
        assert side in (32, 64) and side % 8 == 0
        assert side >= min(width, 64)
        assert width > 32 or side == 32
    assert k <= W.KMAX
    return t


def test_the_port_builds_thirteen_configs():
    assert len(PORT_CONFIGS) == 13


@pytest.mark.parametrize("name", PORT_CONFIGS)
def test_tiles_of_every_backward_shape_of_a_config(name):
    cfg = load_config(os.path.join(REPO, "configs", name))
    shapes = _bwd_shapes(cfg)
    assert any(kern == W.K2 and cin == 3 for kern, cin, _, _ in shapes)
    for kernel, cin, cout, k in shapes:
        _check_tile(kernel, cin, cout, k)
        f32 = W.bwd_tile(kernel, cin, cout, k, torch.float32)
        assert f32["body"] == W.BODY_FMA


@pytest.mark.parametrize("name", PORT_CONFIGS)
def test_dw_partials_of_every_backward_shape_stay_in_bounds(name):
    cfg = load_config(os.path.join(REPO, "configs", name))
    for kernel, cin, cout, k in _bwd_shapes(cfg):
        cap = W._PART_BYTES if kernel == W.K2 else W._SUB_PART_BYTES
        for dtype in (torch.bfloat16, torch.float32):
            tile = W.bwd_tile(kernel, cin, cout, k, dtype)
            for v_out in (786432, 65536, 4096, 257, 1):
                n = (W._nchunks(v_out, cin, cout, k, tile) if kernel == W.K2
                     else W._nchunks_sub(v_out, cin, cout, k, tile))
                assert 1 <= n <= v_out
                assert n == 1 or n * k * cin * cout * 4 <= cap


@pytest.mark.parametrize("kernel,cin,cout,k,n,tm,tn", [
    (W.K2, 32, 32, 27, 32, 32, 32),      # the bench level 0
    (W.K2, 3, 32, 27, 32, 32, 32),       # the stem (dW only)
    (W.K2, 16, 16, 27, 32, 32, 32),      # m = 16, level 0
    (W.K2, 64, 128, 8, 64, 64, 64),      # a cross-level backward
    (W.K2, 128, 128, 27, 128, 64, 64),
    (W.K6, 384, 192, 27, 256, 64, 64),   # the bench UNet's level 5
    (W.K6, 256, 256, 27, 256, 64, 64),   # Narrow's level 4
    (W.K6, 160, 160, 27, 256, 64, 64),
])
def test_tile_choice_at_named_shapes(kernel, cin, cout, k, n, tm, tn):
    assert W.bwd_tile(kernel, cin, cout, k, torch.bfloat16) == {
        "body": W.BODY_MMA, "n": n, "tm": tm, "tn": tn}


@pytest.mark.parametrize("cin,cout,want", [
    (32, 32, {"tm": 32, "tn": 32}), (3, 32, {"tm": 32, "tn": 32}),
    (64, 32, {"tm": 64, "tn": 64}), (128, 128, {"tm": 64, "tn": 64})])
def test_k2_f32_keeps_the_cuda_core_tiles(cin, cout, want):
    assert W.bwd_tile(W.K2, cin, cout, 27, torch.float32) == {
        "body": W.BODY_FMA, **want}


@pytest.mark.parametrize("cout,slab", [(48, 64), (64, 64), (128, 128),
                                       (192, 256), (256, 256)])
def test_k6_f32_keeps_the_cuda_core_tiles(cout, slab):
    assert W.bwd_tile(W.K6, 384, cout, 27, torch.float32) == {
        "body": W.BODY_FMA, "tm": 32, "slab": slab}


def test_tile_choice_rejects_other_dtypes_and_kernels():
    with pytest.raises(TypeError):
        W.bwd_tile(W.K2, 32, 32, 27, torch.float16)
    with pytest.raises(ValueError):
        W.bwd_tile(W.K1, 32, 32, 27, torch.bfloat16)


def test_chunks_follow_the_tile():
    # enough chunks for the target block count over the tiles of a chunk,
    # unless the partials' memory cap binds first
    v_out, k = 786432, 27

    def cap(cin, cout, part_bytes=W._PART_BYTES):
        return part_bytes // (k * cin * cout * 4)

    assert W._nchunks(v_out, 32, 32, k, {"tm": 32, "tn": 32}) == (
        W._TARGET_BLOCKS)
    assert W._nchunks(v_out, 64, 32, k, {"tm": 64, "tn": 32}) == min(
        W._TARGET_BLOCKS, cap(64, 32))
    assert W._nchunks(v_out, 128, 128, k, {"tm": 64, "tn": 64}) == min(
        W._TARGET_BLOCKS // 4, cap(128, 128))
    assert W._nchunks(v_out, 128, 128, k, {"tm": 64, "tn": 64},
                      1 << 40) == W._TARGET_BLOCKS // 4
    # K6's f32 body: one block per 32 input channels, every output channel
    assert W._nchunks_sub(v_out, 384, 192, k, {"tm": 32, "slab": 256}) == (
        min(-(-W._TARGET_BLOCKS // 12), cap(384, 192, W._SUB_PART_BYTES)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_take_the_plain_versions_and_count_nothing(dtype):
    gen = torch.Generator().manual_seed(0)
    v, k, tile, sub, window, subwin = 256, 27, 64, 8, 32, 16
    cin, cout = 8, 16
    feats = torch.randn((v, cin), generator=gen).to(dtype)
    dout = torch.randn((v, cout), generator=gen).to(dtype)
    wt = torch.randn((k, cout, cin), generator=gen).to(dtype)
    starts = torch.randint(0, v - window, (v // tile,), generator=gen,
                           dtype=torch.int32)
    soff = torch.randint(0, window - subwin + 1, (v // sub,), generator=gen,
                         dtype=torch.int32)
    rb = torch.randint(0, subwin + 1, (v, k), generator=gen,
                       dtype=torch.int32)
    geo = (window, tile, sub, subwin)
    W.reset_launches()
    for need in (True, False):
        got = W.windowed_bwd_gather(dout, feats, starts, soff, rb.t(), wt,
                                    *geo, need_dfeats=need)
        ref = W.windowed_bwd_gather_plain(dout, feats, starts, soff, rb.t(),
                                          wt, *geo, need_dfeats=need)
        assert torch.equal(got[1], ref[1])
        assert (got[0] is None) == (not need)
        if need:
            assert torch.equal(got[0], ref[0])
        got = W.windowed_bwd_sub(feats, dout, starts, soff, rb.t(), wt, *geo,
                                 need_dfeats=need)
        ref = W.windowed_bwd_sub_plain(feats, dout, starts, soff, rb.t(), wt,
                                       *geo, need_dfeats=need)
        assert torch.equal(got[1], ref[1])
        if need:
            assert torch.equal(got[0], ref[0])
    assert not any(W.launches.values())
    assert not any(W.body_launches.values())
