"""How the forward kernels K1/K4 and the block gather K7 pick their body,
tile and copy width, checked on the CPU (no card is needed: the choices
are pure functions of shapes, dtypes and addresses).

- ``windowed.fwd_tile``: for every (C, Cout, K) that a config which runs
  on the port sends through K1/K4 (its convs' kernels and its identity
  unpools, from the built model and ``plane_schedule``; nothing is
  planned), bf16 takes the tensor-core body with a column tile that is a
  legal ``mma.sync`` / ``wgmma`` N and covers Cout (the kernel derives
  the rest of its tiling from N, and checks its shared memory at compile
  time); f32 takes the CUDA-core body.
- ``block_gather._vec_bytes``: K7's copies are as wide as the row size
  and both addresses allow, 16 bytes where all are multiples of 16.
- On CPU tensors both wrappers run their plain versions and
  count no launch.
"""

import glob
import os

import pytest
import torch

from tdwss_torch.config import load_config
from tdwss_torch.models.meta_arch import build_model
from tdwss_torch.models.sparse_encoders import (DirectUpPoolBody, FCNBody,
                                                plane_schedule)
from tdwss_torch.ops import windowed as W
from tdwss_torch.ops.experimental import block_gather as BG

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


def _fwd_shapes(cfg):
    """(C, Cout, K) of every K1/K4 forward the config's model makes: each
    conv kernel (K, C, Cout) and each identity unpool (C = Cout = the
    width of the level below's output, K = the strided conv's taps)."""
    model = build_model(cfg, device="cpu")
    shapes = {(p.shape[1], p.shape[2], p.shape[0])
              for n, p in model.named_parameters()
              if n.endswith(".kernel") and p.dim() == 3}
    planes = plane_schedule(cfg.pointcloud_model)
    body = model.pc_encoder.body
    if isinstance(body, (FCNBody, DirectUpPoolBody)):
        k = body.down_conv.kernel.shape[0]
        for i in range(len(planes) - 1):
            c = (sum(planes[i + 1:]) if isinstance(body, FCNBody)
                 else planes[-1])
            shapes.add((c, c, k))
    return sorted(shapes)


def test_the_port_builds_thirteen_configs():
    assert len(PORT_CONFIGS) == 13


@pytest.mark.parametrize("name", PORT_CONFIGS)
def test_tile_of_every_forward_shape_of_a_config(name):
    cfg = load_config(os.path.join(REPO, "configs", name))
    shapes = _fwd_shapes(cfg)
    assert any(c == 3 for c, _, _ in shapes)            # the stem
    for c, cout, k in shapes:
        t = W.fwd_tile(c, cout, k, torch.bfloat16)
        assert set(t) == {"body", "n"} and t["body"] == W.BODY_MMA
        n = t["n"]
        # a legal N of mma.sync (a multiple of 8) and of wgmma (<= 256)
        assert n % 8 == 0 and 8 <= n <= 256 and n in (32, 64, 128, 256)
        tiles = -(-cout // n)
        assert n * tiles >= cout > n * (tiles - 1)
        if cout <= 256:                       # one tile, the narrowest
            assert tiles == 1 and (n == 32 or cout > n // 2)
        else:
            assert n == 256
        assert k <= W.KMAX
        assert W.fwd_tile(c, cout, k, torch.float32) == {"body": W.BODY_FMA}


@pytest.mark.parametrize("c,cout,k,n,tiles", [
    (32, 32, 27, 32, 1),     # the bench level 0
    (3, 32, 27, 32, 1),      # the stem
    (16, 16, 27, 32, 1),     # m = 16, level 0
    (64, 64, 27, 64, 1),
    (32, 48, 8, 64, 1),
    (96, 96, 27, 128, 1),
    (160, 160, 27, 256, 1),
    (640, 640, 8, 256, 3),   # Narrow's level-0 unpool
    (432, 432, 8, 256, 2),   # FCNet's level-0 unpool
])
def test_tile_choice_at_named_shapes(c, cout, k, n, tiles):
    t = W.fwd_tile(c, cout, k, torch.bfloat16)
    assert t == {"body": W.BODY_MMA, "n": n}
    assert -(-cout // t["n"]) == tiles


def test_tile_choice_rejects_other_dtypes():
    with pytest.raises(TypeError):
        W.fwd_tile(32, 32, 27, torch.float16)


@pytest.mark.parametrize("row_bytes,src,out,want", [
    (4096, 0, 4096, 16),          # the halo faces
    (16, 256, 512, 16),
    (4096, 8, 4096, 8),           # src 8-byte aligned only
    (4096, 0, 4100, 4),           # out 4-byte aligned only
    (30, 0, 0, 2),                # (5, 3) bf16 rows
    (24, 0, 0, 8),
    (7, 0, 0, 1),
])
def test_k7_copy_width_choice(row_bytes, src, out, want):
    assert BG._vec_bytes(row_bytes, src, out) == want


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    # CPU tensors take the plain versions on any host, with a card or not
    gen = torch.Generator().manual_seed(0)
    v, k, tile, sub, window, subwin = 256, 27, 64, 8, 32, 16
    x = torch.randn((v, 8), generator=gen).to(torch.bfloat16)
    w = torch.randn((k, 8, 16), generator=gen).to(torch.bfloat16)
    starts = torch.randint(0, v - window, (v // tile,), generator=gen,
                           dtype=torch.int32)
    soff = torch.randint(0, window - subwin + 1, (v // sub,), generator=gen,
                         dtype=torch.int32)
    rb = torch.randint(0, subwin + 1, (v, k), generator=gen,
                       dtype=torch.int32)
    W.reset_launches()
    BG.reset_launches()
    out = W.windowed_matmul_sub(x, starts, soff, rb.t(), w, window, tile,
                                sub, subwin)
    ref = W.windowed_matmul_sub_plain(x, starts, soff, rb.t(), w, window,
                                      tile, sub, subwin)
    assert torch.equal(out, ref)
    src = torch.randn((40, 8, 16), generator=gen)
    idx = torch.randint(-3, 45, (64,), generator=gen, dtype=torch.int32)
    assert torch.equal(BG.gather_blocks(src, idx),
                       BG.dma_block_gather_plain(src, idx))
    assert not any(W.launches.values()) and not any(
        W.body_launches.values())
    assert not any(BG.launches.values())
