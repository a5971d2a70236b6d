"""K7, the brick engine's block gather: the port's plain version and
dispatcher against the reference's Pallas kernel (interpret mode on the
CPU) and its ``jnp.take`` dispatcher, bit for bit.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the plain version there, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdwss.ops.experimental.pallas_gather import \
    dma_block_gather as ref_dma_block_gather
from tdwss.ops.experimental.pallas_gather import \
    gather_blocks as ref_gather_blocks
from tdwss_torch.ops.experimental import block_gather as bg

# numpy has no bf16: the values are drawn in f32, rounded to bf16 in
# torch and handed to JAX through their f32 image, which bf16 holds
# exactly.
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _src(rng, shape, dtype):
    t_dtype, j_dtype = DTYPES[dtype]
    src = torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                           ).to(t_dtype)
    return src, jnp.asarray(src.float().numpy()).astype(j_dtype)


def _idx(rng, n, m):
    """m indices in [-5, n + 5): out of range at both ends."""
    idx = rng.integers(-5, n + 5, size=(m,)).astype(np.int32)
    idx[:4] = [-1, n, -7, n + 3]
    return idx


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,r,w,m", [(128, 8, 128, 64), (40, 16, 256, 96)])
def test_plain_equals_pallas_interpret(dtype, n, r, w, m):
    rng = np.random.default_rng(7 + r)
    src, src_j = _src(rng, (n, r, w), dtype)
    idx = _idx(rng, n, m)
    out = bg.dma_block_gather_plain(src, torch.from_numpy(idx))
    ref = ref_dma_block_gather(src_j, jnp.asarray(idx), interpret=True)
    assert out.dtype == src.dtype and tuple(out.shape) == (m, r, w)
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    # the CPU wrapper takes the plain version
    wrapped = bg.dma_block_gather(src, torch.from_numpy(idx))
    assert torch.equal(wrapped, out)
    # clipped, not masked: index n + 3 reads the last block
    assert torch.equal(out[3], src[n - 1]) and torch.equal(out[2], src[0])


@pytest.mark.parametrize("shape,m", [
    ((64, 8, 128), 50),              # M not a multiple of 32
    ((64, 8, 128), 31),
    ((64, 128), 32),                 # src not 3-D
    ((64, 4, 128), 32),              # block height not a multiple of 8
])
def test_contract_errors_as_the_reference(shape, m):
    rng = np.random.default_rng(1)
    src = np.zeros(shape, np.float32)
    idx = _idx(rng, shape[0], m)
    with pytest.raises(ValueError):
        ref_dma_block_gather(jnp.asarray(src), jnp.asarray(idx),
                             interpret=True)
    for fn in (bg.dma_block_gather, bg.dma_block_gather_plain):
        with pytest.raises(ValueError):
            fn(torch.from_numpy(src), torch.from_numpy(idx))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape,m", [((128, 8, 128), 64), ((64, 8, 256), 50),
                                     ((33, 3, 5), 50), ((17, 6), 7)])
def test_gather_blocks_equals_reference_take(dtype, shape, m):
    rng = np.random.default_rng(11)
    src, src_j = _src(rng, shape, dtype)
    idx = _idx(rng, shape[0], m)
    bg.reset_launches()
    out = bg.gather_blocks(src, torch.from_numpy(idx))
    ref = ref_gather_blocks(src_j, jnp.asarray(idx))
    assert tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    # an int64 index gives the same rows; the CPU never counts a launch
    out64 = bg.gather_blocks(src, torch.from_numpy(idx.astype(np.int64)))
    assert torch.equal(out64, out)
    assert bg.launches == {bg.K7: 0}


def test_work_is_the_hand_count():
    # 46,720 distinct blocks of 8 x 256 bf16 = 4,096 B, read and written;
    # 4 B of index each (the halo-face gather's size at the bench level 0)
    src = torch.zeros((46720, 8, 256), dtype=torch.bfloat16)
    idx = torch.arange(46720, dtype=torch.int32)
    nbytes, flops = bg.work(src, idx)
    assert nbytes == 2 * 46720 * 4096 + 4 * 46720 == 382_917_120
    assert flops == 0
    # repeated and clipped indices read their block once: of these 64,
    # 0..31 (with -3 and -1 clipped to 0) and 127 (200, 128 and 127)
    small = torch.zeros((128, 8, 128), dtype=torch.float32)
    idx = torch.tensor(list(range(32)) + [-3, -1, 200, 128, 127] * 6
                       + [5, 7], dtype=torch.int32)
    assert bg.work(small, idx) == ((33 + 64) * 8 * 128 * 4 + 4 * 64, 0)


def test_vector_width_divides_the_row_and_pointers():
    assert bg._vec_bytes(4096, 256, 1024) == 16
    assert bg._vec_bytes(4096, 264, 1024) == 8
    assert bg._vec_bytes(60, 256, 256) == 4
    assert bg._vec_bytes(30, 256, 256) == 2
    assert bg._vec_bytes(15, 256, 256) == 1


def test_bad_arguments_raise():
    src = torch.zeros((8, 8, 128))
    with pytest.raises(TypeError):
        bg.gather_blocks(src, torch.zeros((32,)))
    with pytest.raises(ValueError):
        bg.gather_blocks(src, torch.zeros((4, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        bg.gather_blocks(torch.zeros((0, 8, 128)),
                         torch.zeros((32,), dtype=torch.int32))
    empty = bg.gather_blocks(src, torch.zeros((0,), dtype=torch.int32))
    assert tuple(empty.shape) == (0, 8, 128)
    # neither the CPU nor CUDA: no silent plain path
    with pytest.raises(ValueError):
        bg.gather_blocks(torch.zeros((8, 8, 128), device="meta"),
                         torch.zeros((32,), dtype=torch.int32,
                                     device="meta"))
