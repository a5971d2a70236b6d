"""Experimental sparse-conv engines: on no path of the system.

Twins of the reference's ``tdwss/ops/experimental`` package, kept, as
there, for denser data and for later revisits; no config, model or
entry point of ``tdwss_torch`` calls them.

- ``brick_plan``: the host brick decomposition of one voxel level into
  occupied ``S^3`` bricks (``S`` = 8), with the cell <-> voxel maps and
  the 26-neighbourhood adjacency between occupied bricks, padded to a
  sticky brick capacity;
- ``brick_conv``: the 3^3 submanifold convolution computed as a dense
  ``conv3d`` over the occupied bricks, each with a one-cell halo taken
  from its neighbours; equal to ``tdwss_torch.ops.sparse_conv.
  subm_conv_apply`` at the occupied cells;
- ``block_gather``: ``out[i] = src[clip(idx[i], 0, N-1)]`` over whole
  blocks, the kernel K7 (CUDA, ``tdwss_torch/csrc/block_gather.cu``) in
  place of the reference's Pallas DMA pipeline, with its plain version
  and the engine's dispatcher ``gather_blocks``.

The windowed engine (``tdwss_torch.ops.sparse_conv`` with the kernels of
``tdwss_torch.ops.windowed``) stays the one the models run.  The brick
conv's and K7's times on an H100 are in ``PERF.md``.
"""
