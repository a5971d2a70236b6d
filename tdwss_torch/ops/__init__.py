"""The sparse voxel engine (twin of :mod:`tdwss.ops`).

- ``coords``      integer coordinate keys, the stable key sort, the sorted
                  lookup, kernel offsets
- ``voxelize``    points -> deduplicated voxels and voxel -> point
                  devoxelization
- ``plan``        every level's coordinate system and rulebooks (device
                  planner); ``host_plan`` builds the windowed metadata on
                  the host
- ``sparse_conv`` the convolution routes (windowed gather-GEMMs on the
                  hand-written kernels of ``windowed``, spill tiers,
                  rulebook forms) and the rulebook pools
- ``segment``     per-scene segment sums and means

The names below are the reference package's exports.  ``voxelize`` is
the function, as in the reference; the module is
``importlib.import_module("tdwss_torch.ops.voxelize")``.  Importing this
package builds no kernel: each is built at its first launch.
"""

from tdwss_torch.ops.coords import (  # noqa: F401
    COORD_BITS,
    INVALID_KEY,
    kernel_offsets,
    lookup_sorted,
    make_keys,
)
from tdwss_torch.ops.voxelize import SparseGrid, devoxelize, voxelize  # noqa: F401
from tdwss_torch.ops.plan import GridLevel, LevelPlans, build_plans  # noqa: F401
from tdwss_torch.ops.sparse_conv import (  # noqa: F401
    deconv_apply,
    gather_neighbors,
    max_pool,
    strided_conv_apply,
    subm_conv_apply,
    unpool,
)
from tdwss_torch.ops.segment import segment_mean_by_batch, segment_sum_by_batch  # noqa: F401
