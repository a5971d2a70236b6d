"""KPConv backbone (twin of :mod:`tdwss.models.kpconv`).

Kernel-point convolution ops in plain PyTorch, the blocks and the KPFCNN
encoder/decoder, deterministic kernel-point dispositions, and the
host-side static-shape input pyramid on the port's build of the native
grid subsampling and radius-neighbour queries.
"""

from tdwss_torch.models.kpconv.architectures import (  # noqa: F401
    KPFCNN,
    deform_param_labels,
    kpfcnn_loss,
    param_groups,
)
from tdwss_torch.models.kpconv.blocks import KPBatch  # noqa: F401
from tdwss_torch.models.kpconv.config import (  # noqa: F401
    SCANNET_ARCHITECTURE,
    KPConvConfig,
)
from tdwss_torch.models.kpconv.kernel_points import load_kernels  # noqa: F401
from tdwss_torch.models.kpconv.pyramid import (  # noqa: F401
    calibrate_neighbors,
    segmentation_inputs,
)
