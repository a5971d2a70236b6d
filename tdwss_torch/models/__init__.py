"""The model zoo (twin of :mod:`tdwss.models`): the sparse-conv encoders,
the text transformer, the meta-architectures and the KPConv backbone.

Importing this package registers every model in
``tdwss_torch.registry.MODEL_REGISTRY``, as the reference's does.
"""

from tdwss_torch.models import layers  # noqa: F401
from tdwss_torch.models import sparse_encoders  # noqa: F401
from tdwss_torch.models import transformer  # noqa: F401
from tdwss_torch.models import meta_arch  # noqa: F401
from tdwss_torch.models import kpconv  # noqa: F401

from tdwss_torch.models.sparse_encoders import (  # noqa: F401
    SparseConvUNet,
    SparseConvFCNet,
    SparseConvFCNetNarrow,
    SparseConvFCNetDirectUpPool,
    SparseConvFCNetDirectUpPoolLight,
)
from tdwss_torch.models.meta_arch import (  # noqa: F401
    FullySupervised,
    MultiLabel,
    MultiLabelContrastive,
    build_model,
)
from tdwss_torch.models.transformer import TextTransformer  # noqa: F401
