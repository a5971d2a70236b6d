"""tdwss_torch — the PyTorch/CUDA port of :mod:`tdwss` for NVIDIA Hopper.

The JAX package ``tdwss`` is the reference.  This package keeps its module
names (``tdwss_torch.ops.sparse_conv`` is the twin of
``tdwss.ops.sparse_conv``) and imports only torch, numpy and the standard
library.  Every Pallas kernel of the reference on a ported path is a CUDA
kernel written by hand for ``sm_90a`` (``tdwss_torch/csrc``), built at
first use into ``build/tdwss_torch/`` and bound with ctypes; each keeps a
plain PyTorch version beside it, which CPU tensors take.

The port does all that the reference does.  Its public surface is the
reference's, name for name, bound to the port's counterparts::

    from tdwss_torch.ops import (voxelize, build_plans, subm_conv_apply,
                                 devoxelize, segment_mean_by_batch,
                                 max_pool, gather_neighbors)
    from tdwss_torch.models import build_model, MultiLabel
    from tdwss_torch.engine import Trainer, validate, train_step
    from tdwss_torch.parallel import average_gradients
    from tdwss_torch.config import load_config, config_from_dict

except the reference's jit machinery (``TrainState``, ``make_*_step``,
the data-parallel harmonisers), whose counterparts are the plain
:func:`tdwss_torch.engine.train_step` / :func:`~tdwss_torch.engine.eval_step`
and the functions of :mod:`tdwss_torch.parallel`.

What is ported: multi-view-vote validation and the training step of
``MultiLabel``, ``FullySupervised`` and ``MultiLabelContrastive`` over
``SparseConvUNet`` and the FCN-family encoders
(:mod:`tdwss_torch.models.sparse_encoders`) on the windowed kernels,
with the text tower (:mod:`tdwss_torch.models.transformer`), the
``TextContrastive`` loss and the tokenizer
(:mod:`tdwss_torch.data.tokenizer`); the weak-supervision loop through
its entry points (:class:`tdwss_torch.engine.Trainer` over the
prefetching train loader, the pseudo-label stage
:mod:`tdwss_torch.engine.pseudo`, ``python -m tdwss_torch.cli.<name>``);
data-parallel training over ``torch.distributed``
(:mod:`tdwss_torch.parallel`, ``mesh.data > 1`` under ``torchrun``); the
plans-free branch (``engine.host_plans: false``: voxelization, keys and
every level's rulebooks on the device); ``engine.remat``; the KPConv
backbone (:mod:`tdwss_torch.models.kpconv`); the registry
(:mod:`tdwss_torch.registry`); the offline tools (GSS proposals
:mod:`tdwss_torch.gss`, boxes in the train batch, the projector
:mod:`tdwss_torch.models.projector`, point-to-mask rendering
:mod:`tdwss_torch.ops.point2mask`, the pseudo-image mask pipeline, PLY
and ScanNet preparation, mesh rasterization, BPE training); the
experimental brick engine (:mod:`tdwss_torch.ops.experimental`); and
the rulebook pools (:func:`tdwss_torch.ops.max_pool`,
:func:`tdwss_torch.ops.sparse_conv.avg_pool`,
:func:`tdwss_torch.ops.gather_neighbors`).
"""

__version__ = "0.1.0"

NUM_CLASSES = 20  # ScanNetV2 benchmark classes
