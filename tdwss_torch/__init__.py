"""tdwss_torch — the PyTorch/CUDA port of :mod:`tdwss` for NVIDIA Hopper.

The JAX package ``tdwss`` is the reference.  This package keeps its module
names (``tdwss_torch.ops.sparse_conv`` is the twin of
``tdwss.ops.sparse_conv``) and imports only torch, numpy and the standard
library.  Every Pallas kernel of the reference on a ported path is a CUDA
kernel written by hand for ``sm_90a`` (``tdwss_torch/csrc``), built at
first use into ``build/tdwss_torch/`` and bound with ctypes; each keeps a
plain PyTorch version beside it, which CPU tensors take.

Ported so far: multi-view-vote validation
(:func:`tdwss_torch.engine.evaluate.validate`) and the training step
(:func:`tdwss_torch.engine.steps.train_step`) of ``MultiLabel`` and
``FullySupervised`` over ``SparseConvUNet`` and the FCN-family encoders
(:mod:`tdwss_torch.models.sparse_encoders`), and the weak-supervision
loop through its entry points: :class:`tdwss_torch.engine.train.Trainer`
over the prefetching train loader, the pseudo-label stage
(:mod:`tdwss_torch.engine.pseudo`) and the command-line entry points
(``python -m tdwss_torch.cli.<name>``); and the text branch:
``MultiLabelContrastive`` with its text tower
(:mod:`tdwss_torch.models.transformer`), the ``TextContrastive`` loss and
the tokenizer (:mod:`tdwss_torch.data.tokenizer`).
"""

__version__ = "0.1.0"

NUM_CLASSES = 20  # ScanNetV2 benchmark classes
