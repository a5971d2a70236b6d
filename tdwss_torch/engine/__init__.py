"""Training, validation and the pseudo-label stage (twin of
:mod:`tdwss.engine`).

The reference's ``TrainState``, ``make_train_step`` and
``make_eval_step`` build jitted XLA programs; the port's steps are the
plain functions :func:`train_step` and :func:`eval_step`.
"""

from tdwss_torch.engine.steps import eval_step, train_step  # noqa: F401
from tdwss_torch.engine.train import Trainer  # noqa: F401
from tdwss_torch.engine.evaluate import validate  # noqa: F401
