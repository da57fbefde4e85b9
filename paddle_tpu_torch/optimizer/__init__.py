"""Optimizers — counterpart of ``paddle_tpu/optimizer``: the update rules
with f32 master weights (Adam and AdamW through the fused multi-tensor
update), gradient clipping and the learning-rate schedules."""
from . import lr  # noqa: F401
from .clip import (ClipGradBase, ClipGradByGlobalNorm,  # noqa: F401
                   ClipGradByNorm, ClipGradByValue)
from .lr import LRScheduler  # noqa: F401
from .optimizer import (ASGD, SGD, Adadelta, Adagrad, Adam,  # noqa: F401
                        Adamax, AdamW, Ftrl, Lamb, Lion, Momentum, NAdam,
                        Optimizer, RAdam, RMSProp, Rprop)
