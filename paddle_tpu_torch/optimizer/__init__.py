"""Optimizers — counterpart of ``paddle_tpu/optimizer``: Adam and AdamW
with f32 master weights, gradient clipping and the learning-rate
schedules."""
from . import lr  # noqa: F401
from .clip import (ClipGradBase, ClipGradByGlobalNorm,  # noqa: F401
                   ClipGradByNorm, ClipGradByValue)
from .lr import LRScheduler  # noqa: F401
from .optimizer import Adam, AdamW, Optimizer  # noqa: F401
