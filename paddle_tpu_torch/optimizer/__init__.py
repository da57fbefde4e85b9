"""Optimizers — counterpart of ``paddle_tpu/optimizer`` (Adam and AdamW with
f32 master weights so far)."""
from .optimizer import Adam, AdamW, Optimizer  # noqa: F401
