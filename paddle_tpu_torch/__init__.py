"""paddle_tpu_torch — the PyTorch / CUDA port of ``paddle_tpu``.

A package of its own beside the JAX package, which stays the reference
every module here is held against. It imports ``torch`` and numpy, never
``jax`` nor anything of ``paddle_tpu``. Plain tensor code is PyTorch; every
Pallas kernel of a ported path is a hand-written CUDA kernel for Hopper
(``paddle_tpu_torch/csrc``), compiled at first use on the card.

Entry points run on the current CUDA device unless the caller asks for the
CPU (``device="cpu"``), where each kernel's plain PyTorch version runs.
"""
from __future__ import annotations

from .framework.random import (default_device, default_generator,  # noqa: F401
                               seed)
from .framework_io import load, save  # noqa: F401

__version__ = "0.1.0"
