"""Seeding and device choice for the port.

Counterpart of ``paddle_tpu/framework/random.py``: where the JAX package
splits a global ``jax.random`` key (``next_key``), the port keeps one
explicit ``torch.Generator`` per device, all seeded by :func:`seed`.
"""
from __future__ import annotations

import torch

_DEFAULT_SEED = 0
_seed = _DEFAULT_SEED
_generators: dict = {}


def seed(value: int) -> None:
    """Reseed every default generator of the port (lazily, per device)."""
    global _seed
    _seed = int(value)
    _generators.clear()


def _key(device: torch.device) -> str:
    if device.type == "cuda":
        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        return f"cuda:{idx}"
    return str(device)


def default_generator(device) -> torch.Generator:
    """The port's default generator on ``device``, seeded from :func:`seed`."""
    device = torch.device(device)
    key = _key(device)
    gen = _generators.get(key)
    if gen is None:
        gen = torch.Generator(device=key)
        gen.manual_seed(_seed)
        _generators[key] = gen
    return gen


def default_device(device=None) -> torch.device:
    """``device`` when given; else the current CUDA device. With no device
    asked for and no CUDA available this raises: the port never drops to
    the CPU on its own (pass ``device="cpu"`` to run the plain versions)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
