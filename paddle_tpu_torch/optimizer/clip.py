"""Gradient clipping — counterpart of ``paddle_tpu/optimizer/clip.py``
(``ClipGradByValue``, ``ClipGradByNorm``, ``ClipGradByGlobalNorm``).

``functional_clip`` takes ``{name: gradient}`` and returns new gradients in
their own dtype, as the JAX function returns new arrays: norms are taken
in f32, each gradient is scaled in f32 and rounded back once. The global
norm adds ``1e-6`` before the division (``clip.py:66``). An optimizer
given ``grad_clip=`` clips before its update.
"""
from __future__ import annotations

import torch


class ClipGradBase:
    def functional_clip(self, grads: dict) -> dict:
        raise NotImplementedError

    def __call__(self, params_grads):
        """The eager list-of-(param, grad) API; a None gradient stays
        None."""
        grads = {i: g for i, (_, g) in enumerate(params_grads)
                 if g is not None}
        clipped = self.functional_clip(grads)
        return [(p, clipped.get(i)) for i, (p, _) in enumerate(params_grads)]


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max

    def functional_clip(self, grads):
        return {k: torch.clamp(g, self.min, self.max)
                for k, g in grads.items()}


def _sq_norm(g):
    return torch.sum(torch.square(g.float()))


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def functional_clip(self, grads):
        out = {}
        for k, g in grads.items():
            n = torch.sqrt(_sq_norm(g))
            scale = torch.where(n > self.clip_norm, self.clip_norm / n, 1.0)
            out[k] = (g.float() * scale).to(g.dtype)
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = clip_norm

    def functional_clip(self, grads):
        if not grads:
            return {}
        total = torch.sqrt(sum(_sq_norm(g) for g in grads.values()))
        scale = torch.clamp(self.clip_norm / (total + 1e-6), max=1.0)
        return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}
