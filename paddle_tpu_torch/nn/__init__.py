"""Layers the ported trunks need, in Paddle's parameter layout; the
attention functionals live in ``nn.functional``. ``LayerNorm`` (GPT-2) is
plain PyTorch: no TPU kernel computes it.

``Linear`` keeps Paddle's weight layout ``[in_features, out_features]``
applied as ``x @ W`` (``paddle_tpu/nn/layers_common.py``), so state dicts
move between the two packages without transposes.
"""
from __future__ import annotations

import torch
from torch import nn


class Linear(nn.Module):
    """Linear map ``x @ W (+ b)``, W [in, out]; a bias [out] (zeros) only
    with ``bias=True`` (the Qwen2 q/k/v projections), added after the
    product as the JAX package adds it."""

    def __init__(self, in_features: int, out_features: int, device=None,
                 dtype=None, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, out_features,
                                               device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if bias else None)

    def forward(self, x):
        out = torch.matmul(x, self.weight)
        return out if self.bias is None else out + self.bias


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int, device=None,
                 dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, embedding_dim,
                                               device=device, dtype=dtype))

    def forward(self, ids):
        return torch.nn.functional.embedding(ids.long(), self.weight)


class LayerNorm(nn.Module):
    """LayerNorm over the trailing ``width`` with a weight (ones) and a bias
    (zeros), as ``paddle_tpu/nn/functional/common.py:121`` computes it:
    mean and biased variance in f32, ``(x - mean) * rsqrt(var + epsilon)``
    rounded to x's dtype, then times the weight plus the bias in that
    dtype."""

    def __init__(self, width: int, epsilon: float = 1e-5, device=None,
                 dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(width, device=device,
                                              dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(width, device=device,
                                             dtype=dtype))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = ((xf - mean) * torch.rsqrt(var + self.epsilon)).to(x.dtype)
        return out * self.weight + self.bias
