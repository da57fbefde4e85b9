"""Layers the ported trunks need, in Paddle's parameter layout; the
attention functionals live in ``nn.functional``.

``Linear`` keeps Paddle's weight layout ``[in_features, out_features]``
applied as ``x @ W`` (``paddle_tpu/nn/layers_common.py``), so state dicts
move between the two packages without transposes.
"""
from __future__ import annotations

import torch
from torch import nn


class Linear(nn.Module):
    """Bias-free linear map (the Llama projections)."""

    def __init__(self, in_features: int, out_features: int, device=None,
                 dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, out_features,
                                               device=device, dtype=dtype))

    def forward(self, x):
        return torch.matmul(x, self.weight)


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int, device=None,
                 dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, embedding_dim,
                                               device=device, dtype=dtype))

    def forward(self, ids):
        return torch.nn.functional.embedding(ids.long(), self.weight)
