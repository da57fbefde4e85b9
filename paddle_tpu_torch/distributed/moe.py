"""Mixture-of-experts helpers — counterpart of the parts of
``paddle_tpu/distributed/moe.py`` that ``models/llama_moe.MoEMLP`` uses:
the capacity rule, GShard dispatch with k-major priority and drops, the
expert activations and the grouped expert FFN with its parameters.

The JAX package builds the dispatch as a dense ``[K*S, E, C]`` one-hot and
contracts it with einsums (XLA; no Pallas kernel). The port computes the
same kept set and the same slot of each kept route by index arithmetic
(:func:`dispatch_positions`), so it never holds that one-hot (302 M f32
elements at 2048 tokens, 64 experts, top-6). :func:`one_hot_dispatch`
still returns the JAX function's dense ``(combine, dispatch)`` pair for
callers that want it. On one device the expert-parallel constraints of the
JAX package are no-ops, and the port has none.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def compute_capacity(num_tokens: int, num_experts: int, top_k: int,
                     capacity_factor: float) -> int:
    """Slots per expert: ceil(tokens * k * factor / experts), at least 1
    and at most the token count (``moe.py:68``)."""
    cap = int(math.ceil(num_tokens * top_k * capacity_factor / num_experts))
    return max(1, min(cap, num_tokens))


def dispatch_positions(topk_idx, num_experts: int, capacity: int):
    """(slot, keep), both [S, K]: the slot of each route (s, k) within its
    expert and whether it is kept. Routes are ranked k-major — every k = 0
    route takes its expert's slots before any k = 1 route, in token order
    within one k — and routes past ``capacity`` drop, as the cumsum of
    ``one_hot_dispatch`` (``moe.py:74-99``) ranks them. An index of -1 is
    no route (the JAX one-hot of -1 is all zero)."""
    S, K = topk_idx.shape
    flat = topk_idx.t().reshape(-1).long()                    # k-major [K*S]
    valid = flat >= 0
    onehot = F.one_hot(flat.clamp(min=0), num_experts) * valid[:, None]
    rank = torch.cumsum(onehot, dim=0) - 1                    # [K*S, E]
    slot = rank.gather(1, flat.clamp(min=0)[:, None])[:, 0]
    keep = valid & (slot < capacity)
    return slot.reshape(K, S).t(), keep.reshape(K, S).t()


def one_hot_dispatch(probs, topk_idx, capacity: int):
    """Dense GShard dispatch (``moe.py:74``): probs [S, E] combine weights,
    topk_idx [S, K]. Returns (combine [S, E, C] of probs' type, dispatch
    [S, E, C] bool), equal to the JAX function's."""
    S, E = probs.shape
    slot, keep = dispatch_positions(topk_idx, E, capacity)
    s_idx = torch.arange(S, device=probs.device)[:, None].expand_as(slot)
    e_idx = topk_idx.long()
    combine = torch.zeros(S, E, capacity, dtype=probs.dtype,
                          device=probs.device)
    combine[s_idx[keep], e_idx[keep], slot[keep]] = probs[s_idx[keep],
                                                          e_idx[keep]]
    return combine, combine > 0


def _act_fn(activation: str):
    if activation == "gelu":  # exact erf gelu (paddle F.gelu default)
        return lambda v: F.gelu(v, approximate="none")
    fn = getattr(F, activation, None) or getattr(torch, activation)
    return fn


def _expert_act(z, activation: str):
    """Hidden activation of the expert FFN; ``"swiglu"`` reads z as the
    fused gate‖up output [..., 2 * hidden] (``moe.py:270``)."""
    if activation == "swiglu":
        g, u = z.chunk(2, dim=-1)
        return F.silu(g) * u
    return _act_fn(activation)(z)


def _grouped_ffn(xe, w1, b1, w2, b2, activation: str):
    """[E, C, M] grouped FFN (``moe.py:281``): one batched product per
    projection over all experts."""
    h = _expert_act(torch.bmm(xe, w1) + b1, activation)
    return torch.bmm(h, w2) + b2


class GroupedMLP(nn.Module):
    """All E experts' FFN weights stacked on a leading expert dim, in
    Paddle's [in, out] layout (``moe.py:288``): w1 [E, M, 2H] (gate‖up for
    ``"swiglu"``, else [E, M, H]), b1 [E, 1, 2H], w2 [E, H, M], b2
    [E, 1, M]."""

    def __init__(self, num_experts: int, d_model: int, d_hidden: int,
                 activation: str = "gelu", device=None, dtype=None):
        super().__init__()
        self.num_experts = num_experts
        self.d_model, self.d_hidden = d_model, d_hidden
        self.activation = activation
        fan1 = d_hidden * (2 if activation == "swiglu" else 1)
        kw = dict(device=device, dtype=dtype)
        self.w1 = nn.Parameter(torch.empty(num_experts, d_model, fan1, **kw))
        self.b1 = nn.Parameter(torch.zeros(num_experts, 1, fan1, **kw))
        self.w2 = nn.Parameter(torch.empty(num_experts, d_hidden, d_model,
                                           **kw))
        self.b2 = nn.Parameter(torch.zeros(num_experts, 1, d_model, **kw))

    def forward(self, xe):
        """xe [E, C, M] -> [E, C, M]."""
        return _grouped_ffn(xe, self.w1, self.b1, self.w2, self.b2,
                            self.activation)
