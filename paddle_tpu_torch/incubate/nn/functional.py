"""paddle.incubate.nn.functional's memory-efficient attention
(``paddle_tpu/incubate/nn/functional.py:230-268``) and ``fused_moe``
(``:217-227``), which raises there and here.

Without a bias the memory-efficient algorithm is flash attention: the
port's full-mask flash kernel on CUDA where ``supported`` holds. With an
additive bias it runs the plain SDPA composite, as the JAX package does.
"""
from __future__ import annotations

import torch

from ...framework import random as _random
from ...nn.functional.attention import flash_attention


def fused_moe(x, gate_weight, expert_weights1, expert_biases1,
              expert_weights2, expert_biases2, quant_method="None",
              moe_topk=2, norm_topk_prob=True):
    """The cutlass ``fused_moe`` surface: not a functional here, as in the
    JAX package; ``distributed.moe.MoELayer`` over a ``GroupedMLP`` is the
    MoE layer."""
    raise NotImplementedError(
        "use paddle_tpu_torch.distributed.moe.MoELayer(GroupedMLP) — the "
        "grouped-GEMM MoE; a stateless functional wrapper is tracked for a "
        "later round")


def memory_efficient_attention(query, key, value, attn_bias=None, p=0.0,
                               scale=None, training=True):
    """xformers-style attention, [B, S, H, D]. ``attn_bias`` (additive,
    broadcast to [B, H, Sq, Sk]) selects the composite, whose products and
    softmax run in the inputs' dtype, as in the JAX package; dropout ``p``
    while ``training`` draws from the port's default generator."""
    if attn_bias is None:
        q = query
        if scale is not None:
            # flash applies 1 / sqrt(d) inside; fold a custom scale in
            q = query * (scale * (query.shape[-1] ** 0.5))
        out, _ = flash_attention(q, key, value, dropout=p, causal=False,
                                 training=training)
        return out
    d = query.shape[-1]
    s = scale if scale is not None else 1.0 / (d ** 0.5)
    qh, kh, vh = (x.movedim(2, 1) for x in (query, key, value))
    probs = torch.softmax((qh @ kh.transpose(-1, -2)) * s + attn_bias, -1)
    if p > 0.0 and training:
        gen = _random.default_generator(query.device)
        keep = torch.rand(probs.shape, generator=gen,
                          device=probs.device) < 1.0 - p
        probs = probs * keep / (1.0 - p)
    return (probs @ vh).movedim(1, 2)
