"""paddle.nn.functional.flash_attention as a module (Paddle's layout:
users import the functions from this path), callable like the
``flash_attention`` function, as in ``paddle_tpu/nn/functional/
flash_attention.py``. It also holds the packed forms of ``extra.py:607-642``
(``flash_attn_qkvpacked``, ``flash_attn_varlen_qkvpacked``).
"""
from __future__ import annotations

import sys
import types

import torch

from .attention import (  # noqa: F401
    _cu_seqlens, flash_attention, flash_attn_unpadded,
    scaled_dot_product_attention, sdp_kernel)

__all__ = ["flash_attention", "flash_attn_unpadded", "flash_attn_qkvpacked",
           "flash_attn_varlen_qkvpacked", "scaled_dot_product_attention",
           "sdp_kernel", "get_triangle_upper_mask",
           "calc_reduced_attention_scores"]


class _CallableModule(types.ModuleType):
    def __call__(self, *args, **kwargs):
        return flash_attention(*args, **kwargs)


sys.modules[__name__].__class__ = _CallableModule


def get_triangle_upper_mask(x, name=None):
    """A -1e4 strictly upper-triangular additive mask shaped like ``x`` (the
    [B, H, S, S] score layout)."""
    return torch.full(x.shape, -1e4, dtype=x.dtype, device=x.device).triu(1)


def calc_reduced_attention_scores(query, key, softmax_lse, name=None):
    """The sum over the query axis of softmax(q k^T / sqrt(d)), rebuilt
    from a precomputed logsumexp: query [B, Sq, H, D], key [B, Sk, H, D],
    softmax_lse [B, H, Sq] -> [B, H, 1, Sk] in query's dtype."""
    d = query.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", query.float(),
                          key.float()) / (d ** 0.5)
    probs = torch.exp(scores - softmax_lse.float()[..., None])
    return probs.sum(dim=-2, keepdim=True).to(query.dtype)


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False, return_softmax=False,
                         name=None):
    """Packed [B, S, 3, H, D] -> ``flash_attention``."""
    out, sm = flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                              dropout=dropout, causal=causal,
                              return_softmax=return_softmax)
    if return_softmax:
        return out, sm
    return out


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                                max_seqlen_k, scale=None, dropout=0.0,
                                causal=False, name=None):
    """A ragged batch [total_tokens, 3, H, D] with cumulative sequence
    lengths (``cu_seqlens_q`` cuts the segments); each segment runs through
    ``flash_attention``. As in the JAX function, ``scale`` is not applied
    (the default 1 / sqrt(d) is)."""
    cu = _cu_seqlens(cu_seqlens_q)
    outs = []
    for i in range(len(cu) - 1):
        seg = qkv[cu[i]:cu[i + 1]]
        o, _ = flash_attention(seg[None, :, 0], seg[None, :, 1],
                               seg[None, :, 2], dropout=dropout,
                               causal=causal)
        outs.append(o[0])
    return torch.cat(outs, 0)
