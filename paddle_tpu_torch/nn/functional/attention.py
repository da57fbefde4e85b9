"""Attention functionals: SDPA and flash attention, [batch, seqlen,
num_heads, head_dim] layout.

Counterpart of ``paddle_tpu/nn/functional/attention.py`` (Paddle's
``flash_attention.py:195`` and ``scaled_dot_product_attention``). The
fused path is the port's flash kernel (``ops/hopper/flash_attention.py``),
taken where its gate ``supported`` holds, as the JAX package takes splash;
elsewhere the plain SDPA composite ``_sdpa_ref`` runs, exactly where the
JAX package runs its XLA fallback (dropout, widths or sequences that are
not multiples of 128, uneven GQA, and CPU tensors). The functions take and
return ``torch.Tensor``s. Dropout draws from an explicit ``torch.Generator``
(the port's default generator of the tensor's device unless one is given),
so its bits are not the JAX package's.
"""
from __future__ import annotations

import contextlib

import torch

from ...framework import random as _random
from ...ops.hopper import flash_attention as _flash


def _sdpa_ref(q, k, v, mask=None, dropout=0.0, causal=False, scale=None,
              generator=None, softcap=None):
    """Plain SDPA on [B, S, H, D], f32 scores and softmax. ``mask``: bool
    (True = attend) or additive, broadcast to [B, H, Sq, Sk]; ``causal``
    bottom-aligned (tril at s_k - s_q); ``softcap``: scores become
    softcap * tanh(scores / softcap) before masking; dropout with
    ``generator`` (none: no dropout)."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / (d ** 0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * s
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        cm = torch.ones(sq, sk, dtype=torch.bool,
                        device=q.device).tril(sk - sq)
        scores = scores.masked_fill(~cm, float("-inf"))
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = scores.masked_fill(~mask, float("-inf"))
        else:
            scores = scores + mask.to(scores.dtype)
    probs = torch.softmax(scores, dim=-1)
    if dropout > 0.0 and generator is not None:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < 1.0 - dropout
        probs = torch.where(keep, probs / (1.0 - dropout), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def _dropout_generator(x, p, training):
    return _random.default_generator(x.device) if p > 0.0 and training \
        else None


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """paddle.nn.functional.scaled_dot_product_attention parity, [batch,
    seq, heads, head_dim]: always the plain composite, as in the JAX
    package."""
    return _sdpa_ref(query, key, value, mask=attn_mask,
                     dropout=dropout_p if training else 0.0,
                     causal=is_causal,
                     generator=_dropout_generator(query, dropout_p, training))


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None):
    """paddle.nn.functional.flash_attention.flash_attention parity.

    The flash kernel where ``supported`` holds (on CUDA: the causal or
    full-mask kernels, with their backward under autograd); otherwise the
    plain composite, with GQA's KV heads expanded. Returns ``(out, None)``
    whatever ``return_softmax`` asks, as the JAX function does."""
    q, k, v = query, key, value
    if _flash.supported(q, k, v, dropout):
        return _flash.flash_attention_bshd(q, k, v, causal=causal), None
    if k.shape[2] != q.shape[2]:
        from ...distributed.context_parallel import _expand_gqa

        k, v = _expand_gqa(k, v, q.shape[2])
    out = _sdpa_ref(q, k, v, dropout=dropout if training else 0.0,
                    causal=causal,
                    generator=_dropout_generator(q, dropout, training))
    return out, None


def _cu_seqlens(cu):
    if isinstance(cu, torch.Tensor):
        return [int(x) for x in cu.tolist()]
    return [int(x) for x in cu]


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale=None, dropout=0.0,
                        causal=False, return_softmax=False, name=None):
    """paddle.nn.functional.flash_attention.flash_attn_unpadded parity: a
    ragged batch of [total_tokens, H, D] with cumulative sequence lengths
    (read on the host). Each segment runs through ``flash_attention``: the
    kernel for a segment that ``supported`` takes, the plain composite for
    another. A custom ``scale`` is folded into q over flash's
    1 / sqrt(d)."""
    cq, ck = _cu_seqlens(cu_seqlens_q), _cu_seqlens(cu_seqlens_k)
    q, k, v = query, key, value
    if scale is not None:
        q = q * (scale * (q.shape[-1] ** 0.5))
    outs = []
    for i in range(len(cq) - 1):
        o, _ = flash_attention(q[cq[i]:cq[i + 1]][None],
                               k[ck[i]:ck[i + 1]][None],
                               v[ck[i]:ck[i + 1]][None],
                               dropout=dropout, causal=causal)
        outs.append(o[0])
    out = torch.cat(outs, 0)
    if return_softmax:
        return out, None
    return out


def sdp_kernel(*args, **kwargs):
    """A context that changes nothing (the JAX package's stub of torch's
    kernel-choice context)."""
    return contextlib.nullcontext()
