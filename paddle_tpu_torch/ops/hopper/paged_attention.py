"""Paged decode attention (CUDA kernel in csrc/paged_attention.cu).

Counterpart of the bundled Pallas kernel
``jax.experimental.pallas.ops.tpu.paged_attention.paged_attention`` that
``paddle_tpu/generation.py`` ``paged_decode_attention`` calls on the TPU,
with the semantics of the JAX package's reference ``_paged_attention_ref``:
q [B, H, D] (one token per row), k_pages/v_pages [hk, n_pages, page_size,
D], lengths [B] (columns t < lengths[b] are visible), page_indices
[B, pages_per_seq]; scores scaled by 1/sqrt(D).

On a CPU tensor it runs the plain version; on a CUDA tensor it launches the
kernel or raises. The kernel takes head width 128, float32 / bfloat16, and
1, 2, 4, 8 or 16 query heads per KV head.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .append_attention import grouped_attention_plain

_STEM = "paged_attention"
HEAD_DIM = 128
GROUPS = (1, 2, 4, 8, 16)


def gather_pages(pages, page_indices):
    """[hk, n_pages, ps, D] pool -> [B, hk, pages_per_seq * ps, D] rows of
    the pages ``page_indices`` [B, pages_per_seq] names."""
    hk, _n, ps, D = pages.shape
    B = page_indices.shape[0]
    g = pages[:, page_indices.long()].movedim(0, 1)   # [B, hk, pps, ps, D]
    return g.reshape(B, hk, -1, D)


def paged_attention_plain(q, k_pages, v_pages, lengths, page_indices):
    """``generation._paged_attention_ref``: gather every page of each row,
    mask columns t >= lengths[b]."""
    k = gather_pages(k_pages, page_indices).transpose(1, 2)   # [B, T, hk, D]
    v = gather_pages(v_pages, page_indices).transpose(1, 2)
    T = k.shape[1]
    t_idx = torch.arange(T, device=q.device)[None, :]
    valid = t_idx < lengths.to(q.device).long()[:, None]
    out = grouped_attention_plain(q[:, None], k, v, valid[:, None],
                                  1.0 / math.sqrt(q.shape[-1]))
    return out[:, 0]


def paged_attention(q, k_pages, v_pages, lengths, page_indices):
    """Decode attention of q [B,H,D] over each row's pages; returns
    [B,H,D] in q's dtype. On CUDA it has no backward and refuses inputs
    that need a gradient."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, lengths,
                                     page_indices)
    _build.require_no_grad("paged_attention", q, k_pages, v_pages)
    _build.require_cuda(q, k_pages, v_pages, lengths, page_indices)
    code = _build.dtype_code(q)
    B, H, D = q.shape
    hk, n_pages, ps, Dk = k_pages.shape
    _build.require(v_pages.shape == k_pages.shape and Dk == D,
                   "paged_attention: q, k_pages and v_pages disagree")
    _build.require(D == HEAD_DIM, f"paged_attention: the kernel takes "
                                  f"head_dim {HEAD_DIM}, got {D}")
    _build.require(H % hk == 0 and H // hk in GROUPS,
                   f"paged_attention: {H} heads over {hk} KV heads (groups "
                   f"of {GROUPS})")
    _build.require(k_pages.dtype == q.dtype and v_pages.dtype == q.dtype,
                   "paged_attention: q and the pages must share one dtype")
    _build.require(lengths.dtype == torch.int32 and tuple(lengths.shape) == (B,),
                   "paged_attention: lengths must be int32 [B]")
    _build.require(page_indices.dtype == torch.int32
                   and page_indices.dim() == 2 and page_indices.shape[0] == B,
                   "paged_attention: page_indices must be int32 [B, pages]")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    fn = _build.function(_STEM, "pt_paged_attention", [
        _build.VOIDP, _build.VOIDP, _build.VOIDP, _build.VOIDP, _build.VOIDP,
        _build.VOIDP, _build.INT, _build.INT, _build.INT, _build.INT,
        _build.INT, _build.INT, _build.FLOAT, _build.INT, _build.VOIDP])
    err = fn(_build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
             _build.ptr(lengths), _build.ptr(page_indices), _build.ptr(out),
             B, H, hk, n_pages, ps, page_indices.shape[1],
             1.0 / math.sqrt(D), code, _build.stream(q.device))
    _build.launches["paged_attention"] += 1
    _build.check(err, _STEM, "paged_attention")
    return out
