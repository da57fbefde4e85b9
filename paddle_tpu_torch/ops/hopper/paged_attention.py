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
1, 2, 4, 8 or 16 query heads per KV head, any page size, at most
``MAX_PAGES`` pages a row. It splits each
row's visible prefix over ``split_count`` blocks and merges their partial
softmax states in a second launch (counted as one ``paged_attention``
launch), with f32 scratch from ``torch.empty``.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .append_attention import grouped_attention_plain

_STEM = "paged_attention"
HEAD_DIM = 128
GROUPS = (1, 2, 4, 8, 16)
# blocks a split count aims at per SM: the bf16 body's one-warp blocks
# (8 fit an SM's shared memory), the f32 body's 8-warp blocks
WARPS_PER_SM, F32_BLOCKS_PER_SM = 8, 2
MAX_PAGES = 16384       # page indices of a row the f32 body holds on chip
MAX_SPLIT = 4096        # splits a combine block weighs in shared memory
_ARGTYPES = [_build.VOIDP] * 9 + [_build.INT] * 7 + [
    _build.FLOAT, _build.INT, _build.VOIDP]


def split_count(B, hk, pps, n_sm, per_sm=WARPS_PER_SM):
    """Splits per (row, KV head): enough blocks for ``per_sm`` per SM over
    the B * hk pairs, no more than a row has pages. Shapes only:
    the host never reads ``lengths`` (that would synchronise); the kernel
    cuts each row's visible prefix, not its page table, into that many
    runs of whole pages, so a short row spreads over all of its blocks."""
    return max(1, min(pps, MAX_SPLIT, -(-per_sm * n_sm // max(1, B * hk))))


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
    _build.require(page_indices.shape[1] <= MAX_PAGES,
                   f"paged_attention: the kernel takes at most {MAX_PAGES} "
                   f"pages a row, got {page_indices.shape[1]}")
    out = torch.empty_like(q)
    pps = page_indices.shape[1]
    if q.numel() == 0:
        return out
    n_split = split_count(B, hk, pps, _build.sm_count(q.device),
                          WARPS_PER_SM if code else F32_BLOCKS_PER_SM)
    # one f32 scratch buffer: acc [B, H, n_split, D], then m and l
    # [B, H, n_split]
    part = torch.empty(B * H * n_split * (D + 2), dtype=torch.float32,
                       device=q.device)
    acc = part.data_ptr()
    m = acc + B * H * n_split * D * 4
    fn = _build.function(_STEM, "pt_paged_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             lengths.data_ptr(), page_indices.data_ptr(), m,
             m + B * H * n_split * 4, acc, out.data_ptr(), B, H, hk, n_pages,
             ps, pps, n_split, 1.0 / math.sqrt(D), code,
             _build.stream(q.device))
    _build.launches["paged_attention"] += 1
    _build.check(err, _STEM, "paged_attention")
    return out
