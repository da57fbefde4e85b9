"""Fused (chunked) lm-head + softmax cross-entropy.

Counterpart of ``paddle_tpu/ops/fused_loss.py``: the token-mean causal-LM
loss of ``softmax(hidden @ W)`` computed over chunks of tokens, so the
[tokens, vocab] logits never exist in memory at once (one chunk's f32
logits at a time: [1024, 128256] f32 is 525 MB, the whole [4096, 128256]
would be 2.1 GB). Token counts that do not divide the chunk are padded up
with ignored (-1) labels. The backward recomputes each chunk's logits (one
extra lm-head product) and accumulates dW in the weight dtype, as the JAX
VJP does.

This is XLA in the JAX package, not Pallas: the products go to
``torch.matmul``. Numerics match ``models.llama.causal_lm_loss``: token-mean
CE in f32, labels < 0 ignored.
"""
from __future__ import annotations

import torch


def _prep(hidden, labels, chunk_size):
    """Flatten to [N, hidden] / [N], pad N up to a chunk multiple with
    ignored labels; return (h2d, lab, chunk, n_real, count)."""
    h2d = hidden.reshape(-1, hidden.shape[-1])
    lab = labels.reshape(-1).long()
    n = h2d.shape[0]
    count = torch.clamp((lab >= 0).sum().float(), min=1.0)
    chunk = min(chunk_size, n)
    pad = (-n) % chunk
    if pad:
        h2d = torch.cat([h2d, h2d.new_zeros(pad, h2d.shape[1])])
        lab = torch.cat([lab, lab.new_full((pad,), -1)])
    return h2d, lab, chunk, n, count


def _logits_chunk(h_c, weight, layout):
    # the matmul in the hidden dtype; the caller upcasts, chunk-local only
    return h_c @ weight if layout == "hv" else h_c @ weight.t()


class _FusedLinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, weight, labels, layout, chunk_size):
        h2d, lab, chunk, _, count = _prep(hidden, labels, chunk_size)
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(0, h2d.shape[0], chunk):
            lg32 = _logits_chunk(h2d[i:i + chunk], weight, layout).float()
            lab_c = lab[i:i + chunk]
            mask = lab_c >= 0
            safe = torch.where(mask, lab_c, 0)
            lse = torch.logsumexp(lg32, dim=-1)
            picked = lg32.gather(1, safe[:, None])[:, 0]
            total = total + torch.where(mask, lse - picked, 0.0).sum()
        ctx.save_for_backward(hidden, weight, labels)
        ctx.layout, ctx.chunk_size = layout, chunk_size
        return total / count

    @staticmethod
    def backward(ctx, g):
        hidden, weight, labels = ctx.saved_tensors
        layout = ctx.layout
        h2d, lab, chunk, n_real, count = _prep(hidden, labels, ctx.chunk_size)
        scale = (g / count).float()
        dw = torch.zeros_like(weight)
        dh = torch.empty_like(h2d)
        rows = torch.arange(chunk, device=hidden.device)
        for i in range(0, h2d.shape[0], chunk):
            h_c, lab_c = h2d[i:i + chunk], lab[i:i + chunk]
            mask = lab_c >= 0
            safe = torch.where(mask, lab_c, 0)
            # (softmax - onehot) * mask * g / count, in place on the one
            # [chunk, vocab] f32 buffer
            dlg = torch.softmax(_logits_chunk(h_c, weight, layout).float(),
                                dim=-1)
            dlg[rows, safe] -= 1.0
            dlg *= (mask.float() * scale)[:, None]
            dlg = dlg.to(h_c.dtype)
            if layout == "hv":
                dh[i:i + chunk] = dlg @ weight.t()
                dw += h_c.t() @ dlg
            else:
                dh[i:i + chunk] = dlg @ weight
                dw += dlg.t() @ h_c
        dh = dh[:n_real].reshape(hidden.shape)
        return dh, dw, None, None, None


def fused_linear_cross_entropy(hidden, weight, labels, weight_layout="hv",
                               chunk_size=1024):
    """Token-mean causal-LM loss of ``softmax(hidden @ W)`` without the full
    logits tensor. hidden [..., hidden_size]; labels [...] int, < 0
    ignored; weight [hidden, vocab] ("hv") or [vocab, hidden] ("vh", the
    tied embedding, contracted in place). Returns a 0-d f32 tensor."""
    if weight_layout not in ("hv", "vh"):
        raise ValueError(f"weight_layout must be 'hv' or 'vh', got "
                         f"{weight_layout!r}")
    return _FusedLinearCE.apply(hidden, weight, labels, weight_layout,
                                chunk_size)
