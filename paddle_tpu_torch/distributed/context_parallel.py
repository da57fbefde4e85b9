"""Context parallelism for long sequences: ring attention and Ulysses
all-to-all, with the ring's ranks in one process.

Counterpart of ``paddle_tpu/distributed/context_parallel.py``. The JAX
package runs these as SPMD code inside ``shard_map``, one program over the
devices of a mesh axis; its tests run it on virtual CPU devices. Here the
n ranks of the ring run in one process, on one device (``LocalRing``):

- each tensor carries the ranks' sequence shards on a leading rank axis,
  [n, B, S_local, H, D];
- ``ppermute`` to the next rank is ``torch.roll`` along that axis,
  ``axis_index`` is the rank of each entry, ``psum(1)`` the ring's size,
  and ``all_to_all`` a transpose of the rank axis with the head or
  sequence axis;
- at hop t every rank has the same mask kind and offset (the JAX code
  relies on this too), so one hop launches the kernel once for all live
  ranks, folded into the batch; the per-rank liveness ``lax.cond(idx >=
  t)`` selects ranks t..n-1.

The hop loops read the ring only through ``LocalRing``'s ``size``,
``ranks``, ``ppermute`` and ``all_to_all``. A ring over ``torch.distributed``
(one rank per process, a rank axis of length 1, ``ranks`` = [rank]) would
give the same four and leave the loops as they are. No such ring exists
yet: a ring across several cards is neither run nor verified here.

- ``ring_attention``: k / v blocks rotate around the ring while each rank
  combines per-hop partial results by streaming softmax. With
  ``impl="splash"`` (or ``"auto"`` on CUDA where ``supported`` holds) each
  hop runs the flash kernel (``ops.hopper.flash_attention.hop_bshd``,
  counted as ``splash_hop``), and the backward recomputes through the
  einsum ring by autograd, as ``_ring_splash_vjp_bwd`` does; ``"einsum"``
  is the plain differentiable ring.
- ``ulysses_attention``: an all-to-all from sequence to heads, plain
  whole-sequence attention per head subset, and back.
- ``mla_ring_attention``: the causal ring for DeepSeek's MLA, rotating the
  compressed latent and expanding each hop's K / V locally.
- ``sep_attention``: global-shape in, global-shape out, at a degree.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.hopper import flash_attention as _flash


class LocalRing:
    """The ``n`` ranks of a ring in one process, on one device: a tensor of
    the ring carries them on its leading axis, rank i at index i."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"a ring needs at least one rank, got {n}")
        self.size = int(n)
        self.ranks = range(self.size)   # the rank of each leading entry

    def ppermute(self, x):
        """Rank i's block goes to rank i + 1 (mod n)."""
        return torch.roll(x, 1, 0)

    def all_to_all(self, x, split_axis: int, concat_axis: int):
        """``lax.all_to_all(tiled=True)`` over the ring; the axes are those
        of one rank's tensor (the rank axis not counted). Rank i cuts its
        ``split_axis`` into n chunks and sends chunk j to rank j, which
        concatenates what it receives along ``concat_axis`` in rank
        order."""
        n = self.size
        s, c = split_axis + 1, concat_axis + 1
        shape = list(x.shape)
        y = x.reshape(shape[:s] + [n, shape[s] // n] + shape[s + 1:])
        y = y.movedim(s, 0).movedim(1, c)      # [j, ..., i, concat, ...]
        out = list(y.shape)
        return y.reshape(out[:c] + [out[c] * out[c + 1]] + out[c + 2:])


def _expand_gqa(k, v, num_q_heads):
    """Repeat kv heads up to ``num_q_heads`` (q head j reads kv head
    j // (H / H_kv)); axis 2 of a [B, S, H_kv, D] tensor."""
    rep = num_q_heads // k.shape[2]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    return k, v


def _live_hops(n: int, s_k: int, causal: bool, window: Optional[int]) -> int:
    """Number of ring hops that can touch any live (q, kv) pair on any rank.
    Hop t processes kv block (i - t) mod n; under causal + sliding window w
    the band 0 <= q_glob - k_glob <= w - 1 reaches back at most
    w - 1 + s_k - 1 positions, so later hops are dead on every rank."""
    if causal and window is not None:
        return min(n, (window + s_k - 2) // s_k + 1)
    return n


def _live_entries(ring, t, causal):
    """[lo, hi) of the leading entries whose rank sees the block it holds at
    hop t. Rank i holds block (i - t) mod n; under a causal mask that block
    is in its past iff i >= t (the JAX code's ``lax.cond(idx >= t)``; the
    hops past ``_live_hops`` are dropped before), otherwise every rank sees
    its block. The ranks are in order, so the live ones form a range."""
    ranks = list(ring.ranks)
    return sum(1 for i in ranks if causal and i < t), len(ranks)


def _block_step(q, k, v, m, l, o, mask, scale):
    """One blockwise flash-attention accumulation step, GQA-grouped, for
    the live ranks at once. q [r, B, Hkv, G, Sq, D]; k / v [r, B, Hkv, Sk,
    D] this hop's block; carry m (running max), l (running denominator)
    [r, B, Hkv, G, Sq] and o (unnormalised accumulator) [..., Dv]; mask
    [r, Sq, Sk] bool (True = attend). A row still fully masked keeps
    m = -inf; its rescale factor and probabilities are 0 (the JAX code's
    ``dead`` guard, written so that its gradient has no NaN)."""
    s = torch.einsum("rbhgqd,rbhkd->rbhgqk", q.float(), k.float()) * scale
    s = s.masked_fill(~mask[:, None, None, None], float("-inf"))
    m_new = torch.maximum(m, s.amax(dim=-1))
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    alpha = torch.exp(m - m_safe)
    p = torch.exp(s - m_safe[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.einsum("rbhgqk,rbhkd->rbhgqd", p,
                                                v.float())
    return m_new, l_new, o_new


def _ring_stream(qt, kv0, make_kv, s_k: int, ring, causal: bool,
                 scale: float, window: Optional[int], dv: int):
    """Shared streaming-softmax ring driver. qt [n, B, Hkv, G, Sq, Dk]
    grouped (unscaled) queries; ``kv0`` a tuple of tensors with the rank
    axis first that rotates around the ring; per hop ``make_kv(kv) -> (kc
    [r, B, Hkv, Sk, Dk], vc [r, B, Hkv, Sk, Dv])`` gives the hop's keys and
    values (identity for a plain ring, the latent expansion for MLA) for
    the live ranks' blocks. f32 (m, l, o) carry; returns the normalised
    output [n, B, Hkv, G, Sq, Dv] (f32). Differentiable by autograd."""
    n = ring.size
    s_q = qt.shape[-2]
    dev = qt.device
    o = qt.new_zeros(qt.shape[:-1] + (dv,), dtype=torch.float32)
    l = o.new_zeros(o.shape[:-1])
    m = torch.full_like(l, float("-inf"))
    rank = torch.tensor(list(ring.ranks), device=dev)
    q_pos = rank[:, None] * s_q + torch.arange(s_q, device=dev)   # [n, Sq]
    kv = kv0
    for t in range(_live_hops(n, s_k, causal, window)):
        lo, hi = _live_entries(ring, t, causal)
        if hi > lo:
            k_pos = (((rank[lo:hi] - t) % n)[:, None] * s_k
                     + torch.arange(s_k, device=dev))
            diff = q_pos[lo:hi, :, None] - k_pos[:, None, :]
            if causal:
                mask = diff >= 0
                if window is not None:
                    mask = mask & (diff < window)
            else:
                mask = torch.ones_like(diff, dtype=torch.bool)
            kc, vc = make_kv(tuple(x[lo:hi] for x in kv))
            step = _block_step(qt[lo:hi], kc, vc, m[lo:hi], l[lo:hi],
                               o[lo:hi], mask, scale)
            m, l, o = (torch.cat([old[:lo], new, old[hi:]])
                       for old, new in zip((m, l, o), step))
        kv = tuple(ring.ppermute(x) for x in kv)
    return o / torch.where(l == 0.0, 1.0, l)[..., None]


def _ring_einsum(q, k, v, ring, causal: bool, scale: float,
                 window: Optional[int]):
    """Streaming-softmax ring over einsum blocks (the differentiable plain
    path). q [n, B, S, H, D], k / v [n, B, S, Hkv, D]; kv heads stay
    unexpanded, so each ppermute moves only kv-head bytes."""
    n, b, s_q, h, d = q.shape
    h_kv = k.shape[3]
    # q: [n, B, Hkv, G, S, D] grouped by kv head; k / v: [n, B, Hkv, S, D]
    qt = q.permute(0, 1, 3, 2, 4).reshape(n, b, h_kv, h // h_kv, s_q, d)
    kv0 = (k.transpose(2, 3), v.transpose(2, 3))
    out = _ring_stream(qt, kv0, lambda kv: kv, k.shape[2], ring, causal,
                       scale, window, v.shape[-1])
    out = out.reshape(n, b, h, s_q, -1)
    return out.transpose(2, 3).to(q.dtype)


def _hop_kind(t, s_k, causal, window):
    """(kind, offset) of hop t: the sliding band at offset t * s_k, the
    causal diagonal at hop 0, else a full block (a plain-causal past block,
    or non-causal)."""
    if causal and window is not None:
        return "local", t * s_k
    if causal and t == 0:
        return "causal", 0
    return "full", 0


def _ring_splash_fwd_impl(q, k, v, ring, causal: bool, scale: float,
                          window: Optional[int]):
    """Ring forward where each hop runs the flash hop (``hop_bshd``): the
    kernel on CUDA, launched once per hop for all live ranks folded into
    the batch; its plain version on the CPU. Hops combine by streaming
    softmax over the per-hop (out, lse) with an f32 carry, in the kernel's
    [B, S, H, D] layout. A rank's first hop never has a dead row (the
    causal diagonal, the band at offset 0, or a full block), but the
    combine guards m = -inf all the same."""
    n, b, s_q, h, d = q.shape
    s_k = k.shape[2]
    m = q.new_full((n, b, s_q, h), float("-inf"), dtype=torch.float32)
    ssum = torch.zeros_like(m)
    acc = q.new_zeros(q.shape[:-1] + (v.shape[-1],), dtype=torch.float32)
    kc, vc = k, v
    t_live = _live_hops(n, s_k, causal, window)
    for t in range(t_live):
        kind, offset = _hop_kind(t, s_k, causal, window)
        lo, hi = _live_entries(ring, t, causal)
        if hi > lo:
            r = hi - lo
            o_t, lse = _flash.hop_bshd(
                q[lo:hi].reshape(r * b, s_q, h, d),
                kc[lo:hi].reshape(r * b, s_k, *kc.shape[3:]),
                vc[lo:hi].reshape(r * b, s_k, *vc.shape[3:]),
                kind, offset=offset, window=window, scale=scale)
            lse = lse.reshape(r, b, h, s_q).transpose(2, 3)   # [r, B, S, H]
            m_old = m[lo:hi]
            m_new = torch.maximum(m_old, lse)
            m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
            alpha = torch.exp(m_old - m_safe)
            w = torch.exp(lse - m_safe)
            ssum[lo:hi] = ssum[lo:hi] * alpha + w
            acc[lo:hi] = (acc[lo:hi] * alpha[..., None] + w[..., None]
                          * o_t.reshape(acc[lo:hi].shape).float())
            m[lo:hi] = m_new
        if t + 1 < t_live:
            kc, vc = ring.ppermute(kc), ring.ppermute(vc)
    out = acc / torch.where(ssum == 0.0, 1.0, ssum)[..., None]
    return out.to(q.dtype)


class _RingSplash(torch.autograd.Function):
    """The flash-hop ring forward; its backward recomputes through the
    einsum ring by autograd (the same function), as the JAX custom VJP
    does: splash's residual output has no VJP."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal, scale, window):
        ctx.save_for_backward(q, k, v)
        ctx.args = (ring, causal, scale, window)
        return _ring_splash_fwd_impl(q, k, v, ring, causal, scale, window)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = _ring_einsum(*leaves, *ctx.args)
        grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None, None, None)


def ring_attention(q, k, v, ring, causal: bool = False,
                   sm_scale: Optional[float] = None,
                   window: Optional[int] = None, impl: str = "auto",
                   interpret: bool = False):
    """Ring attention over the ranks of ``ring`` (a ``LocalRing``).

    q [n, B, S_local, H, D], k / v [n, B, S_local, Hkv, D]: rank i's
    sequence shard at index i (the global sequence is the concatenation in
    rank order). Returns [n, B, S_local, H, D] in q's dtype. Causal masking
    uses global positions: rank i attends to blocks j < i fully, j == i
    triangularly, and j > i not at all (those hops skip the rank).

    ``window`` (requires ``causal=True``): sliding-window attention; hops
    whose kv block lies wholly outside the band are skipped.

    ``impl``: "splash" runs the flash hop per hop (the kernel on CUDA; on
    the CPU with ``interpret=True`` its plain version, standing for Pallas
    interpret mode) with an einsum-recompute backward; "einsum" is the
    plain streaming ring; "auto" picks "splash" where ``supported`` holds
    for the local shards (on CUDA, or with ``interpret``), else "einsum".
    """
    if window is not None:
        if not causal:
            raise ValueError("sliding window requires causal attention")
        if window <= 0:
            raise ValueError(f"sliding window must be positive, got {window}")
    if impl not in ("auto", "splash", "einsum"):
        raise ValueError(f"ring_attention impl must be auto|splash|einsum, "
                         f"got {impl!r}")
    if q.dim() != 5 or q.shape[0] != ring.size:
        raise ValueError(f"ring_attention takes [n, B, S_local, H, D] with n "
                         f"= {ring.size} ranks, got q {tuple(q.shape)}")
    scale = sm_scale if sm_scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if impl != "einsum":
        ok = _flash.supported(q[0], k[0], v[0], interpret=interpret)
        if impl == "splash" and not ok:
            raise ValueError(
                "ring_attention impl='splash' needs CUDA (or interpret=True) "
                "and splash-tileable shapes: seq and head_dim multiples of "
                f"128, q heads an even multiple of kv heads; got q "
                f"{tuple(q.shape)} k {tuple(k.shape)}")
        if ok:
            return _RingSplash.apply(q, k, v, ring, causal, scale, window)
    return _ring_einsum(q, k, v, ring, causal, scale, window)


def mla_ring_attention(q, c_kv, k_pe, w_kv_b, ring, *, nope_dim: int,
                       v_dim: int, sm_scale: Optional[float] = None):
    """Causal ring attention for Multi-head Latent Attention (DeepSeek).

    The ring rotates the compressed latent instead of expanded K / V, and
    each rank re-expands its hop's K / V from it (``kv = c_kv · w_kv_b``).
    q [n, B, S_local, H, dn + dr] with RoPE already applied to its dr tail
    at global positions; c_kv [n, B, S_local, r] (kv_a_layernormed); k_pe
    [n, B, S_local, dr] roped at global positions; w_kv_b [r, H * (dn +
    dv)]. Returns [n, B, S_local, H, dv] in q's dtype. Always causal. Plain
    PyTorch: the JAX function reaches no kernel either."""
    n, b, s_q, h, dqk = q.shape
    s_k = c_kv.shape[2]
    dn, dv, dr = nope_dim, v_dim, dqk - nope_dim
    r = c_kv.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / (dqk ** 0.5)
    w3 = w_kv_b.reshape(r, h, dn + dv)

    def make_kv(kv):
        ckv_c, kpe_c = kv
        kvx = torch.einsum("nbsr,rhd->nbhsd", ckv_c.to(w3.dtype), w3)
        kpe = kpe_c[:, :, None].to(kvx.dtype).expand(-1, -1, h, -1, -1)
        return torch.cat([kvx[..., :dn], kpe], dim=-1), kvx[..., dn:]

    qt = q.permute(0, 1, 3, 2, 4).reshape(n, b, h, 1, s_q, dqk)
    out = _ring_stream(qt, (c_kv, k_pe), make_kv, s_k, ring, True, scale,
                       None, dv)
    out = out.reshape(n, b, h, s_q, dv)
    return out.transpose(2, 3).to(q.dtype)


def _sdpa_core(q, k, v, causal, scale, window=None):
    """Plain blockless attention on [B, S, H, D], f32 softmax. Used by
    Ulysses."""
    from ..nn.functional.attention import _sdpa_ref

    k, v = _expand_gqa(k, v, q.shape[2])
    mask = None
    if window is not None:
        # sliding band on global positions (Ulysses holds the whole
        # sequence per head subset after the all-to-all)
        s_q, s_k = q.shape[1], k.shape[1]
        rows = torch.arange(s_q, device=q.device)[:, None] + (s_k - s_q)
        cols = torch.arange(s_k, device=q.device)[None, :]
        mask = (rows - cols) < window      # upper bound; causal gives >= 0
    return _sdpa_ref(q, k, v, mask=mask, causal=causal, scale=scale)


def ulysses_attention(q, k, v, ring, causal: bool = False,
                      sm_scale: Optional[float] = None,
                      window: Optional[int] = None):
    """DeepSpeed-Ulysses attention over the ranks of ``ring``.

    q / k / v [n, B, S_local, H, D] as in ``ring_attention``. An
    all-to-all re-shards from sequence to heads ([B, S, H / n, D] per
    rank), whole-sequence attention runs per head subset, and a second
    all-to-all restores sequence sharding. Requires H % n == 0; kv heads
    are repeated until they split evenly."""
    n = ring.size
    h, h_kv = q.shape[3], k.shape[3]
    if h % n:
        raise ValueError(
            f"ulysses needs num_heads divisible by sep degree: {h} vs {n}")
    if h_kv % n:
        rep = n // math.gcd(h_kv, n)
        k = torch.repeat_interleave(k, rep, dim=3)
        v = torch.repeat_interleave(v, rep, dim=3)
    scale = sm_scale if sm_scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if window is not None and not causal:
        raise ValueError("sliding window requires causal attention")

    def seq_to_heads(x):
        return ring.all_to_all(x, split_axis=2, concat_axis=1)

    qg, kg, vg = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    out = _sdpa_core(qg.flatten(0, 1), kg.flatten(0, 1), vg.flatten(0, 1),
                     causal, scale, window=window)
    out = out.reshape(qg.shape[:-1] + (out.shape[-1],))
    return ring.all_to_all(out, split_axis=1, concat_axis=2)


def shard(x, n: int):
    """Global [B, S, ...] -> [n, B, S / n, ...]: rank i takes the i-th
    contiguous sequence block."""
    b, s = x.shape[:2]
    if s % n:
        raise ValueError(f"sequence {s} does not split over {n} ranks")
    return x.reshape(b, n, s // n, *x.shape[2:]).transpose(0, 1).contiguous()


def unshard(x):
    """[n, B, S_local, ...] -> global [B, n * S_local, ...]."""
    n, b, s = x.shape[:3]
    return x.transpose(0, 1).reshape(b, n * s, *x.shape[3:])


def sep_attention(query, key, value, degree: int, causal: bool = False,
                  sm_scale: Optional[float] = None, mode: str = "ring",
                  window: Optional[int] = None):
    """Context-parallel attention at ``degree`` ranks on one device.

    query / key / value: global [B, S, H, D]; the call shards the sequence
    over a ``LocalRing(degree)``, runs ``ring_attention`` (``impl="auto"``)
    or ``ulysses_attention`` and returns the global-shape result. The JAX
    function takes the hybrid topology's ``sep`` group instead; the port
    has no fleet topology yet, so the degree is given."""
    if mode not in ("ring", "ulysses"):
        raise ValueError(f"sep_attention mode must be 'ring' or 'ulysses', "
                         f"got {mode!r}")
    ring = LocalRing(degree)
    inner = ring_attention if mode == "ring" else ulysses_attention
    out = inner(shard(query, degree), shard(key, degree),
                shard(value, degree), ring, causal=causal, sm_scale=sm_scale,
                window=window)
    return unshard(out)
