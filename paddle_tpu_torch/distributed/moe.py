"""Mixture of experts — counterpart of ``paddle_tpu/distributed/moe.py``.

Ported: the counting primitives (``expert_count``, ``limit_by_capacity``,
``prune_gate_by_capacity``, ``load_balance_loss``), the capacity rule and
the GShard dispatch with k-major priority and drops, the gates
(``NaiveGate``, ``SwitchGate``, ``GShardGate``), ``GroupedMLP`` (the
expert batch and the ragged grouped product), ``MoELayer`` and the eager
``global_scatter`` / ``global_gather``; ``models/llama_moe.MoEMLP`` builds
on the same helpers.

The JAX package builds the dispatch as a dense ``[K*S, E, C]`` one-hot and
contracts it with einsums (XLA; no Pallas kernel). The port computes the
same kept set and the same slot of each kept route by index arithmetic
(:func:`dispatch_positions`), so it never holds that one-hot (302 M f32
elements at 2048 tokens, 64 experts, top-6): ``one_hot_dispatch`` writes
the gates' ``[S, E, C]`` pair from it directly, and ``MoEMLP`` never makes
the pair at all.

Random draws (the Switch gate's jitter, GShard's random routing) come from
an explicit ``torch.Generator``: the gate's own, or the port's default
generator of the device (``framework/random.py``). ``_route`` takes the
draw as an argument, so a test can hand it the uniforms the JAX gate drew.

Expert parallelism needs a hybrid mesh, which the port does not have: with
no group it resolves to no axes, as the JAX package does without a mesh,
and a ``moe_group`` raises.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..framework.random import default_generator

_NO_EP = ("expert parallelism (moe_group, a sharded expert dim) needs a "
          "hybrid mesh, which paddle_tpu_torch does not have yet "
          "(ROADMAP.md Queue 1 item 12)")


# ---------------------------------------------------------------------------
# capacity and counting primitives (moe.py:44-112)
# ---------------------------------------------------------------------------

def _one_hot(idx, n: int):
    """One-hot of ``idx`` over ``n`` as int64, all zero where ``idx`` is
    outside [0, n) (``jax.nn.one_hot`` of -1 is all zero)."""
    idx = idx.long()
    valid = (idx >= 0) & (idx < n)
    return F.one_hot(idx.clamp(0, n - 1), n) * valid[..., None]


def expert_count(gate_idx, n_expert: int):
    """Tokens assigned to each expert, int32 [n_expert] (``moe.py:44``)."""
    return _one_hot(gate_idx.reshape(-1), n_expert).sum(0).int()


def limit_by_capacity(expert_counts, capacity: int):
    """Per-expert counts clamped to ``capacity`` (``moe.py:52``)."""
    return torch.clamp(expert_counts, max=capacity)


def prune_gate_by_capacity(gate_idx, n_expert: int, capacity: int):
    """``gate_idx`` with each assignment past its expert's ``capacity``
    (in token order) replaced by -1 (``moe.py:57``)."""
    flat = gate_idx.reshape(-1).long()
    pos = torch.cumsum(_one_hot(flat, n_expert), dim=0) - 1
    valid = (flat >= 0) & (flat < n_expert)
    mine = pos.gather(1, flat.clamp(0, n_expert - 1)[:, None])[:, 0]
    mine = torch.where(valid, mine, -1)
    return torch.where(mine < capacity, flat, -1).to(
        gate_idx.dtype).reshape(gate_idx.shape)


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
    [S, E, C] bool), equal to the JAX function's. Each kept route's weight
    is written at its (token, expert, slot); a dropped route goes to a
    spare slot past C that is cut off, so nothing waits for the device."""
    S, E = probs.shape
    slot, keep = dispatch_positions(topk_idx, E, capacity)
    s_idx = torch.arange(S, device=probs.device)[:, None].expand_as(slot)
    e_idx = topk_idx.long().clamp(min=0)
    c_idx = torch.where(keep, slot, capacity)
    vals = torch.where(keep, probs.gather(1, e_idx), 0.0)
    combine = probs.new_zeros(S, E, capacity + 1).index_put(
        (s_idx, e_idx, c_idx), vals)[..., :capacity]
    return combine, combine > 0


def load_balance_loss(probs, topk_idx):
    """Switch / GShard auxiliary loss E * sum_e(mean prob_e * share of
    top-1 tokens_e); 1 at perfect balance (``moe.py:103``)."""
    E = probs.shape[-1]
    ce = _one_hot(topk_idx[:, 0], E).to(probs.dtype).mean(0)
    return E * torch.sum(probs.mean(0) * ce)


# ---------------------------------------------------------------------------
# gates (moe.py:115-262)
# ---------------------------------------------------------------------------

def _xavier_uniform_(p, fan_in: int, fan_out: int, generator):
    """XavierUniform (``nn/initializer_core.py:85``): U(-l, l) with
    l = sqrt(6 / (fan_in + fan_out)), drawn in f32 and cast, one slice of
    an expert stack's leading dim at a time: the whole stack's f32 draw
    would need 4 bytes an element beside it (30 GB for DeepSeek-V3's 256
    experts' w1). On the CPU the values are those of one draw."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    gen = generator or default_generator(p.device)
    with torch.no_grad():
        for part in (p if p.dim() > 2 else [p]):
            u = torch.rand(part.shape, generator=gen, device=p.device)
            part.copy_((u * 2.0 - 1.0) * limit)


class BaseGate(nn.Module):
    """Router base (``moe.py:119``): ``num_expert`` experts a rank,
    ``tot_expert`` = num_expert * world_size routed over; the last
    auxiliary loss through ``set_loss`` / ``get_loss``."""

    def __init__(self, num_expert: int, world_size: int = 1):
        super().__init__()
        self.world_size = world_size
        self.num_expert = num_expert
        self.tot_expert = num_expert * world_size
        self.loss = None

    def set_loss(self, loss):
        self.loss = loss

    def get_loss(self, clear: bool = True):
        loss = self.loss
        if clear:
            self.loss = None
        return loss

    def dispatch(self, x_flat):
        raise NotImplementedError


def _gate_logits(x, w, b):
    """(x @ w + b) in the promoted type of x and w, then f32, as the JAX
    gates compute their logits."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return (x.to(dt) @ w.to(dt) + b.to(dt)).float()


class NaiveGate(BaseGate):
    """Top-k softmax router (``moe.py:145``). ``capacity_factor`` 2.0 by
    default; None keeps every route (C = S). Gate weight XavierUniform,
    bias 0, drawn from ``generator`` (default: the port's generator of
    ``device``)."""

    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 topk: int = 2, capacity_factor: Optional[float] = 2.0,
                 device=None, dtype=None, generator=None):
        super().__init__(num_expert, world_size)
        self.d_model = d_model
        self.top_k = topk
        self.capacity_factor = capacity_factor
        self.generator = generator
        kw = dict(device=device, dtype=dtype or torch.float32)
        self.gate_weight = nn.Parameter(torch.empty(d_model, self.tot_expert,
                                                    **kw))
        self.gate_bias = nn.Parameter(torch.zeros(self.tot_expert, **kw))
        _xavier_uniform_(self.gate_weight, d_model, self.tot_expert,
                         generator)

    def _capacity(self, n_tokens: int, training: bool) -> int:
        if self.capacity_factor is None:
            return n_tokens
        return compute_capacity(n_tokens, self.tot_expert, self.top_k,
                                self.capacity_factor)

    def _route(self, x, w, b, training: bool):
        """(combine [S, E, C] of x's type, dispatch [S, E, C] of x's type,
        detached, aux loss) of tokens x [S, M] (``moe.py:167``)."""
        probs = torch.softmax(_gate_logits(x, w, b), dim=-1)
        topk_idx = probs.topk(self.top_k, dim=-1).indices
        combine, disp = one_hot_dispatch(probs, topk_idx,
                                         self._capacity(x.shape[0], training))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return combine.to(x.dtype), disp.to(x.dtype).detach(), aux

    def _draw(self, shape, device, low=0.0, high=1.0):
        """Uniforms in [low, high) from the gate's generator."""
        gen = self.generator or default_generator(device)
        return low + (high - low) * torch.rand(shape, generator=gen,
                                               device=device)

    def _route_args(self, x_flat):
        """The draw ``_route`` takes in this mode (none here)."""
        return {}

    def dispatch(self, x_flat):
        """x_flat [S, M] -> (combine [S, E, C], dispatch [S, E, C]); the
        aux loss goes to ``set_loss``."""
        combine, disp, aux = self._route(x_flat, self.gate_weight,
                                         self.gate_bias, self.training,
                                         **self._route_args(x_flat))
        self.set_loss(aux)
        return combine, disp


class SwitchGate(NaiveGate):
    """Top-1 router with capacity (train, eval) factors, the balance loss
    and, in training, the multiplicative jitter U(1 - eps, 1 + eps) on the
    logits' exponent (``moe.py:202``)."""

    def __init__(self, d_model, num_expert, world_size: int = 1,
                 topk: int = 1, switch_eps: float = 0.1,
                 capacity: Sequence[float] = (1.2, 2.4), device=None,
                 dtype=None, generator=None):
        if topk != 1:
            raise ValueError("switch gate is top-1")
        super().__init__(d_model, num_expert, world_size, topk=1,
                         device=device, dtype=dtype, generator=generator)
        self.switch_eps = switch_eps
        self.capacity = capacity

    def _capacity(self, n_tokens: int, training: bool) -> int:
        factor = self.capacity[0] if training else self.capacity[1]
        return compute_capacity(n_tokens, self.tot_expert, 1, factor)

    def _route_args(self, x_flat):
        if self.training and self.switch_eps > 0:
            return {"noise": self._draw(
                (x_flat.shape[0], self.tot_expert), x_flat.device,
                1.0 - self.switch_eps, 1.0 + self.switch_eps)}
        return {}

    def _route(self, x, w, b, training: bool, noise=None):
        """``noise`` [S, E]: the jitter's uniforms, or None for none."""
        logits = _gate_logits(x, w, b)
        if noise is not None:
            logits = logits + torch.log(noise.float())
        probs = torch.softmax(logits, dim=-1)
        topk_idx = probs.argmax(dim=-1)[:, None]
        combine, disp = one_hot_dispatch(probs, topk_idx,
                                         self._capacity(x.shape[0], training))
        aux = load_balance_loss(probs, topk_idx)
        return combine.to(x.dtype), disp.to(x.dtype).detach(), aux


class GShardGate(NaiveGate):
    """Top-2 router with capacity (train, eval) factors and the balance
    loss; with ``random_routing`` in training the second expert is kept
    with probability 2 p2, a dropped route becoming the -1 sentinel
    (``moe.py:236``)."""

    def __init__(self, d_model, num_expert, world_size: int = 1,
                 topk: int = 2, capacity: Sequence[float] = (1.2, 2.4),
                 random_routing: bool = True, device=None, dtype=None,
                 generator=None):
        if topk != 2:
            raise ValueError("gshard gate is top-2")
        super().__init__(d_model, num_expert, world_size, topk=2,
                         device=device, dtype=dtype, generator=generator)
        self.capacity = capacity
        self.random_routing = random_routing

    def _capacity(self, n_tokens: int, training: bool) -> int:
        factor = self.capacity[0] if training else self.capacity[1]
        return compute_capacity(n_tokens, self.tot_expert, 2, factor)

    def _route_args(self, x_flat):
        if self.random_routing and self.training:
            return {"r": self._draw((x_flat.shape[0],), x_flat.device)}
        return {}

    def _route(self, x, w, b, training: bool, r=None):
        """``r`` [S]: the random routing's uniforms, or None for none."""
        probs = torch.softmax(_gate_logits(x, w, b), dim=-1)
        topk_val, topk_idx = probs.topk(2, dim=-1)
        if r is not None:
            drop = r >= 2.0 * topk_val[:, 1].detach()
            topk_idx = torch.stack(
                [topk_idx[:, 0], torch.where(drop, -1, topk_idx[:, 1])], 1)
        combine, disp = one_hot_dispatch(probs, topk_idx,
                                         self._capacity(x.shape[0], training))
        aux = load_balance_loss(probs, topk_idx)
        return combine.to(x.dtype), disp.to(x.dtype).detach(), aux


# ---------------------------------------------------------------------------
# experts (moe.py:268-349)
# ---------------------------------------------------------------------------

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
    [E, 1, M]. Weights XavierUniform with each expert's fans (w1: M in, H
    out; w2: H in, M out), biases 0, drawn from ``generator`` (default:
    the port's generator of ``device``)."""

    def __init__(self, num_experts: int, d_model: int, d_hidden: int,
                 activation: str = "gelu", device=None, dtype=None,
                 generator=None):
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
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        _xavier_uniform_(self.w1, self.d_model, self.d_hidden, generator)
        _xavier_uniform_(self.w2, self.d_hidden, self.d_model, generator)
        with torch.no_grad():
            self.b1.zero_()
            self.b2.zero_()

    def forward_expert_batch(self, xe):
        """xe [E, C, M] -> [E, C, M]."""
        return _grouped_ffn(xe, self.w1, self.b1, self.w2, self.b2,
                            self.activation)

    def forward_ragged(self, x, group_sizes):
        """Grouped product over tokens sorted by expert (``moe.py:322``,
        ``jax.lax.ragged_dot`` there): x [T, M], group_sizes [E] with sum
        T; token rows of group e go through expert e, no padding to a
        common capacity. Host read: ``group_sizes`` once (the slice
        bounds; also the check that the sizes sum to T)."""
        sizes = [int(n) for n in torch.as_tensor(group_sizes).tolist()]
        T = x.shape[0]
        if sum(sizes) != T:
            raise ValueError(
                f"forward_ragged: group_sizes sums to {sum(sizes)} but x has "
                f"{T} tokens")
        if len(sizes) != self.num_experts:
            raise ValueError(f"forward_ragged: {len(sizes)} group sizes for "
                             f"{self.num_experts} experts")
        outs, off = [], 0
        for e, n in enumerate(sizes):
            if n == 0:
                continue
            rows = x[off:off + n]
            h = _expert_act(rows @ self.w1[e] + self.b1[e], self.activation)
            outs.append(h @ self.w2[e] + self.b2[e])
            off += n
        if not outs:
            return x.new_zeros(0, self.d_model)
        return torch.cat(outs, dim=0)

    def forward(self, xe):
        """xe [E, C, M] -> [E, C, M] (``forward_expert_batch``)."""
        return self.forward_expert_batch(xe)


# ---------------------------------------------------------------------------
# expert parallelism (moe.py:352-398): no hybrid mesh in the port
# ---------------------------------------------------------------------------

def default_ep_axes(num_experts: int):
    """The default expert-parallel axes: none, as the JAX package has none
    without a hybrid mesh."""
    return ()


def ep_constrain(arr, axes, expert_sharded: bool = True):
    """No axes: ``arr`` as it is (the JAX no-op without a mesh)."""
    if tuple(axes or ()):
        raise NotImplementedError(_NO_EP)
    return arr


def shard_grouped_experts(experts: GroupedMLP, axes) -> tuple:
    """No axes: nothing sharded, () (the JAX result without a mesh)."""
    if tuple(axes or ()):
        raise NotImplementedError(_NO_EP)
    return ()


# ---------------------------------------------------------------------------
# the layer (moe.py:401-506)
# ---------------------------------------------------------------------------

_GATES = {"naive": NaiveGate, "gshard": GShardGate, "switch": SwitchGate}


class MoELayer(nn.Module):
    """Mixture-of-experts layer (``moe.py:401``). ``experts``: a
    :class:`GroupedMLP` or a list / ``nn.ModuleList`` of expert modules,
    each [C, M] -> [C, M]. ``gate``: None (a top-``top_k`` NaiveGate), a
    gate object, or a dict ``{"type": "naive" | "gshard" | "switch",
    ...}`` of its keywords. A new gate takes the experts' device (its
    parameters f32, the JAX package's default type).
    ``recompute_interval > 0`` recomputes the grouped FFN in the backward
    (non-reentrant checkpoint). ``moe_group`` raises (no mesh);
    ``mp_group`` is not read, as in the JAX package."""

    def __init__(self, d_model: int, experts, gate=None, moe_group=None,
                 mp_group=None, recompute_interval: int = 0, top_k: int = 2):
        super().__init__()
        self.d_model = d_model
        if isinstance(experts, GroupedMLP):
            num_experts = experts.num_experts
        else:
            if not isinstance(experts, nn.ModuleList):
                experts = nn.ModuleList(list(experts))
            num_experts = len(experts)
        self.experts = experts
        self.num_experts = num_experts
        param = next(experts.parameters(), None)
        kw = {} if param is None else dict(device=param.device)
        if gate is None:
            gate = NaiveGate(d_model, num_experts, topk=top_k, **kw)
        elif isinstance(gate, dict):
            kind = gate.get("type", "naive")
            args = {k: v for k, v in gate.items() if k != "type"}
            args.setdefault("topk", 1 if kind == "switch" else 2)
            gate = _GATES[kind](d_model, num_experts, **{**kw, **args})
        self.gate = gate
        self.recompute_interval = recompute_interval
        self.activation_name = (experts.activation
                                if isinstance(experts, GroupedMLP) else "gelu")
        if moe_group is not None:
            raise NotImplementedError(_NO_EP)
        self._ep_axes = default_ep_axes(num_experts)

    def _expert_ffn(self, xe):
        g = self.experts
        if isinstance(g, GroupedMLP):
            if self.recompute_interval > 0:
                from torch.utils.checkpoint import checkpoint

                return checkpoint(_grouped_ffn, xe, g.w1, g.b1, g.w2, g.b2,
                                  self.activation_name, use_reentrant=False)
            return g.forward_expert_batch(xe)
        return torch.stack([expert(xe[e]) for e, expert in enumerate(g)], 0)

    def forward(self, x):
        """x [..., d_model] -> the same shape: dispatch [S,M] x [S,E,C] ->
        [E,C,M], the experts, combine [E,C,M] x [S,E,C] -> [S,M]
        (``moe.py:472-506``)."""
        orig_shape = x.shape
        x_flat = x.reshape(-1, self.d_model)
        combine, dispatch = self.gate.dispatch(x_flat)
        xe = torch.einsum("sm,sec->ecm", x_flat, dispatch.to(x_flat.dtype))
        ye = self._expert_ffn(xe)
        y = torch.einsum("ecm,sec->sm", ye, combine.to(ye.dtype))
        return y.reshape(orig_shape)


# ---------------------------------------------------------------------------
# global_scatter / global_gather (moe.py:513-565)
# ---------------------------------------------------------------------------

def _segments(local_count, world: int):
    """(n_expert, counts [world, world * n_expert], start offsets) on the
    host: the buffers' shapes depend on them."""
    lc = torch.as_tensor(local_count).to("cpu", torch.int64)
    n_expert = lc.shape[1] // world
    starts = torch.cat([torch.zeros(world, 1, dtype=torch.int64),
                        torch.cumsum(lc, dim=1)], dim=1)
    return n_expert, lc.tolist(), starts.tolist()


def global_scatter(x, local_count, global_count, group=None,
                   use_calc_stream=True):
    """The expert exchange in the global view (``moe.py:513``). x [world,
    local_batch, M]: each rank's tokens ordered by destination i =
    dst_rank * n_expert + expert; local_count / global_count [world, world
    * n_expert]. Returns [world, out_batch, M], each rank's buffer ordered
    expert-major then source rank, zero-padded to the largest receive
    count. Host read: both counts."""
    world, _, M = x.shape
    n_expert, lc, starts = _segments(local_count, world)
    gc = torch.as_tensor(global_count).to("cpu", torch.int64)
    out_batch = int(gc.sum(dim=1).max()) if gc.numel() else 0
    out = x.new_zeros(world, out_batch, M)
    for dst in range(world):
        off = 0
        for e in range(n_expert):
            for src in range(world):
                i = dst * n_expert + e
                cnt, s = lc[src][i], starts[src][i]
                out[dst, off:off + cnt] = x[src, s:s + cnt]
                off += cnt
    return out


def global_gather(x, local_count, global_count, group=None,
                  use_calc_stream=True):
    """Inverse of :func:`global_scatter` (``moe.py:543``): expert outputs
    back to their tokens' ranks in each rank's original order, zero-padded
    to the largest send count. Host read: ``local_count``."""
    world, _, M = x.shape
    n_expert, lc, starts = _segments(local_count, world)
    out_batch = max((sum(row) for row in lc), default=0)
    out = x.new_zeros(world, out_batch, M)
    for dst in range(world):
        off = 0
        for e in range(n_expert):
            for src in range(world):
                i = dst * n_expert + e
                cnt, s = lc[src][i], starts[src][i]
                out[src, s:s + cnt] = x[dst, off:off + cnt]
                off += cnt
    return out
