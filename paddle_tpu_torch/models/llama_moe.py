"""MoE causal LM (the DeepSeekMoE / Qwen2-MoE decoder family) — counterpart
of ``paddle_tpu/models/llama_moe.py``.

A Llama-style decoder whose layers past ``first_k_dense_replace`` swap the
dense gated MLP for ``MoEMLP``: ``n_routed_experts`` routed experts (top-k
of a softmax or sigmoid router, capacity-limited GShard dispatch) in one
grouped FFN, plus ``n_shared_experts`` always-on shared experts. The JAX
package runs the routing and dispatch as XLA einsums, no Pallas kernel;
here they are PyTorch (index arithmetic and batched products, see
``distributed/moe.py``), on every device.

Ported: ``LlamaMoEConfig`` with ``tiny_moe``, ``MoEMLP`` with every router
knob (softmax or sigmoid scores, the aux-free correction bias, group-limited
top-k, ``norm_topk_prob``, ``routed_scaling_factor``, shared experts and
Qwen2's shared gate; the router's Switch aux value is kept on the module,
in the graph), ``LlamaMoEDecoderLayer``, ``LlamaMoEModel`` and
``LlamaMoEForCausalLM`` with its training loss (labels: the LM loss plus
``router_aux_loss_coef`` times the mean aux value over the MoE layers that
ran). Autograd differentiates the index dispatch to the gradients of the
JAX function's dense one-hot einsums: a kept route's token gets its
expert's gradient, ``gate_weight`` learns through the kept routes'
weights and the aux value, and a dropped route or one of weight 0 gets
nothing. HuggingFace checkpoints of the grouped families load through
``load_hf_grouped_moe`` (``llama_moe.py:73``): each expert's gate / up /
down written into its slice of the grouped ``[E, ...]`` weights in place
(``pack_hf_experts``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn as tnn

from ..distributed.moe import (GroupedMLP, compute_capacity,
                               dispatch_positions)
from ..ops.hopper import fused_norm
from .llama import (LlamaAttention, LlamaConfig, LlamaForCausalLM, LlamaMLP,
                    LlamaModel, LlamaRMSNorm, _check_checkpoint, _write_plan,
                    hf_tensor, layer_window, torch_dtype)


@dataclasses.dataclass
class LlamaMoEConfig(LlamaConfig):
    """DeepSeekMoE / Qwen2-MoE knobs on top of the Llama base."""

    n_routed_experts: int = 8
    n_shared_experts: int = 1
    shared_expert_gate: bool = False       # Qwen2-MoE sigmoid shared gate
    # aux-free balancing (ERNIE / DeepSeek-V3): a per-expert bias added to
    # the router scores for top-k SELECTION only
    moe_correction_bias: bool = False
    num_experts_per_tok: int = 2
    moe_intermediate_size: int = 1408      # per-expert FFN width
    first_k_dense_replace: int = 1         # leading dense layers (DeepSeek)
    norm_topk_prob: bool = True            # renormalise the top-k weights
    router_aux_loss_coef: float = 0.001
    moe_capacity_factor: float = 2.0
    moe_scoring_func: str = "softmax"      # "sigmoid": DeepSeek-V3
    routed_scaling_factor: float = 1.0
    # group-limited routing: top-k restricted to the best topk_group of
    # n_group expert groups per token
    n_group: int = 1
    topk_group: int = 1

    @staticmethod
    def tiny_moe(**kw):
        base = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                    num_hidden_layers=3, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=256,
                    dtype="float32", n_routed_experts=4,
                    num_experts_per_tok=2, moe_intermediate_size=64,
                    first_k_dense_replace=1)
        base.update(kw)
        return LlamaMoEConfig(**base)


class MoEMLP(tnn.Module):
    """Routed experts + shared experts (``llama_moe.py:178-347``): router
    -> top-k -> capacity slots (k-major priority, drops) -> grouped FFN ->
    combine. The combine sums each token's kept routes in f32 and rounds
    once to the experts' type, as XLA's einsum accumulates."""

    def __init__(self, config: LlamaMoEConfig, device=None):
        super().__init__()
        self.config = config
        h, E = config.hidden_size, config.n_routed_experts
        dt = torch_dtype(config.dtype)
        self.gate_weight = tnn.Parameter(torch.empty(h, E, device=device,
                                                     dtype=dt))
        self.experts = GroupedMLP(E, h, config.moe_intermediate_size,
                                  activation="swiglu", device=device,
                                  dtype=dt)
        if config.n_shared_experts > 0:
            self.shared_expert = LlamaMLP(dataclasses.replace(
                config, intermediate_size=config.moe_intermediate_size
                * config.n_shared_experts), device=device)
        else:
            self.shared_expert = None
        self.e_score_correction_bias = (
            tnn.Parameter(torch.zeros(E, device=device, dtype=dt))
            if config.moe_correction_bias else None)
        self.shared_gate_weight = (
            tnn.Parameter(torch.empty(h, 1, device=device, dtype=dt))
            if config.shared_expert_gate else None)
        self._aux_loss = None

    def route(self, tokens):
        """Router of ``route_and_run`` (``llama_moe.py:249-304``): tokens
        [S, h] -> (probs [S, E] f32, logits [S, E] f32, topk_idx [S, K],
        topk weights [S, K] f32)."""
        cfg = self.config
        k, E = cfg.num_experts_per_tok, cfg.n_routed_experts
        S = tokens.shape[0]
        logits = tokens.float() @ self.gate_weight.float()
        if cfg.moe_scoring_func == "sigmoid":
            probs = torch.sigmoid(logits)
        elif cfg.moe_scoring_func == "softmax":
            probs = torch.softmax(logits, dim=-1)
        else:
            raise ValueError(f"moe_scoring_func must be 'softmax' or "
                             f"'sigmoid', got {cfg.moe_scoring_func!r}")
        sel = probs
        if self.e_score_correction_bias is not None:
            sel = probs + self.e_score_correction_bias.float()
        if cfg.n_group > 1:
            G = cfg.n_group
            if E % G != 0:
                raise ValueError(
                    f"n_routed_experts {E} not divisible by n_group {G}")
            if k > cfg.topk_group * (E // G):
                raise ValueError(
                    f"num_experts_per_tok {k} exceeds the {cfg.topk_group} "
                    f"allowed group(s) x {E // G} experts/group")
            sel_g = sel.reshape(S, G, E // G)
            if self.e_score_correction_bias is not None:
                gscore = sel_g.topk(min(2, E // G), dim=-1).values.sum(-1)
            else:
                gscore = sel_g.amax(-1)
            gidx = gscore.topk(cfg.topk_group, dim=-1).indices
            gmask = torch.zeros(S, G, dtype=torch.bool, device=sel.device)
            gmask.scatter_(1, gidx, True)
            sel = sel.masked_fill(~gmask.repeat_interleave(E // G, dim=1),
                                  float("-inf"))
        topk_idx = sel.topk(k, dim=-1).indices
        topk_p = probs.gather(1, topk_idx)
        if cfg.norm_topk_prob:
            topk_p = topk_p / torch.clamp(topk_p.sum(-1, keepdim=True),
                                          min=1e-20)
        return probs, logits, topk_idx, topk_p

    def forward(self, x):
        cfg = self.config
        b, s, h = x.shape
        E = cfg.n_routed_experts
        tokens = x.reshape(-1, h)
        S = tokens.shape[0]
        probs, logits, topk_idx, topk_p = self.route(tokens)
        cap = compute_capacity(S, E, cfg.num_experts_per_tok,
                               cfg.moe_capacity_factor)
        slot, keep = dispatch_positions(topk_idx, E, cap)
        # a kept route with weight 0 carries no token (dispatch = combine
        # > 0 in the JAX function)
        keep = keep & (topk_p > 0)
        e_idx = topk_idx.long()
        # each kept route's row of the [E * C] expert batch; dropped routes
        # all go to one spare row past the end, which is cut off (no
        # boolean indexing: nothing here waits for the device)
        dest = torch.where(keep, e_idx * cap + slot, E * cap)
        k = e_idx.shape[1]
        xe = tokens.new_zeros(E * cap + 1, h)
        xe.index_copy_(0, dest.reshape(-1),
                       tokens[:, None].expand(S, k, h).reshape(S * k, h))
        xe = xe[:E * cap].view(E, cap, h)
        ye = self.experts(xe)                                  # [E, C, h]
        picked = ye[e_idx, slot.clamp(max=cap - 1)]            # [S, K, h]
        wts = torch.where(keep, topk_p, 0.0).to(ye.dtype).float()
        out = (wts[..., None] * picked.float()).sum(1).to(ye.dtype)
        if cfg.routed_scaling_factor != 1.0:
            # filled on the device: no host copy inside a captured step
            out = out * torch.full((), cfg.routed_scaling_factor,
                                   dtype=ye.dtype, device=ye.device)
        # Switch-style aux value on the router distribution (the softmax of
        # the logits, also under sigmoid scores)
        dist = (probs if cfg.moe_scoring_func == "softmax"
                else torch.softmax(logits, dim=-1))
        ce = F.one_hot(topk_idx[:, 0], E).to(dist.dtype).mean(0)
        self._aux_loss = E * torch.sum(dist.mean(0) * ce)
        out = out.reshape(b, s, h).to(x.dtype)
        if self.shared_expert is not None:
            shared = self.shared_expert(x)
            if self.shared_gate_weight is not None:
                shared = torch.sigmoid(
                    x.float() @ self.shared_gate_weight.float()
                ).to(shared.dtype) * shared
            out = out + shared
        return out


class LlamaMoEDecoderLayer(tnn.Module):
    """Attention block + (dense | MoE) FFN (``llama_moe.py:350-395``); the
    discrete path only (the JAX layer has no fused decode tail)."""

    attn_cls = LlamaAttention  # subclasses (DeepSeek MLA) swap the block

    def __init__(self, config: LlamaMoEConfig, layer_idx: int, device=None):
        super().__init__()
        self.self_attn = type(self).attn_cls(config, device=device)
        if hasattr(self.self_attn, "window"):
            self.self_attn.window = layer_window(config, layer_idx)
        elif getattr(config, "layer_types", None):
            raise NotImplementedError(
                f"{type(self.self_attn).__name__} does not support the "
                "per-layer window schedule (layer_types)")
        self.is_moe = layer_idx >= config.first_k_dense_replace
        self.mlp = (MoEMLP(config, device=device) if self.is_moe
                    else LlamaMLP(config, device=device))
        self.input_layernorm = LlamaRMSNorm(config, device=device)
        self.post_attention_layernorm = LlamaRMSNorm(config, device=device)

    def forward(self, hidden_states, cos, sin, kv_cache=None):
        """Returns hidden, or (hidden, new cache) when given a cache."""
        residual = hidden_states
        hidden_states = self.input_layernorm(hidden_states)
        if kv_cache is not None:
            hidden_states, kv_cache = self.self_attn(hidden_states, cos, sin,
                                                     kv_cache)
        else:
            hidden_states = self.self_attn(hidden_states, cos, sin)
        norm = self.post_attention_layernorm
        hidden_states, residual = fused_norm.add_rms_norm(
            hidden_states, residual, norm.effective_weight(),
            norm.variance_epsilon)
        hidden_states = residual + self.mlp(hidden_states)
        if kv_cache is not None:
            return hidden_states, kv_cache
        return hidden_states


class LlamaMoEModel(LlamaModel):
    """``LlamaModel`` with MoE decoder layers (embedding, rope, norm kept).
    Not wrapped for recompute, as in the JAX package
    (``deepseek.py:478-479``): ``aux_loss`` reads each layer's ``mlp``."""

    layer_cls = LlamaMoEDecoderLayer
    wraps_recompute = False

    def _make_layer(self, config, layer_idx, device):
        return type(self).layer_cls(config, layer_idx, device=device)


class LlamaMoEForCausalLM(LlamaForCausalLM):
    """DeepSeekMoE / Qwen2-MoE-style causal LM. Expert biases and the
    correction bias start at 0, as the JAX package initialises them."""

    model_cls = LlamaMoEModel  # subclasses (DeepSeek MLA) swap the trunk

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        super().reset_parameters(generator)
        for name, p in self.named_parameters():
            if name.endswith(("experts.b1", "experts.b2",
                              "e_score_correction_bias")):
                p.zero_()

    def aux_loss(self, extra_layers=()):
        """Mean router aux value over every MoE layer that ran
        (``llama_moe.py:431-444``), plus any ``extra_layers``; None
        without one."""
        losses = [layer.mlp._aux_loss
                  for layer in list(self.llama.layers) + list(extra_layers)
                  if getattr(layer, "is_moe", False)
                  and layer.mlp._aux_loss is not None]
        if not losses:
            return None
        return sum(losses[1:], losses[0]) / len(losses)

    def forward(self, input_ids, labels=None):
        """Logits without labels; with labels (loss, logits or None), the
        loss plus ``router_aux_loss_coef`` x ``aux_loss()``
        (``llama_moe.py:446-462``)."""
        out = super().forward(input_ids, labels=labels)
        if labels is None:
            return out
        loss, logits = out
        aux = self.aux_loss()
        if aux is not None:
            loss = loss + self.config.router_aux_loss_coef * aux
        return loss, logits


# ---------------------------------------------------------------------------
# HuggingFace checkpoints of the grouped-expert families
# ---------------------------------------------------------------------------

_EXPERT_KEYS = ("gate_proj", "up_proj", "down_proj")


def _expert_hf_keys(hf_prefix, n_experts, expert_keys=_EXPERT_KEYS):
    return [f"{hf_prefix}.experts.{e}.{k}.weight"
            for e in range(n_experts) for k in expert_keys]


def pack_hf_experts(take, hf_prefix, n_experts, hidden_size,
                    expert_keys=_EXPERT_KEYS, experts=None):
    """A checkpoint's per-expert gate / up / down weights in the grouped
    [E, ...] layout (``llama_moe.py:155-176``): w1 the fused gate‖up
    [E, h, 2M], w2 [E, M, h], b1 / b2 zeros. ``take(hf_key, transpose)``
    gives one checkpoint tensor (transposed to [in, out]); ``expert_keys``
    names (gate, up, down) in the checkpoint (Mixtral: w1 / w3 / w2).
    With ``experts`` (a ``GroupedMLP``) each expert's three tensors are
    written into its slices of w1 / w2 in place, one at a time, and the
    module's (w1, b1, w2, b2) returned; without, new stacked tensors."""
    gate_k, up_k, down_k = expert_keys

    def key(e, k):
        return f"{hf_prefix}.experts.{e}.{k}.weight"

    if experts is None:
        w1 = torch.stack([torch.cat([take(key(e, gate_k), True),
                                     take(key(e, up_k), True)], dim=-1)
                          for e in range(n_experts)])
        w2 = torch.stack([take(key(e, down_k), True)
                          for e in range(n_experts)])
        b1 = w1.new_zeros(n_experts, 1, w1.shape[-1])
        b2 = w1.new_zeros(n_experts, 1, hidden_size)
        return w1, b1, w2, b2
    M = experts.d_hidden
    with torch.no_grad():
        for e in range(n_experts):
            for k, dst in ((gate_k, experts.w1[e, :, :M]),
                           (up_k, experts.w1[e, :, M:]),
                           (down_k, experts.w2[e])):
                src = take(key(e, k), True)
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(
                        f"{key(e, k)}: shape mismatch, loading "
                        f"{tuple(src.shape)} into {tuple(dst.shape)}")
                dst.copy_(src)
        experts.b1.zero_()
        experts.b2.zero_()
    return experts.w1, experts.b1, experts.w2, experts.b2


def _load_grouped(who, model, state, plan, experts, expert_keys=_EXPERT_KEYS,
                  transforms=None, aliases=(), leftovers=True,
                  require_covered=True):
    """Refuse, then write a grouped-expert model from ``state``: ``plan``
    ``{param name: (hf key, transpose)}`` for the plain tensors (with
    ``transforms[name]`` applied on the device), ``experts``
    ``{grouped module name: hf prefix}`` packed by ``pack_hf_experts``."""
    E = model.config.n_routed_experts
    keys = [k for k, _ in plan.values()]
    covered = set(plan)
    for name, prefix in experts.items():
        keys += _expert_hf_keys(prefix, E, expert_keys)
        covered.update(f"{name}.{w}" for w in ("w1", "b1", "w2", "b2"))
    _check_checkpoint(who, model, state, keys, covered, aliases=aliases,
                      leftovers=leftovers, require_covered=require_covered)
    _write_plan(who, model, state, plan, transforms)
    modules = dict(model.named_modules())
    for name, prefix in experts.items():
        dev = modules[name].w1.device

        def take(hf_key, transpose, dev=dev):
            t = hf_tensor(state[hf_key]).to(dev)
            return t.t() if transpose else t

        pack_hf_experts(take, prefix, E, model.config.hidden_size,
                        expert_keys=expert_keys, experts=modules[name])
    return model


def load_hf_grouped_moe(model, hf_state_dict, *, attn_biases=False,
                        qk_norms=False, shared_expert=False,
                        shared_gate=False, who="load_hf_moe",
                        mlp_key="mlp", expert_keys=_EXPERT_KEYS):
    """A HuggingFace state dict of the Qwen-MoE shape written into a
    grouped-expert model in place (``llama_moe.py:73-152``): embedding,
    final norm and head (tied-in-HF feeds an untied head from the
    embedding), per layer the attention (q/k/v biases, per-head q/k norms
    optional), the router (HF [E, h] -> [h, E]), the experts packed, the
    shared expert and its sigmoid gate optional. ``mlp_key`` /
    ``expert_keys`` rename the block (Mixtral: ``block_sparse_moe`` with
    w1 / w3 / w2). Refusals as ``load_hf_llama``'s."""
    cfg = model.config
    plan = {"llama.embed_tokens.weight": ("model.embed_tokens.weight", False),
            "llama.norm.weight": ("model.norm.weight", False)}
    if model.lm_head is not None:
        plan["lm_head.weight"] = (
            "lm_head.weight" if "lm_head.weight" in hf_state_dict
            else "model.embed_tokens.weight", True)
    experts = {}
    for i in range(cfg.num_hidden_layers):
        hf, ours = f"model.layers.{i}", f"llama.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            plan[f"{ours}.self_attn.{proj}.weight"] = (
                f"{hf}.self_attn.{proj}.weight", True)
        if attn_biases:
            for proj in ("q_proj", "k_proj", "v_proj"):
                plan[f"{ours}.self_attn.{proj}.bias"] = (
                    f"{hf}.self_attn.{proj}.bias", False)
        if qk_norms:
            for norm in ("q_norm", "k_norm"):
                plan[f"{ours}.self_attn.{norm}.weight"] = (
                    f"{hf}.self_attn.{norm}.weight", False)
        for norm in ("input_layernorm", "post_attention_layernorm"):
            plan[f"{ours}.{norm}.weight"] = (f"{hf}.{norm}.weight", False)
        plan[f"{ours}.mlp.gate_weight"] = (f"{hf}.{mlp_key}.gate.weight",
                                           True)
        experts[f"{ours}.mlp.experts"] = f"{hf}.{mlp_key}"
        if shared_expert:
            for proj in ("gate_proj", "up_proj", "down_proj"):
                plan[f"{ours}.mlp.shared_expert.{proj}.weight"] = (
                    f"{hf}.{mlp_key}.shared_expert.{proj}.weight", True)
        if shared_gate:   # HF [1, h] -> [h, 1]
            plan[f"{ours}.mlp.shared_gate_weight"] = (
                f"{hf}.{mlp_key}.shared_expert_gate.weight", True)
    return _load_grouped(who, model, hf_state_dict, plan, experts,
                         expert_keys=expert_keys,
                         aliases=("lm_head.weight",))
