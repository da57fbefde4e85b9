"""Port parity of the MoE pieces against the JAX package, on the CPU: the
config presets, ``compute_capacity``, ``one_hot_dispatch`` (k-major
priority, drops) and ``MoEMLP`` with the softmax router at capacity factor
0.5 (routes drop) and 2.0, and with DeepSeek-V3 routing (sigmoid scores,
correction bias, group-limited top-k, routed scaling). f32; outputs within
1e-5."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pair import numpy_state

import paddle_tpu
from paddle_tpu.distributed import moe as jax_moe
from paddle_tpu.models.deepseek import DeepseekV2Config as JaxDeepseekConfig
from paddle_tpu.models.llama_moe import LlamaMoEConfig as JaxMoEConfig
from paddle_tpu.models.llama_moe import MoEMLP as JaxMoEMLP
from paddle_tpu_torch.distributed import moe as port_moe
from paddle_tpu_torch.models import DeepseekV2Config, LlamaMoEConfig
from paddle_tpu_torch.models.llama_moe import MoEMLP

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cls_pair,preset", [
    ((JaxMoEConfig, LlamaMoEConfig), "tiny_moe"),
    ((JaxDeepseekConfig, DeepseekV2Config), "tiny_mla"),
    ((JaxDeepseekConfig, DeepseekV2Config), "tiny_v3"),
])
def test_presets_match_jax(cls_pair, preset):
    jax_cls, port_cls = cls_pair
    want = dataclasses.asdict(getattr(jax_cls, preset)())
    got = dataclasses.asdict(getattr(port_cls, preset)())
    shared = set(want) & set(got)
    assert {"n_routed_experts", "moe_capacity_factor", "n_group"} <= shared
    for key in shared:
        assert got[key] == want[key], (preset, key)


@pytest.mark.parametrize("args", [(48, 4, 2, 0.5), (48, 4, 2, 2.0),
                                  (8, 64, 6, 2.0), (2048, 64, 6, 2.0),
                                  (3, 64, 6, 2.0)])
def test_compute_capacity_matches_jax(args):
    assert port_moe.compute_capacity(*args) == jax_moe.compute_capacity(*args)


@pytest.mark.parametrize("capacity", [1, 3, 12])
def test_one_hot_dispatch_matches_jax(capacity):
    """k-major slots and drops equal the JAX dense dispatch, a -1 route
    (no expert) included."""
    rng = np.random.RandomState(capacity)
    S, E, K = 24, 4, 2
    logits = rng.randn(S, E).astype(np.float32)
    idx = np.argsort(-logits, axis=1)[:, :K].astype(np.int32)
    idx[3, 1] = -1
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    want_c, want_d = jax_moe.one_hot_dispatch(jnp.asarray(probs),
                                              jnp.asarray(idx), capacity)
    got_c, got_d = port_moe.one_hot_dispatch(torch.from_numpy(probs),
                                             torch.from_numpy(idx), capacity)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=0)
    slot, keep = port_moe.dispatch_positions(torch.from_numpy(idx), E,
                                             capacity)
    assert int(keep.sum()) == int(np.asarray(want_d).sum())
    assert int(slot[keep].max()) < capacity


def _mlp_pair(cfg_kw, seed=0, jax_cls=JaxMoEConfig, port_cls=LlamaMoEConfig,
              preset="tiny_moe"):
    paddle_tpu.seed(seed)
    jax_cfg = getattr(jax_cls, preset)(**cfg_kw)
    jax_mlp = JaxMoEMLP(jax_cfg)
    state = numpy_state(jax_mlp, seed)
    jax_mlp.load_functional_state({k: jnp.asarray(v)
                                   for k, v in state.items()})
    port_mlp = MoEMLP(getattr(port_cls, preset)(**cfg_kw), device="cpu")
    port_mlp.load_state_dict({k: torch.from_numpy(v)
                              for k, v in state.items()})
    return jax_mlp, port_mlp


@pytest.mark.parametrize("case", [
    dict(moe_capacity_factor=0.5),
    dict(moe_capacity_factor=2.0),
    dict(moe_capacity_factor=0.5, norm_topk_prob=False, n_shared_experts=0,
         shared_expert_gate=False),
    dict(moe_capacity_factor=2.0, n_shared_experts=2,
         shared_expert_gate=True),
    "tiny_v3",
], ids=["cf0.5", "cf2.0", "cf0.5-raw-noshared", "cf2.0-sharedgate", "v3"])
def test_moe_mlp_matches_jax(case):
    """MoEMLP output and router aux value against the JAX layer, f32 within
    1e-5; at capacity factor 0.5 routes are dropped (the same ones)."""
    if case == "tiny_v3":
        jax_mlp, port_mlp = _mlp_pair({}, jax_cls=JaxDeepseekConfig,
                                      port_cls=DeepseekV2Config,
                                      preset="tiny_v3")
    else:
        jax_mlp, port_mlp = _mlp_pair(case)
    x = np.random.RandomState(1).randn(2, 24, 128).astype(np.float32)
    want = np.asarray(jax_mlp(paddle_tpu.to_tensor(x))._array)
    with torch.no_grad():
        got = port_mlp(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(float(port_mlp._aux_loss),
                               float(np.asarray(jax_mlp._aux_loss)), **TOL)
    cfg = port_mlp.config
    _, _, topk_idx, _ = port_mlp.route(torch.from_numpy(x).reshape(-1, 128))
    cap = port_moe.compute_capacity(48, cfg.n_routed_experts,
                                    cfg.num_experts_per_tok,
                                    cfg.moe_capacity_factor)
    _, keep = port_moe.dispatch_positions(topk_idx, cfg.n_routed_experts, cap)
    dropped = int((~keep).sum())
    if cfg.moe_capacity_factor < 1:
        assert dropped > 0
    else:
        assert dropped == 0


def test_moe_mlp_bf16_close_to_jax():
    """bf16 weights and activations: the combine is summed in f32 and
    rounded once, as XLA's einsum; within two bf16 ulps of the largest
    entry."""
    jax_mlp, port_mlp = _mlp_pair(dict(dtype="bfloat16"))
    x = np.random.RandomState(2).randn(1, 16, 128).astype(np.float32)
    want = np.asarray(jax_mlp(paddle_tpu.to_tensor(
        jnp.asarray(x, jnp.bfloat16)))._array).astype(np.float32)
    port_mlp = port_mlp.to(torch.bfloat16)
    with torch.no_grad():
        got = port_mlp(torch.from_numpy(x).to(torch.bfloat16)).float()
    top = float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=2 * 2.0 ** (np.floor(np.log2(top)) - 7))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_llama_moe_logits_and_bridge_match_jax(dtype):
    """``LlamaMoEForCausalLM`` (GQA attention, one dense and two MoE
    layers) from the bridge: every parameter crosses back bit for bit, and
    in f32 the non-cached logits agree with the JAX model's within 1e-4."""
    from paddle_tpu.models.llama_moe import LlamaMoEForCausalLM as JaxLM
    from paddle_tpu_torch.models import LlamaMoEForCausalLM
    from paddle_tpu_torch.weights import from_jax_state, to_numpy_state

    paddle_tpu.seed(3)
    jax_model = JaxLM(JaxMoEConfig.tiny_moe(dtype=dtype))
    state = numpy_state(jax_model, 3)
    if dtype == "bfloat16":
        state = {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
                 for k, v in state.items()}
    jax_model.load_functional_state({k: jnp.asarray(v)
                                     for k, v in state.items()})
    model = from_jax_state(state, LlamaMoEConfig.tiny_moe(dtype=dtype),
                           device="cpu")
    assert type(model) is LlamaMoEForCausalLM
    assert [layer.is_moe for layer in model.llama.layers] == [False, True,
                                                              True]
    back = to_numpy_state(model)
    for name, arr in state.items():
        want = arr.view(np.uint16) if dtype == "bfloat16" else arr
        np.testing.assert_array_equal(back[name], want, err_msg=name)
    if dtype == "float32":
        ids = np.random.RandomState(4).randint(0, 512, (1, 20))
        want = np.asarray(jax_model(paddle_tpu.to_tensor(ids))._array)
        with torch.no_grad():
            got = model(torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
