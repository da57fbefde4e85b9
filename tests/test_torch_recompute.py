"""Port parity of layer recompute (``distributed/recompute_layer.py`` and
``LlamaConfig(recompute=True)``) against the JAX package, on the CPU with
the plain versions: f32 gradients with recompute equal to those without,
bit for bit, for tiny Llama and Mistral (window) under every policy; the
JAX recompute model's state through ``from_jax_state`` (the ``inner``
names); a 3-step ``train_step`` against the JAX ``TrainStep`` with
recompute; the cached forward and ``generate`` with recompute equal to
without; the MoE and MLA trunks left unwrapped as in JAX; and
``apply_recompute`` wrapping what the JAX one wraps. Each test states its
tolerance."""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pair import numpy_state

import paddle_tpu
from paddle_tpu import optimizer as jax_opt
from paddle_tpu.distributed import recompute_layer as jax_rc
from paddle_tpu.models import deepseek as jax_ds
from paddle_tpu.models import llama_moe as jax_moe
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.distributed import recompute_layer as port_rc
from paddle_tpu_torch.jit import train_step as port_train_step
from paddle_tpu_torch.models import deepseek as port_ds
from paddle_tpu_torch.models import llama_moe as port_moe
from paddle_tpu_torch.models.llama import LlamaConfig as PortConfig
from paddle_tpu_torch.models.mistral import MistralConfig
from paddle_tpu_torch.weights import from_jax_state, model_class

SEQ = 16
FAMILIES = {"llama": PortConfig.tiny,
            "mistral": lambda **kw: MistralConfig.tiny(sliding_window=8, **kw)}
POLICIES = [None, "full", "nothing_saveable", "dots_saveable",
            "dots_with_no_batch_dims_saveable"]


def _batch(seed=0, batch=2, vocab=512):
    ids = np.random.RandomState(seed).randint(0, vocab, size=(batch, SEQ + 1))
    x, y = ids[:, :-1].copy(), ids[:, 1:].copy()
    y[0, :3] = -1                                  # ignored positions
    return torch.from_numpy(x), torch.from_numpy(y)


def _random_state(model, seed=1):
    rng = np.random.RandomState(seed)
    return {name: (1.0 + 0.1 * rng.randn(*p.shape) if p.dim() == 1
                   else 0.05 * rng.randn(*p.shape)).astype(np.float32)
            for name, p in model.named_parameters()}


def _wrapped_name(name):
    """``llama.layers.0.x`` -> ``llama.layers.0.inner.x``."""
    parts = name.split(".")
    if parts[:2] == ["llama", "layers"]:
        parts.insert(3, "inner")
    return ".".join(parts)


def _grads(model, x, y):
    model.zero_grad(set_to_none=True)
    loss = model(x, labels=y)[0]
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_recompute_gradients_are_bit_identical(family, policy):
    """f32, the same weights: the loss and every parameter's gradient with
    each decoder layer recomputed equal those without, bit for bit (the
    backward replays the same operations on the same inputs)."""
    make = FAMILIES[family]
    base_cfg = make()
    state = _random_state(model_class(base_cfg)(base_cfg, device="cpu"))
    plain = from_jax_state(state, base_cfg, device="cpu")
    if policy is None:
        rc = from_jax_state({_wrapped_name(k): v for k, v in state.items()},
                            make(recompute=True), device="cpu")
    else:
        rc = from_jax_state(state, base_cfg, device="cpu")
        port_rc.apply_recompute(rc.llama.layers, SimpleNamespace(
            checkpoints=None, policy=policy))
    assert all(isinstance(layer, port_rc.RecomputeLayer)
               for layer in rc.llama.layers)
    x, y = _batch(0)
    loss_p, grads_p = _grads(plain, x, y)
    loss_r, grads_r = _grads(rc, x, y)
    assert torch.equal(loss_p, loss_r)
    assert set(grads_r) == {_wrapped_name(n) for n in grads_p}
    for name, g in grads_p.items():
        assert torch.equal(g, grads_r[_wrapped_name(name)]), name


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown recompute policy"):
        port_rc.RecomputeLayer(torch.nn.Linear(2, 2), policy="dots")


def test_policies_save_the_products_they_name():
    """``dots_saveable`` keeps every matrix product, the no-batch-dims
    policy the products without a batch dimension, the others none."""
    aten = torch.ops.aten
    assert not port_rc.saved_ops(None) and not port_rc.saved_ops("full")
    assert not port_rc.saved_ops("nothing_saveable")
    assert aten.bmm.default in port_rc.saved_ops("dots_saveable")
    no_batch = port_rc.saved_ops("dots_with_no_batch_dims_saveable")
    assert aten.mm.default in no_batch and aten.bmm.default not in no_batch


def _jax_pair(recompute=True, **overrides):
    """(jax_model, port_model, numpy state) of ``tiny(recompute=...)``
    holding the same weights; the JAX rope table built eagerly."""
    paddle_tpu.seed(0)
    jax_model = JaxLM(JaxConfig.tiny(recompute=recompute, **overrides))
    state = numpy_state(jax_model, seed=1)
    jax_model.load_functional_state(
        {k: jnp.asarray(v) for k, v in state.items()})
    jax_model.llama._rope(64)
    port_model = from_jax_state(
        state, PortConfig.tiny(recompute=recompute, **overrides),
        device="cpu")
    return jax_model, port_model, state


def test_jax_recompute_state_maps_by_name():
    """The JAX recompute model's state names (``layers.N.inner.``) are the
    port's: ``from_jax_state`` takes them with no renaming, bit for bit."""
    jax_model, port_model, state = _jax_pair()
    names = set(jax_model.functional_state())
    assert any(".inner." in n for n in names)
    assert names == {n for n, _ in port_model.named_parameters()}
    for name, p in port_model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), state[name])


def test_train_step_matches_jax_with_recompute():
    """Three ``train_step``s of AdamW(3e-4, weight_decay=0.1) on one batch,
    f32, both packages with ``recompute=True``; the tolerances of
    ``test_torch_train.test_train_step_matches_jax``: losses within 1e-5
    relative, every weight within 1e-6 except at most 0.1% of a tensor,
    those within 2 * 3 * lr."""
    jax_model, port_model, _ = _jax_pair()
    step_j = paddle_tpu.jit.train_step(
        jax_model, lambda m, a, b: m(a, labels=b)[0],
        jax_opt.AdamW(3e-4, parameters=jax_model.parameters(),
                      weight_decay=0.1))
    step_p = port_train_step(
        port_model, lambda m, a, b: m(a, labels=b)[0],
        port_opt.AdamW(3e-4, parameters=port_model.parameters(),
                       weight_decay=0.1))
    x, y = _batch(0)
    for _ in range(3):
        lj = float(step_j(paddle_tpu.to_tensor(x.numpy()),
                          paddle_tpu.to_tensor(y.numpy())).numpy())
        lp = step_p(x, y)
        np.testing.assert_allclose(lp.item(), lj, rtol=1e-5)
    jstate = jax_model.functional_state()
    for name, p in port_model.named_parameters():
        diff = np.abs(p.detach().numpy()
                      - np.asarray(jstate[name]).astype(np.float32))
        assert (diff > 1e-6).mean() <= 1e-3, name
        assert diff.max() <= 2 * 3 * 3e-4, name


def test_cached_paths_see_the_bare_layers():
    """``forward_cached`` (through ``generate``) unwraps each layer, and a
    recompute model off the grad path calls its inner layers: greedy
    tokens (dense and paged) and the inference forward's logits equal the
    plain model's on the same weights, bit for bit."""
    _, rc, state = _jax_pair()
    plain = from_jax_state({k.replace(".inner.", "."): v
                            for k, v in state.items()},
                           PortConfig.tiny(), device="cpu")
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, 512, size=(2, 9)))
    for kw in (dict(), dict(paged=True, page_size=8)):
        want = plain.generate(ids, max_new_tokens=5, **kw)
        got = rc.generate(ids, max_new_tokens=5, **kw)
        assert torch.equal(got, want), kw
    with torch.inference_mode():
        assert torch.equal(rc(ids), plain(ids))


@pytest.mark.parametrize("preset", ["tiny_moe", "tiny_mla"])
def test_moe_and_mla_trunks_stay_unwrapped(preset):
    """``recompute=True`` on the MoE and DeepSeek configs builds unwrapped
    layers in both packages (the aux-loss walk reads ``layer.mlp``): the
    same parameter names, none with ``inner``, and the model trains."""
    jax_cls, jax_cfg, port_cls, port_cfg = {
        "tiny_moe": (jax_moe.LlamaMoEForCausalLM, jax_moe.LlamaMoEConfig,
                     port_moe.LlamaMoEForCausalLM, port_moe.LlamaMoEConfig),
        "tiny_mla": (jax_ds.DeepseekV2ForCausalLM, jax_ds.DeepseekV2Config,
                     port_ds.DeepseekV2ForCausalLM,
                     port_ds.DeepseekV2Config)}[preset]
    paddle_tpu.seed(0)
    jax_names = set(jax_cls(getattr(jax_cfg, preset)(
        recompute=True)).functional_state())
    model = port_cls(getattr(port_cfg, preset)(recompute=True),
                     device="cpu")
    names = {n for n, _ in model.named_parameters()}
    assert names == jax_names
    assert not any(".inner." in n for n in names)
    assert not any(isinstance(m, port_rc.RecomputeLayer)
                   for m in model.modules())
    x, y = _batch(1)
    model(x, labels=y)[0].backward()
    assert all(p.grad is not None for p in model.parameters())


@pytest.mark.parametrize("checkpoints", [None, ["1"], ["layers"]])
def test_apply_recompute_wraps_what_jax_wraps(checkpoints):
    """``apply_recompute`` over a trunk's layer list and over the trunk
    itself (embedding, layer list, norm): the same children wrapped in
    both packages (the state names after it are equal), a named target
    only, and a child without parameters never."""
    paddle_tpu.seed(0)
    jax_model = JaxLM(JaxConfig.tiny())
    port_model = from_jax_state(
        {k: np.asarray(v).astype(np.float32)
         for k, v in jax_model.functional_state().items()},
        PortConfig.tiny(), device="cpu")
    configs = SimpleNamespace(checkpoints=checkpoints, policy="full")
    for target in ("layers", "trunk"):
        jax_t = (jax_model.llama.layers if target == "layers"
                 else jax_model.llama)
        port_t = (port_model.llama.layers if target == "layers"
                  else port_model.llama)
        jax_rc.apply_recompute(jax_t, configs)
        port_rc.apply_recompute(port_t, configs)
        assert set(jax_model.functional_state()) == {
            n for n, _ in port_model.named_parameters()}, target
    wrapped = [n for n, m in port_model.named_modules()
               if isinstance(m, port_rc.RecomputeLayer)]
    assert wrapped, checkpoints
