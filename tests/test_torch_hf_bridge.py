"""The port's HuggingFace checkpoint bridge for the Llama-layout families
and GPT-2 (``paddle_tpu_torch/models``: ``hf_config_to_llama``,
``load_hf_llama`` / ``export_hf_llama``, ``llama_from_hf`` /
``llama_to_hf``, every family's ``*_from_hf``) against the JAX package's
converters and against transformers.

Each tiny random-init transformers model (its 1-D weights, norms and
biases, moved off their initial values so that every one is checked) is
converted by both packages in f32 and bf16: every parameter must be equal
bit for bit, since every step of the conversion (a permutation, a
transpose, a bf16 <-> f32 cast) is exact. The port's f32 logits are held
against transformers' at the tolerances of the JAX package's own tests,
and Llama's greedy tokens must equal ``hf.generate``'s. No JAX forward is
run: the JAX side is only its converters' parameters."""
import os

import numpy as np
import pytest

os.environ.setdefault("USE_TF", "0")   # transformers' TensorFlow import
torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

SHAPE = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=128)

# family: (transformers class names, config fields, logits tolerance,
# prompt length) — the shapes and tolerances of the JAX family tests
FAMILIES = {
    "llama": (("LlamaConfig", "LlamaForCausalLM"),
              dict(rms_norm_eps=1e-5, rope_theta=10000.0), 2e-4, 9),
    "mistral": (("MistralConfig", "MistralForCausalLM"),
                dict(rope_theta=10000.0, sliding_window=8), 3e-4, 24),
    "qwen2": (("Qwen2Config", "Qwen2ForCausalLM"),
              dict(rms_norm_eps=1e-6, rope_theta=1e6), 3e-4, 9),
    "qwen3": (("Qwen3Config", "Qwen3ForCausalLM"),
              dict(head_dim=32, rms_norm_eps=1e-6, rope_theta=1e6), 3e-4, 9),
    "olmo2": (("Olmo2Config", "Olmo2ForCausalLM"),
              dict(rms_norm_eps=1e-6, rope_theta=500000.0, pad_token_id=0),
              5e-4, 9),
    "gemma": (("GemmaConfig", "GemmaForCausalLM"),
              dict(head_dim=32, rms_norm_eps=1e-6,
                   hidden_activation="gelu_pytorch_tanh",
                   tie_word_embeddings=True), 5e-4, 9),
    "gemma2": (("Gemma2Config", "Gemma2ForCausalLM"),
               dict(head_dim=32, query_pre_attn_scalar=64.0,
                    attn_logit_softcapping=50.0,
                    final_logit_softcapping=30.0, sliding_window=8,
                    rms_norm_eps=1e-6, hidden_activation="gelu_pytorch_tanh",
                    tie_word_embeddings=True), 5e-4, 12),
    "phi3": (("Phi3Config", "Phi3ForCausalLM"),
             dict(rms_norm_eps=1e-5, rope_theta=10000.0, pad_token_id=0,
                  max_position_embeddings=64), 5e-4, 12),
    "glm": (("GlmConfig", "GlmForCausalLM"),
            dict(head_dim=16, partial_rotary_factor=0.5,
                 attention_bias=True, pad_token_id=0), 5e-4, 11),
    "glm4": (("Glm4Config", "Glm4ForCausalLM"),
             dict(head_dim=16, partial_rotary_factor=0.5,
                  attention_bias=True, pad_token_id=0), 5e-4, 11),
    "gpt2": (("GPT2Config", "GPT2LMHeadModel"),
             dict(n_embd=64, n_layer=2, n_head=4, n_positions=128), 2e-4, 9),
}

# the converter of each family in both packages: (module, function)
CONVERTERS = {"llama": ("llama", "llama_from_hf"),
              "mistral": ("mistral", "mistral_from_hf"),
              "qwen2": ("qwen2", "qwen2_from_hf"),
              "qwen3": ("qwen3", "qwen3_from_hf"),
              "olmo2": ("olmo2", "olmo2_from_hf"),
              "gemma": ("gemma", "gemma_from_hf"),
              "gemma2": ("gemma2", "gemma2_from_hf"),
              "phi3": ("phi3", "phi3_from_hf"),
              "glm": ("glm", "glm_from_hf"),
              "glm4": ("glm", "glm4_from_hf"),
              "gpt2": ("gpt2", "gpt2_from_hf")}


def converter(package, family):
    import importlib

    mod, fn = CONVERTERS[family]
    return getattr(importlib.import_module(f"{package}.models.{mod}"), fn)


def perturb_1d_(model, seed):
    """Norm weights and biases moved off their initial values (ones or
    zeros), so a wrong or skipped one shows."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return model


def hf_model(family, seed=0, **extra):
    cfg_name, cls_name, fields = (*FAMILIES[family][0], FAMILIES[family][1])
    kw = dict(SHAPE, **fields) if family != "gpt2" else dict(
        vocab_size=128, **fields)
    kw.update(extra)
    torch.manual_seed(seed)
    cfg = getattr(transformers, cfg_name)(attn_implementation="eager", **kw)
    hf = getattr(transformers, cls_name)(cfg).eval()
    return perturb_1d_(hf, seed)


def bits(x) -> np.ndarray:
    """An array's bit pattern (bf16 as uint16, f32 as uint32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a.view(
        np.uint32)


def assert_same_parameters(port_model, jax_model):
    port = dict(port_model.named_parameters())
    ref = {k: np.asarray(v) for k, v in
           jax_model.functional_state().items()}
    assert sorted(port) == sorted(ref)
    for name, p in port.items():
        got, want = bits(p), bits(ref[name])
        assert got.shape == want.shape, name
        assert got.dtype == want.dtype, name
        assert np.array_equal(got, want), name


_CACHE = {}


def converted(family, dtype):
    """(hf, port model, JAX model) of ``family`` converted at ``dtype``,
    built once a module."""
    key = (family, dtype)
    if key not in _CACHE:
        if family not in _CACHE:
            _CACHE[family] = hf_model(family)
        hf = _CACHE[family]
        kw = dict(dtype=dtype, use_flash_attention=False)
        port = converter("paddle_tpu_torch", family)(hf, device="cpu", **kw)
        jax_model = converter("paddle_tpu", family)(hf, **kw)
        _CACHE[key] = (hf, port, jax_model)
    return _CACHE[key]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_parameters_equal_the_jax_converter(family, dtype):
    _, port, jax_model = converted(family, dtype)
    assert_same_parameters(port, jax_model)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_logits_match_transformers(family):
    hf, port, _ = converted(family, "float32")
    tol, seq = FAMILIES[family][2], FAMILIES[family][3]
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 128, (2, seq)))
    with torch.no_grad():
        ref = hf(ids).logits
        got = port(ids)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=tol, rtol=tol)


def test_llama_greedy_tokens_equal_hf_generate():
    hf, port, _ = converted("llama", "float32")
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 128, (2, 7)))
    with torch.no_grad():
        ref = hf.generate(ids, max_new_tokens=6, do_sample=False)[:, 7:]
    got = port.generate(ids, max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_tied_checkpoint_feeds_tied_and_untied_heads():
    """A tied-in-HF checkpoint: the tied model takes the ``lm_head.weight``
    alias; an untied model takes the embedding as its head, transposed."""
    from paddle_tpu_torch.models.llama import llama_from_hf

    hf = hf_model("llama", seed=3, tie_word_embeddings=True)
    tied = llama_from_hf(hf, device="cpu", dtype="float32",
                         use_flash_attention=False)
    assert tied.lm_head is None
    untied = llama_from_hf(hf, device="cpu", dtype="float32",
                           use_flash_attention=False,
                           tie_word_embeddings=False)
    assert torch.equal(untied.lm_head.weight,
                       hf.model.embed_tokens.weight.detach().t())
    ids = torch.from_numpy(np.random.RandomState(2).randint(0, 128, (1, 5)))
    with torch.no_grad():
        ref = hf(ids).logits
        for m in (tied, untied):
            np.testing.assert_allclose(m(ids).numpy(), ref.numpy(),
                                       atol=2e-4, rtol=2e-4)


_LONGROPE = {"type": "longrope",   # HF Phi3Config checks this spelling
             "short_factor": list(np.linspace(1.0, 1.5, 8)),
             "long_factor": list(np.linspace(2.0, 4.0, 8))}

# case: (family, rope_scaling, more config fields, prompt length); the
# cases of the JAX test_hf_interop and test_phi3 rope tests
ROPE_CASES = {
    "llama3": ("llama", {"rope_type": "llama3", "factor": 8.0,
                         "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                         "original_max_position_embeddings": 64}, {}, 40),
    "linear": ("llama", {"rope_type": "linear", "factor": 4.0}, {}, 40),
    "yarn": ("llama", {"rope_type": "yarn", "factor": 4.0,
                       "original_max_position_embeddings": 64}, {}, 40),
    # the table within original_max_position_embeddings: short factors
    "longrope_short": ("phi3", _LONGROPE,
                       dict(max_position_embeddings=96,
                            original_max_position_embeddings=96), 12),
    # past it: the long factors and the sqrt(1 + ln f / ln orig) magnitude
    "longrope_long": ("phi3", _LONGROPE,
                      dict(max_position_embeddings=64,
                           original_max_position_embeddings=16), 24),
}


@pytest.mark.parametrize("case", sorted(ROPE_CASES))
def test_rope_scaling_matches_transformers(case):
    """Each rope scaling mapped as is, parameters equal to JAX's
    converter's, logits at the JAX tests' tolerance, and greedy tokens
    equal (in the long longrope regime only the logits, as in JAX: the
    cached tables of ``generate`` are sized to prompt + new tokens)."""
    family, scaling, fields, seq = ROPE_CASES[case]
    kw = dict(num_attention_heads=2, num_key_value_heads=1,
              max_position_embeddings=256) if family == "llama" else {}
    hf = hf_model(family, rope_scaling=dict(scaling), **dict(kw, **fields))
    opts = dict(dtype="float32", use_flash_attention=False)
    ours = converter("paddle_tpu_torch", family)(hf, device="cpu", **opts)
    assert ours.config.rope_scaling["rope_type" if family == "llama"
                                    else "type"] == case.split("_")[0]
    assert_same_parameters(ours, converter("paddle_tpu", family)(hf, **opts))
    tol = 3e-4 if family == "llama" else 5e-4
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 128, (2, seq)))
    with torch.no_grad():
        ref = hf(ids).logits
        got = ours(ids)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=tol, rtol=tol)
    if case != "longrope_long":
        with torch.no_grad():
            gen_ref = hf.generate(ids, max_new_tokens=5,
                                  do_sample=False)[:, seq:]
        np.testing.assert_array_equal(
            ours.generate(ids, max_new_tokens=5).numpy(), gen_ref.numpy())


@pytest.mark.parametrize("family", ["llama", "qwen2", "qwen3", "olmo2",
                                    "gemma2"])
@pytest.mark.parametrize("dtype", [None, "float32"])
def test_llama_to_hf_equals_the_jax_exporter(family, dtype):
    """``llama_to_hf`` of the port's model = JAX's ``llama_to_hf`` of the
    JAX model converted from the same checkpoint, bit for bit, dtype and
    keys included; each tensor a contiguous CPU tensor in [out, in]."""
    from paddle_tpu.models.llama import llama_to_hf as jax_to_hf

    from paddle_tpu_torch.models.llama import llama_to_hf

    _, port, jax_model = converted(family, "bfloat16")
    got = llama_to_hf(port, dtype=dtype)
    want = jax_to_hf(jax_model, dtype=dtype)
    assert sorted(got) == sorted(want)
    for key, t in got.items():
        assert t.device.type == "cpu" and t.is_contiguous(), key
        assert np.array_equal(bits(t), bits(want[key])), key


@pytest.mark.parametrize("family", ["llama", "qwen3", "gemma2"])
def test_round_trip_through_transformers(family):
    """Exported into a fresh transformers model by ``load_state_dict``: the
    same logits as the checkpoint it came from; converted back: the same
    parameters."""
    from paddle_tpu_torch.models.llama import llama_to_hf

    hf, port, _ = converted(family, "float32")
    fresh = hf_model(family, seed=9)
    missing, unexpected = fresh.load_state_dict(llama_to_hf(port),
                                                strict=False)
    assert not unexpected
    assert all(k == "lm_head.weight" for k in missing)   # tied: re-tied
    ids = torch.from_numpy(np.random.RandomState(4).randint(0, 128, (2, 9)))
    with torch.no_grad():
        np.testing.assert_array_equal(fresh(ids).logits.numpy(),
                                      hf(ids).logits.numpy())
    back = converter("paddle_tpu_torch", family)(
        fresh, device="cpu", dtype="float32", use_flash_attention=False)
    for (name, a), (_, b) in zip(port.named_parameters(),
                                 back.named_parameters()):
        assert torch.equal(a, b), name


def test_loading_in_place_keeps_every_parameter():
    """``load_hf_llama`` writes into the model's own storage: every
    parameter keeps its data_ptr (what a captured CUDA graph reads) and
    takes the checkpoint's values."""
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               hf_config_to_llama,
                                               load_hf_llama)

    hf = hf_model("llama")
    model = LlamaForCausalLM(hf_config_to_llama(hf.config, dtype="float32"),
                             device="cpu")
    ptrs = {n: p.data_ptr() for n, p in model.named_parameters()}
    assert load_hf_llama(model, hf.state_dict()) is model
    assert {n: p.data_ptr() for n, p in model.named_parameters()} == ptrs
    sd = hf.state_dict()
    assert torch.equal(model.llama.layers[1].self_attn.k_proj.weight,
                       sd["model.layers.1.self_attn.k_proj.weight"].t())
    assert torch.equal(model.llama.norm.weight, sd["model.norm.weight"])


def test_numpy_state_and_config_dict():
    """A state of numpy arrays (bf16 as ml_dtypes, read-only ones too) and
    a ``config.json`` dict convert as the transformers model does."""
    import ml_dtypes

    from paddle_tpu_torch.models.llama import llama_from_hf

    hf, port, _ = converted("llama", "bfloat16")
    state = {}
    for k, v in hf.state_dict().items():
        a = v.float().numpy().astype(ml_dtypes.bfloat16)
        a.setflags(write=False)
        state[k] = a
    m = llama_from_hf(state, hf.config.to_dict(), device="cpu",
                      dtype="bfloat16", use_flash_attention=False)
    for (name, a), (_, b) in zip(port.named_parameters(),
                                 m.named_parameters()):
        assert np.array_equal(bits(a), bits(b)), name


def _llama_cfg(**kw):
    return dict(SHAPE, model_type="llama", **kw)


def _refusals():
    """(label, call(package) -> runs the refused conversion)."""
    def gemma_through_llama(pkg):
        converter(pkg, "llama")(hf_model("gemma"), **_kw(pkg))

    def per_layer_window(pkg):
        mod = __import__(f"{pkg}.models.llama", fromlist=["x"])
        mod.hf_config_to_llama(dict(SHAPE, model_type="qwen2",
                                    use_sliding_window=True,
                                    sliding_window=8, max_window_layers=1))

    def o_proj_bias(pkg):
        converter(pkg, "llama")(hf_model("llama", attention_bias=True),
                                **_kw(pkg))

    def missing_key(pkg):
        hf = hf_model("llama")
        sd = dict(hf.state_dict())
        del sd["model.layers.1.mlp.up_proj.weight"]
        converter(pkg, "llama")(sd, hf.config, **_kw(pkg))

    def shape_mismatch(pkg):
        mod = __import__(f"{pkg}.models.llama", fromlist=["x"])
        kw = {"device": "cpu"} if pkg == "paddle_tpu_torch" else {}
        wrong = mod.LlamaForCausalLM(mod.LlamaConfig.tiny(), **kw)
        mod.load_hf_llama(wrong, hf_model("llama").state_dict())

    def unsupported_rope(pkg):
        mod = __import__(f"{pkg}.models.llama", fromlist=["x"])
        mod.hf_config_to_llama(_llama_cfg(rope_scaling={
            "rope_type": "dynamic", "factor": 4.0}))

    def untyped_rope(pkg):
        mod = __import__(f"{pkg}.models.llama", fromlist=["x"])
        mod.hf_config_to_llama(_llama_cfg(rope_scaling={"factor": 4.0}))

    def malformed_longrope(pkg):
        mod = __import__(f"{pkg}.models.llama", fromlist=["x"])
        mod.hf_config_to_llama(_llama_cfg(rope_scaling={
            "rope_type": "longrope", "factor": 4.0}))

    def export(family):
        def run(pkg):
            mod = __import__(f"{pkg}.models.llama", fromlist=["x"])
            _, port, jax_model = converted(family, "float32")
            mod.llama_to_hf(port if pkg == "paddle_tpu_torch" else jax_model)
        return run

    return {"gemma_through_llama": gemma_through_llama,
            "per_layer_window": per_layer_window,
            "o_proj_bias": o_proj_bias, "missing_key": missing_key,
            "shape_mismatch": shape_mismatch,
            "unsupported_rope": unsupported_rope,
            "untyped_rope": untyped_rope,
            "malformed_longrope": malformed_longrope,
            "phi3_export": export("phi3"), "glm_export": export("glm")}


def _kw(pkg):
    kw = dict(dtype="float32", use_flash_attention=False)
    return dict(kw, device="cpu") if pkg == "paddle_tpu_torch" else kw


REFUSED = {"gemma_through_llama": (NotImplementedError, "gemma_from_hf"),
           "per_layer_window": (NotImplementedError, "max_window_layers"),
           "o_proj_bias": (ValueError, "o_proj.bias"),
           "missing_key": (KeyError, "up_proj"),
           "shape_mismatch": (ValueError, "shape"),
           "unsupported_rope": (NotImplementedError, "dynamic"),
           "untyped_rope": (NotImplementedError, "None"),
           "malformed_longrope": (ValueError, "short_factor"),
           "phi3_export": (NotImplementedError, "Phi3ForCausalLM"),
           "glm_export": (NotImplementedError, "GlmForCausalLM")}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals_raise_the_jax_exception(case):
    """Each refusal raises in the port what it raises in JAX, with the
    point named in the message."""
    run = _refusals()[case]
    exc, match = REFUSED[case]
    with pytest.raises(exc):
        run("paddle_tpu")
    with pytest.raises(exc, match=match):
        run("paddle_tpu_torch")


def test_the_bridge_has_no_cpu_fallback(monkeypatch):
    """Without CUDA and without ``device="cpu"`` the bridge raises, as
    ``default_device`` does, before converting anything."""
    from paddle_tpu_torch.models.llama import llama_from_hf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama_from_hf(hf_model("llama"), dtype="float32")
