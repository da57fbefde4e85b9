"""Port parity of ``generate`` / ``generate_paged`` against the JAX package,
on the CPU with the plain versions: the same numpy weights in both
packages, f32, greedy tokens identical for every cache route (dense,
right- and left-padded prompts, paged at page 16 and 8 with the cache
length rounded up to whole pages, chunked prefill with an uneven last
chunk, no cache, eos stop with eos fill) on Llama, on Mistral with a window
narrower than the run, and on ``tiny_mla`` (dense); the refusals, in type,
message and order, raised before any prefill; the engine against the
port's solo ``generate`` (paged and latent modes); and the CUDA routes of
the full-width runs at small size with stand-in launches."""
import numpy as np
import pytest
import torch
from test_torch_deepseek import _pair as mla_pair
from test_torch_mistral import _pair as mistral_pair
from test_torch_pair import (SMALL, build_pair, fake_kernels,  # noqa: F401
                             jax_generate, posing_as_cuda)

from paddle_tpu_torch import generation
from paddle_tpu_torch.serving import ContinuousBatchEngine as PortEngine

# prompts of 21 tokens and 8 new ones: max_len 29, or 32 paged at page 16
# or 8 and chunked by 8 (three chunks, the last one of 5 tokens)
S0, NEW = 21, 8


def _ids(seed=0, B=2, S=S0, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(
        np.int32)


def _mask(lengths, S=S0, left=False):
    am = np.zeros((len(lengths), S), np.int32)
    for b, n in enumerate(lengths):
        if left:
            am[b, S - n:] = 1
        else:
            am[b, :n] = 1
    return am


def _port(model, ids, **kw):
    out = model.generate(torch.from_numpy(np.asarray(ids)), **kw)
    return out.numpy()


@pytest.fixture(scope="module")
def llama():
    jax_model, port_model, _ = build_pair(max_len=32)
    return jax_model, port_model


@pytest.fixture(scope="module")
def mistral():
    jax_model, port_model, _ = mistral_pair(32, sliding_window=8, **SMALL)
    return jax_model, port_model


@pytest.fixture(scope="module")
def mla():
    jax_model, port_model, _ = mla_pair(32)
    return jax_model, port_model


# (label, generate keywords); the mask rows' lengths 21 and 13
ROUTES = [
    ("dense", {}),
    ("right-padded", {"attention_mask": _mask([21, 13])}),
    ("left-padded", {"attention_mask": _mask([21, 13], left=True)}),
    ("mixed padding", {"attention_mask": np.stack(
        [_mask([13])[0], _mask([9], left=True)[0]])}),
    ("paged 16", {"paged": True, "page_size": 16}),
    ("paged 8 ragged", {"paged": True, "page_size": 8,
                        "attention_mask": _mask([21, 13])}),
    ("chunked 8", {"prefill_chunk_size": 8}),
    ("chunked 8 ragged", {"prefill_chunk_size": 8,
                          "attention_mask": _mask([21, 13])}),
    # the JAX no-cache loop is eager and compiles every op at each length:
    # 4 new tokens
    ("no cache", {"use_cache": False, "max_new_tokens": 4}),
]


@pytest.mark.parametrize("label,kw", ROUTES, ids=[r[0] for r in ROUTES])
def test_llama_greedy_tokens_match_jax(llama, label, kw):
    jax_model, port_model = llama
    ids = _ids()
    kw = dict({"max_new_tokens": NEW}, **kw)
    want = jax_generate(jax_model, ids, **kw)
    got = _port(port_model, ids, **kw)
    assert got.shape == (2, kw["max_new_tokens"])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("label,kw", ROUTES[:2] + ROUTES[4:5] + ROUTES[6:7]
                         + ROUTES[8:],
                         ids=["dense", "right-padded", "paged 16",
                              "chunked 8", "no cache"])
def test_mistral_window_narrower_than_the_run_matches_jax(mistral, label,
                                                          kw):
    """Window 8 against 21 + 8 tokens: the band bites in the prefill and
    every decode step (dense einsum, paged band gather)."""
    jax_model, port_model = mistral
    ids = _ids(1)
    kw = dict({"max_new_tokens": NEW}, **kw)
    want = jax_generate(jax_model, ids, **kw)
    got = _port(port_model, ids, **kw)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ragged", [False, True])
def test_tiny_mla_dense_matches_jax(mla, ragged):
    jax_model, port_model = mla
    ids = _ids(2)
    kw = {"attention_mask": _mask([21, 13])} if ragged else {}
    want = jax_generate(jax_model, ids, max_new_tokens=NEW, **kw)
    got = _port(port_model, ids, max_new_tokens=NEW, **kw)
    np.testing.assert_array_equal(got, want)


def test_eos_stop_and_fill_match_jax(llama):
    """eos = the token row 0 emits third: row 0 stops there and is filled
    with eos while row 1 runs on; row 0 alone stops the run there."""
    jax_model, port_model = llama
    ids = _ids()
    ref = _port(port_model, ids, max_new_tokens=NEW)
    eos = int(ref[0, 2])
    want = jax_generate(jax_model, ids, max_new_tokens=NEW, eos_token_id=eos)
    got = _port(port_model, ids, max_new_tokens=NEW, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 2:] == eos).all()
    # one row alone stops the run early at its eos
    want1 = jax_generate(jax_model, ids[:1], max_new_tokens=NEW,
                         eos_token_id=eos)
    got1 = _port(port_model, ids[:1], max_new_tokens=NEW, eos_token_id=eos)
    np.testing.assert_array_equal(got1, want1)
    assert got1.shape == (1, 3)


def test_model_method_and_generate_paged_share_the_function(llama):
    _, port_model = llama
    ids = torch.from_numpy(_ids())
    a = generation.generate_paged(port_model, ids, max_new_tokens=NEW,
                                  page_size=8)
    b = port_model.generate(ids, max_new_tokens=NEW, paged=True, page_size=8)
    c = port_model.generate(ids, max_new_tokens=NEW)
    assert torch.equal(a, b) and torch.equal(b, c)
    assert port_model.generate(ids, max_new_tokens=0).shape == (2, 0)


# (label, keywords, pair): the JAX refusals, each raised before a prefill
REFUSALS = [
    ("repetition penalty 0", dict(repetition_penalty=0.0), "llama"),
    ("penalty before min_new", dict(repetition_penalty=-1.0,
                                    min_new_tokens=2), "llama"),
    ("min_new without eos", dict(min_new_tokens=2), "llama"),
    ("paged MLA", dict(paged=True), "mla"),
    ("paged MLA before beams", dict(paged=True, num_beams=2,
                                    do_sample=True), "mla"),
    ("beam sampling", dict(num_beams=2, do_sample=True), "llama"),
    ("paged beams", dict(num_beams=2, paged=True), "llama"),
    ("beams without cache", dict(num_beams=2, use_cache=False), "llama"),
    ("chunks without cache", dict(prefill_chunk_size=8, use_cache=False),
     "llama"),
    ("overflow", dict(max_new_tokens=300), "llama"),
    ("overflow after paging", dict(max_new_tokens=220, paged=True,
                                   page_size=48), "llama"),
    ("mask without cache", dict(use_cache=False,
                                attention_mask=_mask([21, 13])), "llama"),
    ("interior hole", dict(attention_mask=np.array(
        [[1] * 21, [1] * 5 + [0] * 3 + [1] * 13])), "llama"),
    ("all-zero row", dict(attention_mask=_mask([21, 0])), "llama"),
]


@pytest.mark.parametrize("label,kw,which", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_refusals_match_jax(llama, mla, label, kw, which, monkeypatch):
    jax_model, port_model = llama if which == "llama" else mla
    kw = dict({"max_new_tokens": NEW}, **kw)
    ids = _ids()
    with pytest.raises(Exception) as want:
        jax_generate(jax_model, ids, **dict(kw))

    def no_prefill(*a, **k):
        raise AssertionError("a prefill ran before the refusal")

    monkeypatch.setattr(generation._PrefillStep, "__call__", no_prefill)
    monkeypatch.setattr(generation._ChunkedPrefillStep, "__call__",
                        no_prefill)
    with pytest.raises(want.type) as got:
        _port(port_model, ids, **kw)
    assert str(got.value) == str(want.value)


def _engine_tokens(model, prompts, new, **kw):
    eng = PortEngine(model, **kw)
    rids = [eng.add_request(p, max_new_tokens=new) for p in prompts]
    out = eng.run_until_done()
    return [out[r] for r in rids]


@pytest.mark.parametrize("which", ["llama", "mla"])
def test_engine_equals_solo_generate(llama, mla, which):
    """Each request's engine tokens (paged pool for Llama, latent rows for
    MLA; more requests than slots) equal the port's own ``generate`` on the
    same prompt alone, and on the prompts as one ragged batch."""
    _, port_model = llama if which == "llama" else mla
    lengths = (21, 13, 5, 17)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 512, n).astype(np.int32) for n in lengths]
    got = _engine_tokens(port_model, prompts, NEW, max_batch=2, max_len=64,
                         page_size=8)
    batch = np.zeros((len(prompts), max(lengths)), np.int32)
    for b, p in enumerate(prompts):
        batch[b, :p.size] = p
    ragged = _port(port_model, batch, max_new_tokens=NEW,
                   attention_mask=_mask(lengths, S=max(lengths)))
    for b, p in enumerate(prompts):
        solo = _port(port_model, p[None], max_new_tokens=NEW)[0]
        np.testing.assert_array_equal(got[b], solo)
        np.testing.assert_array_equal(ragged[b], solo)


# ---------------------------------------------------------------------------
# the CUDA routes of the full-width runs, at small size
# ---------------------------------------------------------------------------

PLAIN = ("append_attention_plain", "flash_attention_plain",
         "paged_attention_plain", "mla_decode_plain", "rms_norm_plain",
         "add_rms_norm_plain")


@pytest.fixture
def on_card(fake_kernels, monkeypatch):
    """The model's parameters posing as CUDA tensors, the kernels' C calls
    stand-ins (``fake_kernels``; the inputs' contiguity still checked), 132
    SMs, and every plain version of a kernel refusing a "CUDA" tensor.
    Yields a function that puts a model "on the card"."""
    from paddle_tpu_torch.ops.hopper import (_build, append_attention,
                                             flash_attention, fused_norm,
                                             mla_decode, paged_attention)

    monkeypatch.setattr(_build, "sm_count", lambda device: 132)

    def contiguous(*tensors):
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("kernel inputs must be contiguous")

    # the device check stays off; the layout check is the card's
    monkeypatch.setattr(_build, "require_cuda", contiguous)
    guarded = set()
    for mod in (append_attention, flash_attention, fused_norm, mla_decode,
                paged_attention):
        for name in PLAIN:
            real = getattr(mod, name, None)
            if real is None or getattr(real, "__module__", None) != \
                    mod.__name__:
                continue
            guarded.add(name)

            def guard(*a, _real=real, _name=name, **k):
                if any(getattr(t, "device", None) is not None
                       and t.device.type == "cuda" for t in a):
                    raise AssertionError(f"{_name} ran on a CUDA tensor")
                return _real(*a, **k)

            monkeypatch.setattr(mod, name, guard)
    assert guarded == set(PLAIN)

    def put(model):
        for mod in model.modules():
            for name, p in list(mod._parameters.items()):
                if p is not None:
                    mod._parameters[name] = posing_as_cuda(p.detach())
        return model

    yield put


def _small_llama():
    """Two layers, heads of 128, 4 query heads over 2 KV heads."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    return LlamaForCausalLM(LlamaConfig.tiny(**dict(SMALL,
                                                    num_key_value_heads=2)),
                            device="cpu")


@pytest.mark.parametrize("run", ["a", "b", "c", "d"])
def test_llama_cuda_routes_launch_counts(on_card, run):
    """The full-width runs' routes at 2 layers, B 2, 8 new tokens (7
    forwards): a dense (flash prefill, append-attention decode), b paged
    (flash prefill, paged decode), c right-padded (masked append prefill
    and decode), d chunked by 7, unpadded (chunk 0 flash, chunks 1-2
    append)."""
    from paddle_tpu_torch.ops.hopper import _build

    model = on_card(_small_llama())
    L, n = 2, NEW - 1
    ids = torch.from_numpy(_ids())
    kw, want = {
        "a": ({}, {"flash_attention_bshd": L, "append_attention": L * n,
                   "paged_attention": 0}),
        "b": ({"paged": True}, {"flash_attention_bshd": L,
                                "paged_attention": L * n,
                                "append_attention": 0}),
        "c": ({"attention_mask": torch.from_numpy(_mask([21, 13]))},
              {"append_attention": L + L * n, "flash_attention_bshd": 0,
               "paged_attention": 0}),
        "d": ({"prefill_chunk_size": 7},
              {"flash_attention_bshd": L, "append_attention": 2 * L + L * n,
               "paged_attention": 0}),
    }[run]
    out = generation.generate(model, ids, max_new_tokens=NEW, **kw)
    assert out.shape == (2, NEW)
    got = {k: _build.launches.get(k, 0) for k in want}
    assert got == want
    assert _build.launches["rms_norm"] > 0
    assert _build.launches["add_rms_norm"] > 0


def test_mla_cuda_route_launch_counts_and_paged_refusal(on_card):
    """Run g at small size (8 heads, the fewest the MLA kernel takes, as
    the JAX gate): the width-192 expanded prefill goes to the flash
    kernel's MLA counter (the plain version would refuse the "CUDA"
    tensors), every decode step to ``mla_decode``; ``paged=True`` raises
    before any launch."""
    from paddle_tpu_torch.models import deepseek
    from paddle_tpu_torch.ops.hopper import _build

    model = on_card(deepseek.DeepseekV2ForCausalLM(
        deepseek.DeepseekV2Config.tiny_mla(num_hidden_layers=2,
                                           num_attention_heads=8,
                                           num_key_value_heads=8,
                                           qk_nope_head_dim=128,
                                           qk_rope_head_dim=64,
                                           v_head_dim=128),
        device="cpu"))
    ids = torch.from_numpy(_ids())
    with pytest.raises(NotImplementedError):
        generation.generate(model, ids, max_new_tokens=NEW, paged=True)
    assert not _build.launches
    generation.generate(model, ids, max_new_tokens=NEW)
    L = 2
    assert _build.launches["flash_attention_mla"] == L
    assert _build.launches["mla_decode"] == L * (NEW - 1)
    for name in ("flash_attention_bshd", "append_attention",
                 "paged_attention"):
        assert _build.launches.get(name, 0) == 0
