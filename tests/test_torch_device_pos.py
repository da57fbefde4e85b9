"""The dense caches' ``pos`` on the device, on the CPU.

The Pallas append kernel takes ``pos`` as a scalar-prefetch operand, so
one compiled kernel serves every chunk position
(``paddle_tpu/ops/pallas/append_attention.py:23-24``). The port's dense
caches carry it as a one-element int32 tensor for the same reason: one
CUDA graph of a decode step serves every position. Here every function
that takes ``pos`` gives the same bits with an int and with that tensor:
``cached_attention`` (Llama, a Mistral window, padded rows, per-row rope
positions), ``append_attention_plain``, the MLA dense path
(``mla_cached_attention``, one token and a chunk, with a column mask), the
fused decode tail's rope rows, and a decode forward of each family; and
the CUDA route of ``append_attention`` hands the kernel the tensor's
address as ``pos_dev`` (stand-in launches).
"""
import numpy as np
import pytest
import torch
from test_torch_pair import SMALL, fake_kernels, posing_as_cuda  # noqa: F401

from paddle_tpu_torch import generation
from paddle_tpu_torch.models import (DeepseekV2Config, DeepseekV2ForCausalLM,
                                     MistralConfig, MistralForCausalLM)
from paddle_tpu_torch.models.deepseek import mla_cached_attention
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           _rope_rows_for_cache, _rope_tables)
from paddle_tpu_torch.ops.hopper import _build
from paddle_tpu_torch.ops.hopper import append_attention as port_append
from paddle_tpu_torch.utils.flags import flag_overrides

# a head width the kernels take: at one with no instance (32) the plain
# route takes every chunk (``append_attention.plain_width``)
T, D = 24, 64


def _dev(pos):
    return torch.tensor(pos, dtype=torch.int32)


def _qkv(B, S, H, hk, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, S, H, D, generator=g),
            torch.randn(B, S, hk, D, generator=g),
            torch.randn(B, S, hk, D, generator=g))


def _bufs(B, hk, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, T, hk, D, generator=g),
            torch.randn(B, T, hk, D, generator=g))


@pytest.mark.parametrize("case", ["decode", "chunk", "allowed", "row_pos",
                                  "window", "window_allowed"])
def test_cached_attention_int_and_device_pos(case):
    """Output and both buffers bit for bit, int ``pos`` against the device
    int32, on every route of ``cached_attention`` the decode and chunks
    take (append attention, the windowed einsum), at pos 9."""
    B, H, hk, pos = 2, 4, 2, 9
    S = 1 if case in ("decode", "row_pos") else 5
    q, k, v = _qkv(B, S, H, hk)
    cos, sin = _rope_tables(T, D, 10000.0)
    kw = {}
    if "allowed" in case:
        allowed = torch.ones(B, T, dtype=torch.bool)
        allowed[1, 3:7] = False
        kw["allowed"] = allowed
    if case == "row_pos":
        kw["row_pos"] = torch.tensor([9, 4], dtype=torch.int32)
    if "window" in case:
        kw["window"] = 6
    outs = []
    for p in (pos, _dev(pos)):
        kb, vb = _bufs(B, hk)
        out, kb, vb = generation.cached_attention(q, k, v, cos, sin, kb, vb,
                                                  p, **kw)
        outs.append((out, kb, vb))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_prefill_routes_on_the_host():
    """An unpadded first chunk goes to the flash route with the
    ``prefill`` marker, whether ``pos`` is an int 0 or the device int32;
    without the marker it takes append attention (the route is the host's
    marker, never read off ``pos``)."""
    B, H, hk, S = 1, 4, 2, 6
    q, k, v = _qkv(B, S, H, hk)
    cos, sin = _rope_tables(T, D, 10000.0)
    calls = []
    real_flash = generation.flash_attention_bshd
    real_append = generation.append_attention
    try:
        generation.flash_attention_bshd = lambda *a, **kw: (
            calls.append("flash") or real_flash(*a, **kw))
        generation.append_attention = lambda *a, **kw: (
            calls.append("append") or real_append(*a, **kw))
        outs = []
        for pos, prefill in ((0, True), (_dev(0), True), (_dev(0), False),
                             (0, False)):
            kb, vb = _bufs(B, hk)
            outs.append(generation.cached_attention(
                q, k, v, cos, sin, kb, vb, pos, prefill=prefill)[0])
    finally:
        generation.flash_attention_bshd = real_flash
        generation.append_attention = real_append
    assert calls == ["flash", "flash", "append", "append"]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    torch.testing.assert_close(outs[3], outs[2], rtol=0, atol=0)
    torch.testing.assert_close(outs[2], outs[0], rtol=1e-5, atol=1e-5)


def test_append_attention_plain_int_and_device_pos():
    """The plain version with a window and a column mask (true positions
    gathered at ``pos + arange(S)``), int against device pos."""
    B, H, hk, S, pos = 2, 4, 2, 4, 11
    q = _qkv(B, S, H, hk)[0]
    kb, vb = _bufs(B, hk)
    allowed = torch.ones(B, T, dtype=torch.bool)
    allowed[0, 2:8] = False
    for window in (None, 5):
        a = port_append.append_attention_plain(q, kb, vb, pos, allowed,
                                               window)
        b = port_append.append_attention_plain(q, kb, vb, _dev(pos), allowed,
                                               window)
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("S", [1, 3])
def test_mla_dense_path_int_and_device_pos(S):
    """``mla_cached_attention`` over the latent buffer at pos 10: one token
    (``mla_decode``'s plain version) and a chunk (the einsums), with a
    column mask; output and both buffers bit for bit."""
    cfg = DeepseekV2Config.tiny_mla()
    B, H = 2, cfg.num_attention_heads
    dn, dr, dv, r = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                     cfg.v_head_dim, cfg.kv_lora_rank)
    g = torch.Generator().manual_seed(5)
    q_nope = torch.randn(B, S, H, dn, generator=g)
    q_pe = torch.randn(B, S, H, dr, generator=g)
    c_kv = torch.randn(B, S, r, generator=g)
    k_pe = torch.randn(B, S, dr, generator=g)
    w = torch.randn(r, H * (dn + dv), generator=g) * 0.1
    cos, sin = _rope_tables(T, dr, 10000.0)
    allowed = torch.ones(B, T, dtype=torch.bool)
    allowed[1, 1:4] = False
    outs = []
    for pos in (10, _dev(10)):
        ckv = torch.randn(B, T, r, generator=torch.Generator().manual_seed(6))
        kpe = torch.randn(B, T, dr,
                          generator=torch.Generator().manual_seed(7))
        outs.append(mla_cached_attention(
            q_nope, q_pe, c_kv, k_pe, cos, sin, ckv, kpe, pos, w,
            nope_dim=dn, v_dim=dv, allowed=allowed))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fused_tail_rope_rows_int_and_device_pos():
    cos, sin = _rope_tables(T, 128, 10000.0)
    a = _rope_rows_for_cache(cos, sin, {"pos": 7}, 3)
    b = _rope_rows_for_cache(cos, sin, {"pos": _dev(7)}, 3)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
        assert y.shape == (3, 128)


def _family(name):
    if name == "llama":
        return LlamaForCausalLM(LlamaConfig.tiny(**SMALL), device="cpu",
                                generator=torch.Generator().manual_seed(0))
    if name == "mistral":
        return MistralForCausalLM(
            MistralConfig(**dict(LlamaConfig.tiny(**SMALL).__dict__,
                                 sliding_window=8)),
            device="cpu", generator=torch.Generator().manual_seed(0))
    return DeepseekV2ForCausalLM(DeepseekV2Config.tiny_mla(), device="cpu",
                                 generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("name", ["llama", "mistral", "tiny_mla"])
@pytest.mark.parametrize("fused", [False, True])
def test_decode_forward_int_and_device_pos(name, fused):
    """A prefill of 12 tokens, then two decode forwards, on caches whose
    ``pos`` is an int and on copies whose ``pos`` is the device int32:
    logits and caches bit for bit (the fused tail where the family takes
    it)."""
    model = _family(name)
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, 512, (2, 12)).astype(np.int32))
    with torch.inference_mode(), flag_overrides(
            {"FLAGS_use_fused_decode_tail": fused}):
        caches = [dict(c, pos=0, prefill=True) for c in
                  generation._cache_buffers(model, 2, 20, False)]
        _, caches = model.llama.forward_cached(ids, caches, rope_len=20)
        dev = [dict(c, **{k: v.clone() for k, v in c.items()
                          if isinstance(v, torch.Tensor)},
                    pos=_dev(c["pos"])) for c in caches]
        tok = ids[:, -1:]
        for _ in range(2):
            h_int, caches = model.llama.forward_cached(tok, caches,
                                                       rope_len=20)
            h_dev, dev = model.llama.forward_cached(tok, dev, rope_len=20)
            torch.testing.assert_close(h_int, h_dev, rtol=0, atol=0)
            assert isinstance(dev[0]["pos"], torch.Tensor)
            assert int(dev[0]["pos"]) == caches[0]["pos"]
    for c_int, c_dev in zip(caches, dev):
        for key, val in c_int.items():
            if isinstance(val, torch.Tensor):
                torch.testing.assert_close(val, c_dev[key], rtol=0, atol=0)


def test_append_cuda_route_passes_pos_dev(fake_kernels):
    """On CUDA a device pos reaches ``pt_append_attention`` as its address
    (``pos_dev``, after the dtype code), with the host int 0; an int pos
    passes no address."""
    q = posing_as_cuda(torch.zeros(2, 1, 4, 128, dtype=torch.bfloat16))
    kb = posing_as_cuda(torch.zeros(2, 16, 2, 128, dtype=torch.bfloat16))
    vb = posing_as_cuda(torch.zeros(2, 16, 2, 128, dtype=torch.bfloat16))
    pos = posing_as_cuda(_dev(9))
    port_append.append_attention(q, kb, vb, pos)
    port_append.append_attention(q, kb, vb, 9)
    (n1, a1), (n2, a2) = fake_kernels
    assert n1 == n2 == "pt_append_attention"
    assert a1[13] == 0 and a1[18].value == pos.data_ptr()
    assert a2[13] == 9 and a2[18] is None
    assert a1[6:13] == a2[6:13] and a1[14:18] == a2[14:18]
    assert len(a1) == 20 and dict(_build.launches) == {
        "append_attention": 2}
    with pytest.raises(ValueError, match="one int32"):
        port_append.append_attention(q, kb, vb,
                                     posing_as_cuda(torch.tensor([9, 9])))
