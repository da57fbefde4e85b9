"""The port's ``entry.py`` against the JAX package's ``__graft_entry__
.entry()``, on the CPU: the same configuration (but the JAX entry's
``use_flash_attention=False``, there for TPU portability), the same
parameter names, and bf16 logits of the JAX entry's state carried across
by ``weights.from_jax_state`` within 0.03 + 2^-7 |logit| (two bf16 steps
at the largest logits, about 2.3; sums in another order)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_pair import fake_kernels, posing_as_cuda  # noqa: F401

import __graft_entry__
from paddle_tpu_torch.entry import entry, entry_config
from paddle_tpu_torch.ops.hopper import _build, flash_attention
from paddle_tpu_torch.weights import from_jax_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_entry():
    fwd, (state, ids) = __graft_entry__.entry()
    return fwd, state, ids


def test_config_and_state_names_match_jax(jax_entry):
    from paddle_tpu.models.llama import LlamaConfig

    _, state, ids = jax_entry
    fwd, (port_state, port_ids) = entry("cpu")
    assert set(port_state) == set(state)
    for name, arr in state.items():
        assert tuple(port_state[name].shape) == tuple(arr.shape), name
        assert port_state[name].dtype == torch.bfloat16
    assert tuple(port_ids.shape) == tuple(ids.shape) == (2, 128)
    want = dataclasses.asdict(LlamaConfig(
        vocab_size=8192, hidden_size=512, intermediate_size=1408,
        num_hidden_layers=4, num_attention_heads=8, num_key_value_heads=4,
        max_position_embeddings=512, dtype="bfloat16"))
    for key, value in dataclasses.asdict(entry_config()).items():
        if key in want:
            assert value == want[key], key
    logits = fwd(port_state, port_ids)
    assert logits.shape == (2, 128, 8192) and logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all())


def test_logits_of_the_jax_state_match_jax(jax_entry):
    jax_fwd, state, ids = jax_entry
    want = np.asarray(jax_fwd(state, ids).astype("float32"))
    fwd, _ = entry("cpu")
    model = from_jax_state({k: np.asarray(v) for k, v in state.items()},
                           entry_config(), device="cpu")
    got = fwd(model.state_dict(), torch.from_numpy(np.array(ids)))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=0.03)


def test_entry_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_width_64_cuda_route(fake_kernels):
    """The entry's heads of 64 on a CUDA tensor: the causal forward kernel
    at its (64, 64) instantiation, counted as ``flash_attention_bshd``; an
    input that needs a gradient goes through the autograd Function, whose
    backward launches ``pt_flash_attention_bwd`` at (64, 64), counted as
    ``flash_attention_bwd_64`` (the entry trains on the card); a window at
    that width raises before any launch."""
    q = posing_as_cuda(torch.zeros(2, 128, 8, 64, dtype=torch.bfloat16))
    k, v = (posing_as_cuda(torch.zeros(2, 128, 4, 64, dtype=torch.bfloat16))
            for _ in range(2))
    out = flash_attention.flash_attention_bshd(q, k, v, causal=True)
    assert tuple(out.shape) == (2, 128, 8, 64)
    (name, args), = fake_kernels
    assert name == "pt_append_attention"
    assert args[6:15] == (2, 128, 128, 8, 4, 64, 64, 0, 0)
    assert dict(_build.launches) == {"flash_attention_bshd": 1}
    qg, kg, vg = (posing_as_cuda(torch.zeros(2, 128, h, 64), True)
                  for h in (8, 4, 4))
    out = flash_attention.flash_attention_bshd(qg, kg, vg, causal=True)
    assert out.grad_fn is not None
    out.sum().backward()
    assert [n for n, _ in fake_kernels] == ["pt_append_attention"] * 2 + [
        "pt_flash_attention_bwd"]
    fwd, bwd = fake_kernels[1][1], fake_kernels[2][1]
    assert fwd[5] is not None                      # lse written
    # B, S, T, H, hk, pos, window, q/k width, v width
    assert bwd[10:19] == (2, 128, 128, 8, 4, 0, 0, 64, 64)
    assert dict(_build.launches) == {"flash_attention_bshd": 2,
                                     "flash_attention_bwd_64": 1}
    assert [tuple(t.grad.shape) for t in (qg, kg, vg)] == [
        (2, 128, 8, 64), (2, 128, 4, 64), (2, 128, 4, 64)]
    with pytest.raises(NotImplementedError, match="window"):
        flash_attention.flash_attention_bshd(q, k, v, causal=True, window=32)
    assert len(fake_kernels) == 3


def test_entry_and_generate_import_neither_jax_nor_paddle_tpu():
    code = ("import sys, paddle_tpu_torch.entry, paddle_tpu_torch.generation\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'paddle_tpu'))\n"
            "assert not bad, bad\n"
            "print('clean')")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
