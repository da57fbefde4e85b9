"""Phi-3's LongRoPE in the port against the JAX package on the CPU: the rope
tables (``_rope_tables`` with a ``"longrope"`` scaling) on both sides of
``original_max_position_embeddings``, with the sqrt(1 + ln f / ln orig)
magnitude factor, within 1e-6 (f32 sines and cosines of one frequency
table, the pow taken by each framework); ``validate_rope_scaling``'s and
``_longrope_params``' messages; the logits of a longrope Phi-3 past the
pretrained window (f32, atol 1e-4, rtol 1e-4); and the engine at a
``max_len`` past it against solo ``generate`` and JAX's tokens (the port's
``tests/test_phi3.py::test_longrope_engine_matches_solo``: every unit of a
request builds its table at the request's ``max_len``, so none mixes the
short and the long factors)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pair import jax_generate, numpy_state

import paddle_tpu
from paddle_tpu.models import llama as j_llama
from paddle_tpu.models import phi3 as j_phi3
from paddle_tpu.tensor_class import unwrap, wrap
from paddle_tpu_torch import models as port_models
from paddle_tpu_torch.models import llama as p_llama
from paddle_tpu_torch.serving import ContinuousBatchEngine
from paddle_tpu_torch.weights import from_jax_state

TOL = dict(rtol=1e-4, atol=1e-4)
ORIG = 16


def _scaling(half, orig=ORIG, seed=0, **extra):
    rng = np.random.RandomState(seed)
    out = {"rope_type": "longrope",
           "short_factor": np.sort(1 + rng.rand(half)).tolist(),
           "long_factor": np.sort(1 + 7 * rng.rand(half)).tolist()}
    if orig:
        out["original_max_position_embeddings"] = orig
    out.update(extra)
    return out


@pytest.mark.parametrize("dim", [16, 96])
@pytest.mark.parametrize("seq_len", [ORIG - 1, ORIG, ORIG + 1, 8 * ORIG])
@pytest.mark.parametrize("max_position", [None, 4 * ORIG, 64 * ORIG])
def test_tables_match_jax(dim, seq_len, max_position):
    """Short factors at or below ``orig``, long ones past it; the
    magnitude factor from max_position / orig (none without a
    max_position or at a factor of 1)."""
    scaling = _scaling(dim // 2)
    jc, js = j_llama._rope_tables(seq_len, dim, 10000.0, scaling=scaling,
                                  max_position=max_position)
    pc, ps = p_llama._rope_tables(seq_len, dim, 10000.0, scaling=scaling,
                                  max_position=max_position)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    inv, att = p_llama._longrope_params(scaling, dim, 10000.0, seq_len,
                                        max_position=max_position)
    ext = scaling["long_factor" if seq_len > ORIG else "short_factor"]
    base = 10000.0 ** (np.arange(0, dim, 2) / dim)
    np.testing.assert_allclose(inv.numpy(), 1 / (np.asarray(ext) * base),
                               rtol=1e-6)
    f = (max_position or 0) / ORIG
    want_att = np.sqrt(1 + np.log(f) / np.log(ORIG)) if f > 1 else 1.0
    assert abs(att - want_att) < 1e-12


def test_attention_factor_and_factor_keys_match_jax():
    """An explicit ``attention_factor`` wins; without max_position the
    scaling's ``factor`` sets the magnitude; without
    original_max_position_embeddings max_position picks the list."""
    for scaling, mp in ((_scaling(8, attention_factor=1.5), 64),
                        (_scaling(8, factor=4.0), None),
                        (_scaling(8, orig=None), 32)):
        for seq in (8, 40):
            j_inv, j_att = j_llama._longrope_params(scaling, 16, 10000.0, seq,
                                                    max_position=mp)
            p_inv, p_att = p_llama._longrope_params(scaling, 16, 10000.0, seq,
                                                    max_position=mp)
            np.testing.assert_allclose(p_inv.numpy(), np.asarray(j_inv),
                                       rtol=1e-6)
            assert p_att == j_att


@pytest.mark.parametrize("scaling,max_position", [
    ({"rope_type": "longrope", "short_factor": [1.0],
      "long_factor": [1.0, 2.0]}, 64),
    ({"rope_type": "longrope", "short_factor": [],
      "long_factor": [1.0]}, 64),
    ({"rope_type": "longrope", "long_factor": [1.0]}, 64),
    ({"rope_type": "longrope", "short_factor": [1.0],
      "long_factor": [2.0]}, None),
    ({"type": "longrope", "short_factor": [1.0], "long_factor": [2.0]},
     None),
    ({"rope_type": "dynamic", "factor": 2.0}, None),
    ({"factor": 2.0}, None),
    ({"rope_type": "yarn", "factor": 4.0}, None),
])
def test_validation_messages_match_jax(scaling, max_position):
    with pytest.raises((ValueError, NotImplementedError)) as jerr:
        j_llama.validate_rope_scaling(scaling, max_position=max_position)
    with pytest.raises((ValueError, NotImplementedError)) as perr:
        p_llama.validate_rope_scaling(scaling, max_position=max_position)
    assert type(perr.value) is type(jerr.value)
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("scaling", [
    None, {}, {"rope_type": "default"}, _scaling(8),
    {"rope_type": "linear", "factor": 2.0},
    {"rope_type": "yarn", "factor": 4.0,
     "original_max_position_embeddings": 16}])
def test_validation_passes_what_jax_passes(scaling):
    j_llama.validate_rope_scaling(scaling, max_position=64)
    p_llama.validate_rope_scaling(scaling, max_position=64)


def test_factor_list_length_message_matches_jax():
    scaling = _scaling(4)
    with pytest.raises(ValueError) as jerr:
        j_llama._longrope_params(scaling, 16, 10000.0, 8)
    with pytest.raises(ValueError) as perr:
        p_llama._longrope_params(scaling, 16, 10000.0, 8)
    assert str(perr.value) == str(jerr.value)


def test_config_takes_longrope():
    cfg = port_models.Phi3Config.tiny(rope_scaling=_scaling(8))
    assert p_llama._rope_type(cfg.rope_scaling) == "longrope"
    assert "longrope" in p_llama.SUPPORTED_ROPE_SCALING


def _phi3_pair(scaling, max_position=256, seed=0):
    kw = dict(num_hidden_layers=2, rope_scaling=scaling,
              max_position_embeddings=max_position)
    paddle_tpu.seed(seed)
    jax_model = j_phi3.Phi3ForCausalLM(j_phi3.Phi3Config.tiny(**kw))
    state = numpy_state(jax_model, seed)
    jax_model.load_functional_state({k: jnp.asarray(v)
                                     for k, v in state.items()})
    port = from_jax_state(state, port_models.Phi3Config.tiny(**kw),
                          device="cpu")
    return jax_model, port


@pytest.mark.parametrize("seq", [12, 24])
def test_logits_match_jax_on_both_sides_of_the_window(seq):
    """The forward without a cache builds its table at the sequence's
    length: 12 tokens take the short factors, 24 the long ones."""
    jax_model, port = _phi3_pair(_scaling(8))
    jax_model.llama._rope(seq)
    ids = np.random.RandomState(seq).randint(0, 512, (2, seq))
    want = np.asarray(unwrap(jax_model(wrap(jnp.asarray(ids)))))
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_engine_past_the_window_matches_solo_and_jax():
    """The engine at ``max_len`` 32 past an ``original_max`` of 8 (the long
    factors) against solo ``generate`` (whose table is as long as the
    prompt and the new tokens, 14: long too) and JAX's ``generate``: a
    prompt at the bucket boundary, which is ``original_max`` itself, must
    not prefill on a bucket-length (short-factor) table."""
    scaling = {"rope_type": "longrope", "short_factor": [1.0] * 8,
               "long_factor": [2.0] * 8,
               "original_max_position_embeddings": 8}
    jax_model, port = _phi3_pair(scaling, seed=6)
    prompt = np.random.RandomState(7).randint(1, 512, (8,))
    want = jax_generate(jax_model, prompt[None], max_new_tokens=6)[0]
    solo = port.generate(torch.from_numpy(prompt[None]),
                         max_new_tokens=6).numpy()[0]
    eng = ContinuousBatchEngine(port, max_batch=2, max_len=32, page_size=8)
    rid = eng.add_request(prompt, max_new_tokens=6)
    out = eng.run_until_done()[rid]
    np.testing.assert_array_equal(out, solo)
    np.testing.assert_array_equal(solo, want)
    assert 32 in port.llama._rope_cache and 8 not in port.llama._rope_cache
