"""Forward entry point of the port: counterpart of the JAX package's
``__graft_entry__.entry()``.

    from paddle_tpu_torch.entry import entry
    fwd, (state, ids) = entry()            # on the current CUDA device
    logits = fwd(state, ids)               # [2, 128, 8192] bf16

The model is the Llama-3 family causal LM at the entry's small shape
(vocab 8192, hidden 512, intermediate 1408, 4 layers, 8 query and 4 KV
heads, ``max_position_embeddings`` 512, bf16), weights drawn from the
port's generator seeded with 0, and ids [2, 128] from numpy's seed 0.
"""
from __future__ import annotations

import numpy as np
import torch

from .framework.random import default_device, seed
from .models.llama import LlamaConfig, LlamaForCausalLM


def entry_config() -> LlamaConfig:
    """The entry model's configuration. The JAX entry sets
    ``use_flash_attention=False`` to compile on any backend (its Pallas
    path is TPU-only); the port's non-cached forward runs its flash kernel
    whatever that flag says (the plain version on the CPU), so the flag is
    left at its default."""
    return LlamaConfig(vocab_size=8192, hidden_size=512,
                       intermediate_size=1408, num_hidden_layers=4,
                       num_attention_heads=8, num_key_value_heads=4,
                       max_position_embeddings=512, dtype="bfloat16")


def entry(device=None):
    """``(fwd, (state, ids))``: ``fwd(state, ids)`` loads ``state`` (a
    ``state_dict`` of the entry model, such as ``weights.from_jax_state``
    gives for the JAX entry's state) into the model and returns its logits
    for ``ids``. Runs on the current CUDA device unless ``device`` says
    otherwise (``device="cpu"``: the plain versions)."""
    device = default_device(device)
    cfg = entry_config()
    seed(0)
    model = LlamaForCausalLM(cfg, device=device)
    model.eval()
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def fwd(state, input_ids):
        model.load_state_dict(state)
        with torch.no_grad():
            return model(input_ids.to(device))

    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 128)).astype(np.int32)).to(device)
    return fwd, (state, ids)
