"""Model families of the port."""
from .llama import LlamaConfig, LlamaForCausalLM  # noqa: F401
from .mistral import MistralConfig, MistralForCausalLM  # noqa: F401
