"""Model families of the port."""
from .deepseek import DeepseekV2Config, DeepseekV2ForCausalLM  # noqa: F401
from .llama import LlamaConfig, LlamaForCausalLM  # noqa: F401
from .llama_moe import LlamaMoEConfig, LlamaMoEForCausalLM  # noqa: F401
from .mistral import MistralConfig, MistralForCausalLM  # noqa: F401
