"""Model families of the port."""
from .deepseek import DeepseekV2Config, DeepseekV2ForCausalLM  # noqa: F401
from .ernie45 import Ernie45Config, Ernie45ForCausalLM  # noqa: F401
from .gemma import GemmaConfig, GemmaForCausalLM  # noqa: F401
from .gemma2 import Gemma2Config, Gemma2ForCausalLM  # noqa: F401
from .llama import LlamaConfig, LlamaForCausalLM  # noqa: F401
from .llama_moe import LlamaMoEConfig, LlamaMoEForCausalLM  # noqa: F401
from .mistral import MistralConfig, MistralForCausalLM  # noqa: F401
from .mixtral import MixtralConfig, MixtralForCausalLM  # noqa: F401
from .qwen2_moe import Qwen2MoeConfig, Qwen2MoeForCausalLM  # noqa: F401
from .qwen3_moe import Qwen3MoeConfig, Qwen3MoeForCausalLM  # noqa: F401
