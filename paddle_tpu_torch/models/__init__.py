"""Model families of the port."""
from .deepseek import DeepseekV2Config, DeepseekV2ForCausalLM  # noqa: F401
from .ernie45 import Ernie45Config, Ernie45ForCausalLM  # noqa: F401
from .gemma import GemmaConfig, GemmaForCausalLM  # noqa: F401
from .gemma2 import Gemma2Config, Gemma2ForCausalLM  # noqa: F401
from .glm import (Glm4Config, Glm4ForCausalLM, GlmConfig,  # noqa: F401
                  GlmForCausalLM)
from .gpt2 import GPT2Config, GPT2LMHeadModel  # noqa: F401
from .llama import LlamaConfig, LlamaForCausalLM  # noqa: F401
from .llama_moe import LlamaMoEConfig, LlamaMoEForCausalLM  # noqa: F401
from .mistral import MistralConfig, MistralForCausalLM  # noqa: F401
from .mixtral import MixtralConfig, MixtralForCausalLM  # noqa: F401
from .olmo2 import Olmo2Config, Olmo2ForCausalLM  # noqa: F401
from .phi3 import Phi3Config, Phi3ForCausalLM  # noqa: F401
from .qwen2 import Qwen2Config, Qwen2ForCausalLM  # noqa: F401
from .qwen2_moe import Qwen2MoeConfig, Qwen2MoeForCausalLM  # noqa: F401
from .qwen3 import Qwen3Config, Qwen3ForCausalLM  # noqa: F401
from .qwen3_moe import Qwen3MoeConfig, Qwen3MoeForCausalLM  # noqa: F401
