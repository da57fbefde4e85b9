"""paddle.nn.functional's attention functionals, ported
(``paddle_tpu/nn/functional``): ``scaled_dot_product_attention``, and
``flash_attention`` as a callable module holding ``flash_attn_unpadded``,
the packed forms, ``sdp_kernel``, ``get_triangle_upper_mask`` and
``calc_reduced_attention_scores``."""
from .attention import scaled_dot_product_attention  # noqa: F401
from .flash_attention import (  # noqa: F401
    flash_attn_qkvpacked, flash_attn_unpadded, flash_attn_varlen_qkvpacked)
# flash_attention is a module in Paddle's layout (and callable); imported
# last so that the module wins the name
from . import flash_attention  # noqa: F401,E402
