from .activation import gelu, relu, tanh
from .attention import (_sdpa_impl, _unpadded_impl, flash_attention,
                        flash_attn_unpadded, scaled_dot_product_attention)
from .loss import cross_entropy

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "flash_attn_unpadded", "_sdpa_impl", "_unpadded_impl", "gelu",
           "relu", "tanh", "cross_entropy"]
