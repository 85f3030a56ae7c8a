from .attention import _sdpa_impl, scaled_dot_product_attention

__all__ = ["scaled_dot_product_attention", "_sdpa_impl"]
