from .activation import gelu, relu, tanh
from .common import embedding, linear
from .attention import (_sdpa_impl, _unpadded_impl, flash_attention,
                        flash_attn_unpadded, scaled_dot_product_attention)
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose,
                   conv3d, conv3d_transpose)
from .loss import cross_entropy
from .norm import batch_norm, layer_norm, rms_norm
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, max_pool1d, max_pool2d,
                      max_pool3d)

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "flash_attn_unpadded", "_sdpa_impl", "_unpadded_impl", "gelu",
           "relu", "tanh", "cross_entropy", "conv1d", "conv2d", "conv3d",
           "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
           "batch_norm", "layer_norm", "rms_norm", "linear", "embedding",
           "max_pool1d", "max_pool2d", "max_pool3d",
           "avg_pool1d", "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d"]
