from .activation import (celu, elu, gelu, hardsigmoid, hardswish, hardtanh,
                         leaky_relu, log_sigmoid, log_softmax, mish, relu,
                         relu6, selu, sigmoid, silu, softmax, softplus,
                         softsign, swish, tanh, tanhshrink)
from .common import embedding, linear
from .attention import (_sdpa_impl, _unpadded_impl, flash_attention,
                        flash_attn_unpadded, scaled_dot_product_attention,
                        sep_parallel_attention)
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose,
                   conv3d, conv3d_transpose)
from .loss import cross_entropy
from .norm import batch_norm, layer_norm, rms_norm, sync_batch_norm
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, max_pool1d, max_pool2d,
                      max_pool3d)

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "flash_attn_unpadded", "sep_parallel_attention", "_sdpa_impl",
           "_unpadded_impl", "gelu",
           "relu", "tanh", "relu6", "sigmoid", "silu", "swish", "mish",
           "softplus", "softsign", "tanhshrink", "hardtanh", "hardswish",
           "hardsigmoid", "elu", "selu", "celu", "leaky_relu",
           "log_sigmoid", "softmax", "log_softmax", "cross_entropy",
           "conv1d", "conv2d", "conv3d",
           "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
           "batch_norm", "sync_batch_norm", "layer_norm", "rms_norm", "linear", "embedding",
           "max_pool1d", "max_pool2d", "max_pool3d",
           "avg_pool1d", "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d"]
