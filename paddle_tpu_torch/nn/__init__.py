from . import functional
from .layer import (GELU, Dropout, Embedding, Linear, MultiHeadAttention,
                    Tanh, TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "Linear", "Embedding", "Dropout", "GELU", "Tanh",
           "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]
