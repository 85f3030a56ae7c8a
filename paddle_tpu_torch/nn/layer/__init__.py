from .activation import GELU, Tanh
from .common import Dropout, Embedding, Linear
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["Linear", "Embedding", "Dropout", "GELU", "Tanh",
           "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]
