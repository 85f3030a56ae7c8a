from .activation import GELU, ReLU, Tanh
from .common import Dropout, Embedding, Flatten, Linear, Sequential
from .conv import Conv1D, Conv2D, Conv3D
from .loss import CrossEntropyLoss
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   SyncBatchNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                      AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                      AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                      AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D)
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["Linear", "Embedding", "Dropout", "Flatten", "Sequential",
           "GELU", "ReLU", "Tanh", "Conv1D", "Conv2D", "Conv3D",
           "CrossEntropyLoss", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "SyncBatchNorm", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]
