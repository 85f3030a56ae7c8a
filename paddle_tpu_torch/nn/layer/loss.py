"""Loss layers (counterpart: ``paddle_tpu/nn/layer/loss.py``):
``CrossEntropyLoss`` over ``nn.functional.cross_entropy``. It computes in
the logits' dtype, as the reference's does: bf16 under AMP O2 when the
model's last layer gives bf16 logits, as ResNet's does."""
from __future__ import annotations

from torch import nn

from .. import functional as F
from .layers import Layer


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self.weight,
                               ignore_index=self.ignore_index,
                               reduction=self.reduction,
                               soft_label=self.soft_label, axis=self.axis,
                               use_softmax=self.use_softmax,
                               label_smoothing=self.label_smoothing)
