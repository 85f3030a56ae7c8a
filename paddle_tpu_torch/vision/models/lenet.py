"""LeNet (counterpart: ``paddle_tpu/vision/models/lenet.py``): two
convolutions with ReLU and 2 x 2 max pooling, then three linear layers,
for 1 x 28 x 28 images. Weights are drawn from ``seed`` on the CPU;
``device`` follows the port's rule."""
from __future__ import annotations

import torch
from torch import nn

from ... import resolve_device
from ...nn import Conv2D, Linear, MaxPool2D, ReLU, Sequential
from ...nn.layer.common import generator_from


class LeNet(nn.Module):
    def __init__(self, num_classes=10, device=None, dtype=None, seed=0):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype,
                  generator=generator_from(seed))
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, **kw),
            ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, **kw),
            ReLU(),
            MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = Sequential(
                Linear(400, 120, **kw),
                Linear(120, 84, **kw),
                Linear(84, num_classes, **kw),
            )

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x
