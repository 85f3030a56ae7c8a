"""The ResNet family (counterpart: ``paddle_tpu/vision/models/
resnet.py``): ``BasicBlock``, ``BottleneckBlock``, ``ResNet`` and the
``resnet*``, ``wide_resnet*`` and ``resnext*`` builders.

The layers, their order and their names are the reference's, so a JAX
model's ``state_dict()`` (parameters and the batch norms' ``_mean`` and
``_variance``) loads through ``convert.load_jax_state`` as it is. On the
card the convolutions and batch norms are cuDNN's and the pools ATen's.

``data_format="NHWC"`` runs the convolution stack channels-last: the
NCHW input is copied once into channels-last memory, every convolution,
batch norm and pool takes it as PyTorch's ``channels_last`` format, and
the stack's output is viewed back as NCHW before the pool and the
classifier, so the API stays NCHW, as in the reference.

Weights are random, drawn from ``seed`` (an int or a
``torch.Generator``) on the CPU, so one seed gives the same model on
the card and on the CPU; ``device`` follows the port's rule ("cuda"
unless ``device="cpu"``). ``pretrained=True`` raises: no weights are
downloaded.
"""
from __future__ import annotations

import torch
from torch import nn

from ... import resolve_device
from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear,
                   MaxPool2D, ReLU, Sequential)
from ...nn.layer.common import generator_from
from ...nn.layer.layers import Layer


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", device=None, dtype=None,
                 generator=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        df = {"data_format": data_format} if data_format != "NCHW" else {}
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                            bias_attr=False, **df, **kw)
        self.bn1 = norm_layer(planes, **df, device=device)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            **df, **kw)
        self.bn2 = norm_layer(planes, **df, device=device)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", device=None, dtype=None,
                 generator=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        df = {"data_format": data_format} if data_format != "NCHW" else {}
        kw = dict(device=device, dtype=dtype, generator=generator)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False, **df, **kw)
        self.bn1 = norm_layer(width, **df, device=device)
        self.conv2 = Conv2D(width, width, 3, padding=dilation, stride=stride,
                            groups=groups, dilation=dilation,
                            bias_attr=False, **df, **kw)
        self.bn2 = norm_layer(width, **df, device=device)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, **df, **kw)
        self.bn3 = norm_layer(planes * self.expansion, **df, device=device)
        self.relu = ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(Layer):
    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, data_format="NCHW", device=None,
                 dtype=None, seed=0):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = BatchNorm2D
        self._data_format = data_format
        kw = dict(device=resolve_device(device), dtype=dtype,
                  generator=generator_from(seed))
        df = {"data_format": data_format} if data_format != "NCHW" else {}
        self.inplanes = 64
        self.dilation = 1
        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False, **df, **kw)
        self.bn1 = self._norm_layer(self.inplanes, **df, device=kw["device"])
        self.relu = ReLU()
        self.maxpool = MaxPool2D(3, stride=2, padding=1, **df)
        self.layer1 = self._make_layer(block, 64, layers[0], **kw)
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2, **kw)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2, **kw)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2, **kw)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes, **kw)

    def _make_layer(self, block, planes, blocks, stride=1, dilate=False,
                    **kw):
        """A stage of ``blocks`` blocks; ``kw`` (device, dtype, generator)
        goes to every layer built."""
        norm_layer = self._norm_layer
        downsample = None
        df = {"data_format": self._data_format} \
            if self._data_format != "NCHW" else {}
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, **df, **kw),
                norm_layer(planes * block.expansion, **df,
                           device=kw["device"]),
            )
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, self.dilation,
                        norm_layer, data_format=self._data_format, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer,
                                data_format=self._data_format, **kw))
        return Sequential(*layers)

    def forward(self, x):
        if self._data_format == "NHWC":
            # one copy into channels-last memory; every layer below takes
            # NHWC views of it
            x = x.permute(0, 2, 3, 1).contiguous()
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self._data_format == "NHWC":
            x = x.permute(0, 3, 1, 2)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = torch.flatten(x, 1)
            x = self.fc(x)
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not downloaded; load a state with "
            "convert.load_jax_state")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, width=128, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, width=128, **kwargs)


def _resnext(depth, groups):
    def build(pretrained=False, **kwargs):
        return _resnet(BottleneckBlock, depth, pretrained, groups=groups,
                       width=4, **kwargs)
    build.__name__ = f"resnext{depth}_{groups}x4d"
    return build


resnext50_32x4d = _resnext(50, 32)
resnext50_64x4d = _resnext(50, 64)
resnext101_32x4d = _resnext(101, 32)
resnext101_64x4d = _resnext(101, 64)
resnext152_32x4d = _resnext(152, 32)
resnext152_64x4d = _resnext(152, 64)
