"""Batch-norm layers (counterpart: ``paddle_tpu/nn/layer/norm.py``):
``BatchNorm``, ``BatchNorm1D``, ``BatchNorm2D`` and ``BatchNorm3D``.

Scale one and shift zero, as in the reference; the running statistics
are fp32 buffers named ``_mean`` (zeros) and ``_variance`` (ones), the
reference's state names, so ``convert.load_jax_state`` carries them
across as they are. In training the layer normalizes by the batch and
moves the running statistics (``momentum`` 0.9 keeps 0.9 of the old
value); in eval mode it normalizes by the running statistics
(``nn/functional/norm.py``). ``SyncBatchNorm`` is not ported (ROADMAP
A7).
"""
from __future__ import annotations

import torch
from torch import nn

from ... import resolve_device
from .. import functional as F
from .common import _param


class _BatchNormBase(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, device=None, dtype=None):
        super().__init__()
        if weight_attr not in (None, False) or \
                bias_attr not in (None, False):
            raise NotImplementedError(
                "weight_attr and bias_attr other than None or False are "
                "not ported")
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else \
            _param(torch.ones(num_features), device, dtype)
        self.bias = None if bias_attr is False else \
            _param(torch.zeros(num_features), device, dtype)
        device = resolve_device(device)
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  device=device))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=device))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    """The legacy ``BatchNorm(num_channels)`` surface, with an optional
    activation by name after the normalization."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, moving_mean_name=None,
                 moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False,
                 device=None):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats or None,
                         device=device)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act:
            out = getattr(F, self._act)(out)
        return out


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SyncBatchNorm needs the distributed data plane (ROADMAP A7)")

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        raise NotImplementedError(
            "SyncBatchNorm needs the distributed data plane (ROADMAP A7)")
