"""Normalization layers (counterpart: ``paddle_tpu/nn/layer/norm.py``):
``LayerNorm``, ``RMSNorm``, ``BatchNorm``, ``BatchNorm1D``,
``BatchNorm2D`` and ``BatchNorm3D``.

``LayerNorm`` (weight one, bias zero, epsilon 1e-5) and ``RMSNorm``
(weight one, no bias, epsilon 1e-6) are the reference's, through
``F.layer_norm`` and ``F.rms_norm``.

Batch norm:
Scale one and shift zero, as in the reference; the running statistics
are fp32 buffers named ``_mean`` (zeros) and ``_variance`` (ones), the
reference's state names, so ``convert.load_jax_state`` carries them
across as they are. In training the layer normalizes by the batch and
moves the running statistics (``momentum`` 0.9 keeps 0.9 of the old
value); in eval mode it normalizes by the running statistics
(``nn/functional/norm.py``).

``SyncBatchNorm`` normalizes a training batch by the statistics of the
whole data-parallel group (``F.sync_batch_norm``); in eval mode, and in
a group of one rank, it is ``BatchNorm2D`` exactly.
``SyncBatchNorm.convert_sync_batchnorm(model)`` swaps every batch norm of
``model`` for one that keeps the same parameter and buffer objects.
The reference's eager multi-process ``SyncBatchNorm`` keeps local
statistics (``paddle_tpu/nn/layer/norm.py:83-86``); its compiled
data-parallel step and upstream Paddle take the group's, as the port does
(ROADMAP C).
"""
from __future__ import annotations

import torch

from ... import resolve_device
from .. import functional as F
from .common import _param
from .layers import Layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else \
            _param(torch.ones(self._normalized_shape), device, dtype)
        self.bias = None if bias_attr is False else \
            _param(torch.zeros(self._normalized_shape), device, dtype)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, device=None, dtype=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = _param(torch.ones(hidden_size), device, dtype)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class _BatchNormBase(Layer):
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
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, device=None, dtype=None,
                 group=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name,
                         device, dtype)
        self._group = group

    def forward(self, x):
        from ...distributed.parallel import _sync_group
        if self.training and not self._use_global_stats and \
                _sync_group(self._group) is not None:
            return F.sync_batch_norm(x, self._mean, self._variance,
                                     self.weight, self.bias,
                                     momentum=self._momentum,
                                     epsilon=self._epsilon,
                                     data_format=self._data_format,
                                     group=self._group)
        return super().forward(x)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm in it replaced by a
        ``SyncBatchNorm`` holding the same parameters and statistics;
        returns the (possibly new) top layer."""
        out = layer
        if isinstance(layer, _BatchNormBase) and \
                not isinstance(layer, SyncBatchNorm):
            out = cls(layer._num_features, layer._momentum, layer._epsilon,
                      weight_attr=False, bias_attr=False,
                      data_format=layer._data_format,
                      use_global_stats=layer._use_global_stats,
                      device=layer._mean.device)
            out.weight = layer.weight
            out.bias = layer.bias
            out._mean = layer._mean
            out._variance = layer._variance
            out.train(layer.training)
        for name, sub in list(layer.named_children()):
            layer._modules[name] = cls.convert_sync_batchnorm(sub)
        return out
