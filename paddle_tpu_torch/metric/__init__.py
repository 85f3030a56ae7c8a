"""Metrics (counterpart: ``paddle_tpu/metric/__init__.py``): ``Metric``
and ``Accuracy``.

``Accuracy.compute`` marks, for each sample, which of the ``maxk``
highest predictions is the label, with ``torch.topk`` on the predictions'
device (the reference sorts on the host; the two agree unless logits
tie); ``update`` sums those marks on the host and returns the batch's
accuracy; ``accumulate`` gives the accuracy over every batch since
``reset``.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(x):
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        """[..., maxk] fp32: 1 where the k-th highest prediction is the
        label. ``label`` holds class indices ([...] or [..., 1]) or
        one-hot rows."""
        pred, label = _tensor(pred), _tensor(label).to(pred.device)
        if label.ndim == pred.ndim and label.shape[-1] != 1:
            label = label.argmax(-1, keepdim=True)
        elif label.ndim == pred.ndim - 1:
            label = label[..., None]
        top = pred.topk(self.maxk, dim=-1).indices
        return (top == label).float()

    def update(self, correct, *args):
        c = _tensor(correct).detach().cpu().double()
        res = []
        for i, k in enumerate(self.topk):
            num = float(c[..., :k].sum())
            tot = int(np.prod(c.shape[:-1]))
            self.total[i] += num
            self.count[i] += tot
            res.append(num / tot if tot else 0.0)
        return res[0] if len(res) == 1 else res

    def accumulate(self):
        res = [t / c if c else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


__all__ = ["Metric", "Accuracy"]
