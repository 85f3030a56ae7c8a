"""Metrics (counterpart: ``paddle_tpu/metric/__init__.py``): ``Metric``,
``Accuracy``, ``Precision``, ``Recall``, ``Auc`` and ``accuracy``.

``Accuracy.compute`` marks, for each sample, which of the ``maxk``
highest predictions is the label, with ``torch.topk`` on the predictions'
device (the reference sorts on the host; the two agree unless logits
tie); ``update`` sums those marks on the host and returns the batch's
accuracy; ``accumulate`` gives the accuracy over every batch since
``reset``.

``Precision`` and ``Recall`` threshold binary predictions at 0.5 and
count on the host, ``Auc`` keeps the reference's ``num_thresholds + 1``
buckets of positive and negative counts (a prediction p lands in bucket
``int(p * num_thresholds)``, clipped) and integrates the ROC curve by the
trapezoid rule over them, as the reference does. ``accuracy`` is the
top-k hit rate of one batch, as a 0-d float32 tensor on the input's
device (a paddle ``Tensor`` for a paddle ``Tensor`` input).
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(x):
    x = getattr(x, "_value", x)
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def _np(x):
    """A host numpy copy of a metric input (bf16 widened to float32)."""
    x = getattr(x, "_value", x)
    if torch.is_tensor(x):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x)


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


class Precision(Metric):
    def __init__(self, name=None):
        self._name = name or "precision"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        lab = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fp += int(((p == 1) & (lab == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name=None):
        self._name = name or "recall"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        lab = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fn += int(((p == 0) & (lab == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        self._name = name or "auc"
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2:
            p = p[:, 1]
        lab = _np(labels).reshape(-1).astype(bool)
        bins = np.clip((p * self.num_thresholds).astype(np.int64), 0,
                       self.num_thresholds)
        size = self.num_thresholds + 1
        self._stat_pos += np.bincount(bins[lab], minlength=size)
        self._stat_neg += np.bincount(bins[~lab], minlength=size)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        # the trapezoid rule over thresholds, from the highest down
        tpr = np.cumsum(self._stat_pos[::-1]) / tot_pos
        fpr = np.cumsum(self._stat_neg[::-1]) / tot_neg
        return float(np.trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows of ``input`` [N, C] whose ``k`` highest entries
    hold the row's ``label``."""
    pred = _np(input)
    lab = _np(label).reshape(-1)
    topk = np.argsort(-pred, axis=-1)[:, :k]
    hit = (topk == lab[:, None]).any(axis=1)
    value = torch.tensor(hit.mean(), dtype=torch.float32)
    src = getattr(input, "_value", input)
    if torch.is_tensor(src):
        value = value.to(src.device)
    if src is not input:
        from ..tensor import Tensor
        return Tensor._wrap(value)
    return value


__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]
