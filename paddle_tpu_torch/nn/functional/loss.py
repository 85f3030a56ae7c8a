"""Loss functionals (counterpart: ``paddle_tpu/nn/functional/loss.py``).

``cross_entropy`` over hard labels follows the reference's
``_ce_hard_impl`` step by step: labels are clipped into range before the
pick (an ignored or out-of-range label never indexes past the classes,
on the card either), the loss is logsumexp minus the picked logit, and
the mean divides by ``max(valid count, 1)``, so a batch whose labels are
all ignored gives 0 where ``torch.nn.functional.cross_entropy`` gives
NaN. With ``weight`` the mean divides by the picked weights' sum
instead. It computes in the logits' dtype; the port's models upcast
their logits to fp32 before calling it (``text/gpt.py``). It goes through
the per-op seam (``ops/dispatch.py``) as op "cross_entropy", which an
``auto_cast`` block runs in fp32 (the black list).
"""
from __future__ import annotations

import torch

from ...ops.dispatch import dispatch


def _ce_hard(logits, label, weight, axis, ignore_index, reduction,
             label_smoothing, use_softmax):
    clipped = label.clamp(0, logits.shape[axis] - 1)
    picked = logits.gather(axis, clipped.unsqueeze(axis)).squeeze(axis)
    if not use_softmax:
        # the input already holds probabilities
        logp_picked = picked.clamp(1e-12, 1.0).log()
        nll = -logp_picked
        if label_smoothing > 0.0:
            mean_logp = logits.clamp(1e-12, 1.0).log().mean(axis)
            nll = -((1.0 - label_smoothing) * logp_picked
                    + label_smoothing * mean_logp)
    else:
        lse = torch.logsumexp(logits, dim=axis)
        nll = lse - picked
        if label_smoothing > 0.0:
            nll = (lse - (1.0 - label_smoothing) * picked
                   - label_smoothing * logits.mean(axis))
    valid = label != ignore_index
    nll = torch.where(valid, nll, torch.zeros((), dtype=nll.dtype,
                                              device=nll.device))
    if weight is not None:
        w = weight.to(nll.dtype)[clipped]
        w = torch.where(valid, w, torch.zeros_like(w))
        nll = nll * w
        if reduction == "mean":
            return nll.sum() / w.sum().clamp_min(1e-12)
    if reduction == "mean":
        return nll.sum() / valid.sum().to(nll.dtype).clamp_min(1.0)
    return nll.sum() if reduction == "sum" else nll


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy of ``input`` (logits, or probabilities with
    ``use_softmax=False``) against integer class labels along ``axis``,
    with ``ignore_index``, per-class ``weight``, ``label_smoothing`` and
    ``reduction`` "mean", "sum" or "none". A label holding a size-1 class
    axis is squeezed first."""
    axis = axis % input.ndim
    if soft_label or (label.shape == input.shape
                      and label.is_floating_point()):
        raise NotImplementedError(
            "soft-label cross_entropy is not ported; it comes with a later "
            "slice of the port")
    if label.ndim == input.ndim and label.shape[axis] == 1:
        label = label.squeeze(axis)
    return dispatch("cross_entropy", _ce_hard, input, label, weight,
                    axis=axis, ignore_index=int(ignore_index),
                    reduction=reduction,
                    label_smoothing=float(label_smoothing),
                    use_softmax=bool(use_softmax))
