"""Weight-decay regularizers (counterpart: ``paddle_tpu/regularizer.py``):
``L2Decay`` and ``L1Decay``, holders of a coefficient that an
optimizer's ``weight_decay`` accepts in place of a float. As in the
reference, ``L1Decay`` decays as ``L2Decay`` does (``g + coeff * p``):
the optimizers implement that one form."""
from __future__ import annotations


class L2Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)
        self.coeff = self._coeff

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self._coeff})"


class L1Decay(L2Decay):
    """Applied as ``L2Decay`` (see the module's docstring)."""
