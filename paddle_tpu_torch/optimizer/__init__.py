from . import lr
from .lbfgs import LBFGS
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "LBFGS", "lr"]
