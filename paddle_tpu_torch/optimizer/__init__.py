from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW"]
