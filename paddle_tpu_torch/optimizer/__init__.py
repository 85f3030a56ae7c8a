from .optimizer import SGD, Adam, AdamW, Optimizer

__all__ = ["Optimizer", "SGD", "Adam", "AdamW"]
