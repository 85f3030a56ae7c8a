from .train_step import CompiledTrainStep

__all__ = ["CompiledTrainStep"]
