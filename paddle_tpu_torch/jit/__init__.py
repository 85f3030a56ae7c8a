from .api import (to_static, save, load, not_to_static, ignore_module,
                  enable_static, disable_static, in_dynamic_mode, InputSpec,
                  TranslatedLayer, StaticFunction)
from .trace import TracedFunction
from .train_step import CompiledTrainStep

__all__ = ["to_static", "save", "load", "not_to_static", "ignore_module",
           "enable_static", "disable_static", "in_dynamic_mode", "InputSpec",
           "TranslatedLayer", "StaticFunction", "TracedFunction",
           "CompiledTrainStep"]
