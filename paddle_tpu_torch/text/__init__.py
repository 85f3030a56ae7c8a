from .gpt import (GPTConfig, GPTForPretraining, GPTModel, gpt3_6_7b,
                  gpt_large, gpt_medium, gpt_small)

__all__ = ["GPTConfig", "GPTModel", "GPTForPretraining", "gpt_small",
           "gpt_medium", "gpt_large", "gpt3_6_7b"]
