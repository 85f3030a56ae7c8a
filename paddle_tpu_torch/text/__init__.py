from .bert import (BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel)
from .ernie import (ErnieConfig, ErnieForPretraining,
                    ErnieForSequenceClassification, ErnieModel)
from .gpt import (GPTConfig, GPTForPretraining, GPTModel, gpt3_6_7b,
                  gpt_large, gpt_medium, gpt_small)

__all__ = ["GPTConfig", "GPTModel", "GPTForPretraining", "gpt_small",
           "gpt_medium", "gpt_large", "gpt3_6_7b", "BertConfig", "BertModel",
           "BertForPretraining", "BertForSequenceClassification",
           "ErnieConfig", "ErnieModel", "ErnieForPretraining",
           "ErnieForSequenceClassification"]
