"""Models of the PyTorch package."""

from .bert import (BertConfig, BertForPretraining, BertModel,
                   MLMHeadOutput, pretraining_loss)
from .gpt_lm import (GPTBlock, GPTConfig, GPTLanguageModel,
                     dense_causal_attention)

__all__ = ["GPTConfig", "GPTBlock", "GPTLanguageModel",
           "dense_causal_attention", "BertConfig", "BertModel",
           "BertForPretraining", "MLMHeadOutput", "pretraining_loss"]
