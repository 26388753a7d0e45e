"""Models of the PyTorch package."""

from .gpt_lm import (GPTBlock, GPTConfig, GPTLanguageModel,
                     dense_causal_attention)

__all__ = ["GPTConfig", "GPTBlock", "GPTLanguageModel",
           "dense_causal_attention"]
