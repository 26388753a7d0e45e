"""The LSTM language model (PTB-style).

Counterpart of ``paddle_tpu.models.lstm_lm``: ``LMConfig`` and
``LSTMLanguageModel`` (embedding, dropout, a stacked ``nn.LSTM`` with
dropout between its layers, dropout, then the vocabulary projection, or
the embedding's transpose with ``tie_weights``), with the JAX model's
parameter names, so its ``param_dict()`` loads by name
(``convert.load_jax_params``). Weights are drawn on ``device`` (None:
the card) from a generator seeded with ``seed``.

Zaremba, Sutskever & Vinyals' "large" PTB model (arXiv:1409.2329 §4.1)
is ``LMConfig(vocab_size=10000, hidden_size=1500, num_layers=2,
dropout=0.65, tie_weights=False)``, unrolled over 35 steps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..core.place import resolve_device
from ..nn.layer import Layer
from ..nn.layers import Dropout, Embedding, Linear
from ..nn.rnn import LSTM

__all__ = ["LMConfig", "LSTMLanguageModel"]


@dataclass
class LMConfig:
    vocab_size: int = 10000
    hidden_size: int = 200
    num_layers: int = 2
    dropout: float = 0.0
    tie_weights: bool = True


class LSTMLanguageModel(Layer):
    def __init__(self, config: Optional[LMConfig] = None, device=None,
                 seed: int = 0) -> None:
        super().__init__()
        self.config = cfg = config or LMConfig()
        dev = resolve_device(device)
        kw = dict(device=dev, generator=torch.Generator(
            device=dev).manual_seed(int(seed)))
        self.embed = Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.lstm = LSTM(cfg.hidden_size, cfg.hidden_size,
                         num_layers=cfg.num_layers, dropout=cfg.dropout,
                         **kw)
        self.dropout = Dropout(cfg.dropout)
        if not cfg.tie_weights:
            self.proj = Linear(cfg.hidden_size, cfg.vocab_size, **kw)

    def forward(self, ids, state=None):
        """ids [B, T] -> next-token logits [B, T, V]."""
        h = self.dropout(self.embed(ids))
        out, _ = self.lstm(h, state)
        out = self.dropout(out)
        if self.config.tie_weights:
            return out @ self.embed.weight.T
        return self.proj(out)
