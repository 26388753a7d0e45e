"""The NLP models the LSTM and CRF ops exist for (ref: the book's
notest_understand_sentiment.py stacked-LSTM sentiment net and
test_label_semantic_roles.py BiLSTM + linear_chain_crf).

Counterparts of ``paddle_tpu.models.nlp``'s ``SentimentBiLSTM`` and
``SRLBiLSTMCRF``, dense padded sequences + lengths throughout, with the
JAX models' parameter names (``convert.load_jax_params``). Weights are
drawn on ``device`` (None: the card) from a generator seeded with
``seed``; the CRF transition starts at zero, as there.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.place import resolve_device
from ..nn.layer import Layer
from ..nn.layers import Embedding, Linear
from ..nn.rnn import LSTM
from ..ops.crf import crf_decoding, linear_chain_crf
from ..ops.loss import cross_entropy
from ..ops.sequence import sequence_mask

__all__ = ["SentimentBiLSTM", "SRLBiLSTMCRF"]


def _kw(device, seed: int) -> dict:
    dev = resolve_device(device)
    return dict(device=dev, generator=torch.Generator(
        device=dev).manual_seed(int(seed)))


class SentimentBiLSTM(Layer):
    """Embedding -> stacked bidirectional LSTM over the valid steps ->
    max over the valid steps -> linear classifier."""

    def __init__(self, vocab_size: int, embed_dim: int = 64,
                 hidden: int = 64, num_layers: int = 2,
                 num_classes: int = 2, pad_id: int = 0, device=None,
                 seed: int = 0):
        super().__init__()
        kw = _kw(device, seed)
        self.embed = Embedding(vocab_size, embed_dim, **kw)
        self.lstm = LSTM(embed_dim, hidden, num_layers=num_layers,
                         direction="bidirect", **kw)
        self.fc = Linear(2 * hidden, num_classes, **kw)
        self.pad_id = pad_id

    def forward(self, tokens, length=None):
        """tokens [B, T] (pad_id-padded) -> logits [B, num_classes]."""
        if length is None:
            length = (tokens != self.pad_id).sum(dim=1)
        out, _ = self.lstm(self.embed(tokens), sequence_length=length)
        mask = sequence_mask(length, tokens.shape[1])[:, :, None]
        pooled = torch.where(mask, out, float("-inf")).amax(dim=1)
        # an all-pad row pools to -inf: zero it, not NaN the batch loss
        pooled = torch.where(torch.isfinite(pooled), pooled, 0.0)
        return self.fc(pooled)

    def loss(self, tokens, labels, length=None):
        return cross_entropy(self.forward(tokens, length), labels)


class SRLBiLSTMCRF(Layer):
    """Word + predicate-mark embeddings -> stacked BiLSTM -> tag
    emissions -> linear-chain CRF (transition ``[D + 2, D]``: rows 0/1
    the start/end scores)."""

    def __init__(self, vocab_size: int, num_tags: int, embed_dim: int = 32,
                 hidden: int = 64, num_layers: int = 2, device=None,
                 seed: int = 0):
        super().__init__()
        kw = _kw(device, seed)
        self.word_embed = Embedding(vocab_size, embed_dim, **kw)
        self.mark_embed = Embedding(2, embed_dim // 2, **kw)
        self.lstm = LSTM(embed_dim + embed_dim // 2, hidden,
                         num_layers=num_layers, direction="bidirect", **kw)
        self.emission = Linear(2 * hidden, num_tags, **kw)
        self.transition = nn.Parameter(torch.zeros(
            (num_tags + 2, num_tags), device=kw["device"]))
        self.num_tags = num_tags

    def emissions(self, words, predicate_mark, length=None):
        h = torch.cat([self.word_embed(words),
                       self.mark_embed(predicate_mark)], dim=-1)
        out, _ = self.lstm(h, sequence_length=length)
        return self.emission(out)

    def loss(self, words, predicate_mark, tags, length):
        em = self.emissions(words, predicate_mark, length)
        return torch.mean(linear_chain_crf(em, self.transition, tags,
                                           length))

    def decode(self, words, predicate_mark, length):
        return crf_decoding(self.emissions(words, predicate_mark, length),
                            self.transition, length)
