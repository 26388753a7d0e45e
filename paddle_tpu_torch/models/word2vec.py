"""The word2vec models (ref: the book's test_word2vec.py N-gram LM, and
the NCE skip-gram its ``nce`` layer exists for, ``nce_op.cc``).

Counterparts of ``paddle_tpu.models.word2vec``'s ``NGramLM`` and
``SkipGramNCE``, with the JAX models' parameter names
(``convert.load_jax_params``). The NCE negatives are drawn on the
device from the ``random`` stream (``ops.sampling``). Weights are
drawn on ``device`` (None: the card) from a generator seeded with
``seed``; the output table starts at zero, as there.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.place import resolve_device
from ..nn.layer import Layer
from ..nn.layers import Embedding, Linear
from ..ops.loss import cross_entropy
from ..ops.sampling import nce_loss

__all__ = ["NGramLM", "SkipGramNCE"]


def _kw(device, seed: int) -> dict:
    dev = resolve_device(device)
    return dict(device=dev, generator=torch.Generator(
        device=dev).manual_seed(int(seed)))


class NGramLM(Layer):
    """``context`` concatenated word embeddings -> hidden (ReLU) ->
    logits over the vocabulary."""

    def __init__(self, vocab_size: int, embed_dim: int = 32,
                 context: int = 4, hidden: int = 256, device=None,
                 seed: int = 0):
        super().__init__()
        kw = _kw(device, seed)
        self.embed = Embedding(vocab_size, embed_dim, **kw)
        self.fc1 = Linear(context * embed_dim, hidden, **kw)
        self.fc2 = Linear(hidden, vocab_size, **kw)
        self.context = context

    def forward(self, words):
        """words [B, context] -> logits [B, vocab]."""
        e = self.embed(words)
        return self.fc2(torch.relu(self.fc1(e.reshape(e.shape[0], -1))))

    def loss(self, words, next_word):
        return cross_entropy(self.forward(words), next_word)


class SkipGramNCE(Layer):
    """Skip-gram trained by noise-contrastive estimation against
    log-uniform noise: no softmax over the vocabulary."""

    def __init__(self, vocab_size: int, embed_dim: int = 64,
                 num_neg: int = 8, device=None, seed: int = 0):
        super().__init__()
        kw = _kw(device, seed)
        self.in_embed = Embedding(vocab_size, embed_dim, **kw)
        self.out_weight = nn.Parameter(torch.zeros(
            (vocab_size, embed_dim), device=kw["device"]))
        self.vocab_size = vocab_size
        self.num_neg = num_neg

    def forward(self, center):
        return self.in_embed(center)

    def loss(self, center, context):
        """center, context: [B] ids; the mean NCE loss."""
        return torch.mean(nce_loss(
            self.in_embed(center), self.out_weight, context,
            num_total_classes=self.vocab_size,
            num_neg_samples=self.num_neg, sampler="log_uniform"))

    def similarity(self, a, b):
        ea, eb = self.in_embed(a), self.in_embed(b)
        na = ea / torch.linalg.vector_norm(ea, dim=-1, keepdim=True)
        nb = eb / torch.linalg.vector_norm(eb, dim=-1, keepdim=True)
        return torch.sum(na * nb, dim=-1)
