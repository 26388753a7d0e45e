"""Recommender models: the book's chapter-5 dual-tower rating network
(user and movie feature towers, a scaled cosine match) and DeepFM, the
CTR model of the sparse workload a parameter server exists for.

Counterpart of ``paddle_tpu.models.recommender``: ``_Tower``,
``RecommenderSystem`` and ``DeepFM``, with the JAX models' parameter names
(``convert.load_jax_params``). The categorical features are dense int
arrays; DeepFM's pairwise term is the ``((sum e)^2 - sum e^2) / 2``
identity, two reductions instead of an O(F^2) loop, and its loss is
``binary_cross_entropy_with_logits``. Weights are drawn on ``device``
(None: the card) from a generator seeded with ``seed``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.place import resolve_device
from ..nn.layer import Layer, LayerList
from ..nn.layers import Embedding, Linear, ReLU
from ..ops.loss import binary_cross_entropy_with_logits

__all__ = ["RecommenderSystem", "DeepFM"]


def _kw(device, seed: int) -> dict:
    dev = resolve_device(device)
    return dict(device=dev, generator=torch.Generator(
        device=dev).manual_seed(int(seed)))


class _Tower(Layer):
    def __init__(self, cat_cardinalities: Sequence[int], embed_dim: int,
                 hidden: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.embeds = LayerList([Embedding(c, embed_dim, **kw)
                                 for c in cat_cardinalities])
        self.fc = Linear(len(cat_cardinalities) * embed_dim, hidden, **kw)

    def forward(self, cats):
        """cats: ``[B, n_features]`` int ids."""
        es = [emb(cats[:, i]) for i, emb in enumerate(self.embeds)]
        return torch.tanh(self.fc(torch.cat(es, dim=-1)))


class RecommenderSystem(Layer):
    """Dual-tower rating model: user tower (id, gender, age, job) x movie
    tower (id, category) -> 5 x cosine -> rating. The defaults are
    MovieLens-1M's."""

    def __init__(self, n_users: int = 6041, n_genders: int = 2,
                 n_ages: int = 7, n_jobs: int = 21,
                 n_movies: int = 3953, n_categories: int = 19,
                 embed_dim: int = 32, hidden: int = 200, device=None,
                 seed: int = 0):
        super().__init__()
        kw = _kw(device, seed)
        self.user_tower = _Tower([n_users, n_genders, n_ages, n_jobs],
                                 embed_dim, hidden, **kw)
        self.movie_tower = _Tower([n_movies, n_categories], embed_dim,
                                  hidden, **kw)

    def forward(self, user_feats, movie_feats):
        u = self.user_tower(user_feats)
        m = self.movie_tower(movie_feats)
        un = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True)
        mn = m / torch.linalg.vector_norm(m, dim=-1, keepdim=True)
        return 5.0 * torch.sum(un * mn, dim=-1, keepdim=True)

    def loss(self, user_feats, movie_feats, rating):
        pred = self.forward(user_feats, movie_feats)
        return torch.mean((pred - rating) ** 2)


class DeepFM(Layer):
    """DeepFM: first-order + FM second-order + deep tower over shared
    field embeddings; ``forward(fields [B, F])`` -> logit ``[B, 1]``."""

    def __init__(self, field_cardinalities: Sequence[int],
                 embed_dim: int = 16, hidden: Sequence[int] = (64, 32),
                 device=None, seed: int = 0):
        super().__init__()
        kw = _kw(device, seed)
        self.first_order = LayerList([Embedding(c, 1, **kw)
                                      for c in field_cardinalities])
        self.embeds = LayerList([Embedding(c, embed_dim, **kw)
                                 for c in field_cardinalities])
        dims = [len(field_cardinalities) * embed_dim, *hidden]
        self.deep = LayerList([Linear(dims[i], dims[i + 1], **kw)
                               for i in range(len(hidden))])
        self.out = Linear(1 + 1 + dims[-1], 1, **kw)
        self.act = ReLU()  # the deep tower's (no parameters)

    def forward(self, fields):
        fo = sum(emb(fields[:, i])
                 for i, emb in enumerate(self.first_order))  # [B, 1]
        es = torch.stack([emb(fields[:, i])
                          for i, emb in enumerate(self.embeds)], dim=1)
        # FM pairwise: 0.5 ((sum_f e)^2 - sum_f e^2), summed over the dim
        s = torch.sum(es, dim=1)
        fm = 0.5 * torch.sum(s * s - torch.sum(es * es, dim=1), dim=-1,
                             keepdim=True)  # [B, 1]
        deep = es.reshape(es.shape[0], -1)
        for fc in self.deep:
            deep = self.act(fc(deep))
        return self.out(torch.cat([fo, fm, deep], dim=-1))

    def loss(self, fields, click):
        logit = self.forward(fields)[:, 0]
        return binary_cross_entropy_with_logits(
            logit, click.to(logit.dtype), reduction="mean")
