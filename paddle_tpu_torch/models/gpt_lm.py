"""GPT-style decoder-only language model with KV-cached generation.

Counterpart of ``paddle_tpu.models.gpt_lm``: the GPT-2 block (pre-LN,
fused QKV projection with bias, exact-GELU MLP, learned positions, output
head tied to the token embedding). ``forward_with_attn`` takes the
attention as a callback ``attn_fn(layer_idx, q, k, v) -> context`` with
q/k/v in ``[B, T, H, Dh]``: ``forward`` passes dense causal attention,
the serving engine passes a closure over its paged KV pools, so the model
is the same in both. ``generate()`` is the self-contained loop on a dense
concat cache that the engine's output is held against.

Parameter names and shapes match the JAX model's ``param_dict()``
(``blocks.3.qkv.weight`` is ``[hidden, 3 * hidden]``), so its weights load
through ``paddle_tpu_torch.convert``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch
from torch import nn

from ..core.place import resolve_device
from ..nn import GELU, Embedding, LayerNorm, Linear

__all__ = ["GPTConfig", "GPTBlock", "GPTLanguageModel",
           "dense_causal_attention"]

AttnFn = Callable[[int, torch.Tensor, torch.Tensor, torch.Tensor],
                  torch.Tensor]


@dataclass
class GPTConfig:
    vocab_size: int = 256
    hidden_size: int = 128
    num_layers: int = 2
    num_heads: int = 4
    intermediate_size: int = 512
    max_position_embeddings: int = 1024
    layer_norm_epsilon: float = 1e-5


def dense_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, q_offset: int = 0
                           ) -> torch.Tensor:
    """Plain causal softmax attention, ``[B, T, H, Dh]`` layout, fp32
    math. ``q_offset`` is the absolute position of q's first token in
    k/v's timeline: query i attends keys [0, q_offset + i] (bottom-right
    aligned for a cached step, which SDPA's ``is_causal`` is not)."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(d)
    q_pos = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
    k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
    s = s.masked_fill(~(k_pos <= q_pos)[None, None], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        h = config.hidden_size
        eps = config.layer_norm_epsilon
        kw = dict(device=device, generator=generator)
        self.ln_1 = LayerNorm(h, epsilon=eps, device=device)
        self.qkv = Linear(h, 3 * h, **kw)
        self.out_proj = Linear(h, h, **kw)
        self.ln_2 = LayerNorm(h, epsilon=eps, device=device)
        self.fc_in = Linear(h, config.intermediate_size, **kw)
        self.act = GELU()
        self.fc_out = Linear(config.intermediate_size, h, **kw)
        self._heads = config.num_heads
        self._head_dim = h // config.num_heads

    def forward(self, x: torch.Tensor, layer_idx: int,
                attn_fn: AttnFn) -> torch.Tensor:
        b, t, h = x.shape
        qkv = self.qkv(self.ln_1(x)).reshape(b, t, 3, self._heads,
                                             self._head_dim)
        ctx = attn_fn(layer_idx, qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        x = x + self.out_proj(ctx.reshape(b, t, h))
        return x + self.fc_out(self.act(self.fc_in(self.ln_2(x))))


class GPTLanguageModel(nn.Module):
    """``device`` None means ``cuda`` (raises without a GPU); pass
    ``device="cpu"`` to run on the CPU. Weights are initialised from
    ``seed`` through an explicit ``torch.Generator`` on that device."""

    def __init__(self, config: Optional[GPTConfig] = None, device=None,
                 seed: int = 0) -> None:
        super().__init__()
        self.config = cfg = config or GPTConfig()
        if cfg.hidden_size % cfg.num_heads != 0:
            raise ValueError("hidden_size must divide num_heads")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        self.embed = Embedding(cfg.vocab_size, cfg.hidden_size,
                               device=dev, generator=gen)
        self.pos_embed = Embedding(cfg.max_position_embeddings,
                                   cfg.hidden_size, device=dev,
                                   generator=gen)
        self.blocks = nn.ModuleList(
            [GPTBlock(cfg, device=dev, generator=gen)
             for _ in range(cfg.num_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size,
                              epsilon=cfg.layer_norm_epsilon, device=dev)
        self.requires_grad_(False)  # inference model: no autograd graph

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def forward_with_attn(self, ids: torch.Tensor, positions: torch.Tensor,
                          attn_fn: AttnFn) -> torch.Tensor:
        """ids [B, T] int, positions [B, T] int (absolute positions);
        attention is whatever ``attn_fn`` computes over the projected
        q/k/v. Returns logits [B, T, V] (head tied to the embedding)."""
        h = self.embed(ids) + self.pos_embed(positions)
        for i, blk in enumerate(self.blocks):
            h = blk(h, i, attn_fn)
        h = self.ln_f(h)
        return h @ self.embed.weight.T

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """Dense causal forward: ids [B, T] -> logits [B, T, V]."""
        b, t = ids.shape
        pos = torch.arange(t, device=ids.device).expand(b, t)
        return self.forward_with_attn(
            ids, pos, lambda i, q, k, v: dense_causal_attention(q, k, v))

    @torch.no_grad()
    def generate(self, ids, max_new_tokens: int = 16,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0, seed: int = 0) -> torch.Tensor:
        """KV-cached generation on a dense concat cache. ids [B, T]
        prompt -> [B, <=max_new_tokens] generated ids per row (stops
        early only when every row has emitted eos; finished rows are
        padded with eos). Greedy at temperature 0, else temperature
        sampling from a generator seeded with ``seed``."""
        ids = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        b, t = ids.shape
        caches: List[Optional[tuple]] = [None] * len(self.blocks)

        def attn_fn(i, q, k, v):
            if caches[i] is not None:
                k = torch.cat([caches[i][0], k], dim=1)
                v = torch.cat([caches[i][1], v], dim=1)
            caches[i] = (k, v)
            return dense_causal_attention(q, k, v,
                                          q_offset=k.shape[1] - q.shape[1])

        pos = torch.arange(t, device=self.device).expand(b, t)
        logits = self.forward_with_attn(ids, pos, attn_fn)[:, -1]
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        out: List[torch.Tensor] = []
        done = torch.zeros(b, dtype=torch.bool, device=self.device)
        for step in range(max_new_tokens):
            if temperature > 0.0:
                # Gumbel-max: a draw from softmax(logits / T), on the device
                u = torch.rand(logits.shape, device=self.device,
                               generator=gen)
                nxt = torch.argmax(logits.float() / temperature
                                   - torch.log(-torch.log(u)), dim=-1)
            else:
                nxt = torch.argmax(logits, dim=-1)
            if eos_token_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, eos_token_id),
                                  nxt)
                done = done | (nxt == eos_token_id)
            out.append(nxt)
            if eos_token_id is not None and bool(done.all()):
                break
            p = torch.full((b, 1), t + step, dtype=torch.long,
                           device=self.device)
            logits = self.forward_with_attn(nxt[:, None], p, attn_fn)[:, -1]
        return torch.stack(out, dim=1)
