"""Transformer-XL language model: segment-level recurrence and relative
positional attention (Dai et al. 2019).

Counterpart of ``paddle_tpu.models.transformer_xl``:
``TransformerXLConfig``, ``_rel_shift``, ``RelMultiHeadAttention``,
``TransformerXLLayer``, ``TransformerXL`` and ``TransformerXLTrainStep``,
with the JAX models' parameter names (``convert.load_jax_params``).
Weights are drawn on ``device`` (None: the card) from a generator seeded
with ``seed``.

- Relative attention is the two-term (content / position) decomposition
  with the pad, reshape and drop shift of the paper's appendix B
  (:func:`_rel_shift`); the sinusoid over the relative distances is
  formed once per length on the host in fp32 (numpy) and kept on the
  device, so the card and the CPU read the same table.
- Memories start EMPTY: fixed-shape zero buffers and ``valid``, a device
  int counter of the real (rightmost) slots. The mask is causal over the
  concatenated timeline and excludes the empty slots, reading ``valid``
  as a tensor. A layer's new memory is its INPUT concatenated after the
  old memory, the last ``mem_len`` positions, detached; ``valid`` becomes
  ``min(mem_len, valid + t)``.
- The softmax is tied (``h @ embed.weight.T``) and the loss is Paddle's
  ``cross_entropy`` (``"mean"``).

``TransformerXLTrainStep`` is ``static.TrainStep`` over the model with
the memories and ``valid`` in fixed buffers that the step writes IN
PLACE: on the card one CUDA graph per input signature, each replay
reading and rewriting the same buffers (the JAX step carries them in its
donated state); ``reset_mems`` zeroes them in place and keeps the
graphs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.place import resolve_device
from ..nn.layer import Layer, LayerList
from ..nn.layers import Dropout, Embedding, LayerNorm, Linear
from ..ops.activation import gelu
from ..ops.loss import cross_entropy
from ..static import TrainStep

__all__ = ["TransformerXLConfig", "RelMultiHeadAttention",
           "TransformerXLLayer", "TransformerXL", "TransformerXLTrainStep"]


@dataclass
class TransformerXLConfig:
    vocab_size: int = 1000
    d_model: int = 128
    n_heads: int = 4
    d_ff: int = 512
    n_layers: int = 4
    mem_len: int = 64
    dropout: float = 0.1


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, Tq, Tk]`` position-logit shift (Dai et al. appendix B):
    pad one column, reshape, drop; aligns logit (i, j) to relative
    distance i - j (where the mask lets it through)."""
    b, h, tq, tk = x.shape
    x = torch.nn.functional.pad(x, (1, 0))
    x = x.reshape(b, h, tk + 1, tq)
    return x[:, :, 1:].reshape(b, h, tq, tk)


def _kw(device, generator):
    return dict(device=device, generator=generator)


class RelMultiHeadAttention(Layer):
    def __init__(self, d_model: int, n_heads: int, dropout: float,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = _kw(device, generator)
        self.n_heads = n_heads
        self.d_head = d_model // n_heads
        self.q = Linear(d_model, d_model, bias_attr=False, **kw)
        self.kv = Linear(d_model, 2 * d_model, bias_attr=False, **kw)
        self.r = Linear(d_model, d_model, bias_attr=False, **kw)
        self.out = Linear(d_model, d_model, bias_attr=False, **kw)
        # global content / position biases (u, v in the paper)
        self.u = torch.nn.Parameter(torch.zeros((n_heads, self.d_head),
                                                device=device))
        self.v = torch.nn.Parameter(torch.zeros((n_heads, self.d_head),
                                                device=device))
        self.dropout = Dropout(dropout)

    def forward(self, x, ctx, mem_valid, rel_emb):
        """x ``[B, T, D]``; ctx ``[B, M + T, D]`` = concat(memory, x);
        ``mem_valid``: the count of REAL memory slots (rightmost, a device
        int tensor): an empty slot gets no softmax mass, which the content
        term alone cannot prevent (the position logits ``(q + v) . r`` are
        nonzero there); rel_emb ``[M + T, D]`` (distance M + T - 1 .. 0)."""
        b, t, d = x.shape
        m = ctx.shape[1] - t
        h, dh = self.n_heads, self.d_head
        q = self.q(x).reshape(b, t, h, dh)
        kv = self.kv(ctx).reshape(b, m + t, 2, h, dh)
        k, v_ = kv[:, :, 0], kv[:, :, 1]
        r = self.r(rel_emb).reshape(m + t, h, dh)
        # content logits (q + u) . k; position logits (q + v) . r, shifted
        ac = torch.einsum("bthd,bshd->bhts", q + self.u, k)
        bd = _rel_shift(torch.einsum("bthd,shd->bhts", q + self.v, r))
        logits = (ac + bd) / (dh ** 0.5)
        pos_k = torch.arange(m + t, device=x.device)[None, :]
        pos_q = (m + torch.arange(t, device=x.device))[:, None]
        mask = (pos_k <= pos_q) & (pos_k >= m - mem_valid)
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
        w = self.dropout(torch.softmax(logits, dim=-1))
        o = torch.einsum("bhts,bshd->bthd", w, v_).reshape(b, t, d)
        return self.out(o)


class TransformerXLLayer(Layer):
    def __init__(self, cfg: TransformerXLConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = _kw(device, generator)
        self.attn = RelMultiHeadAttention(cfg.d_model, cfg.n_heads,
                                          cfg.dropout, **kw)
        self.ln1 = LayerNorm(cfg.d_model, device=device)
        self.ff1 = Linear(cfg.d_model, cfg.d_ff, **kw)
        self.ff2 = Linear(cfg.d_ff, cfg.d_model, **kw)
        self.ln2 = LayerNorm(cfg.d_model, device=device)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x, ctx, mem_valid, rel_emb):
        h = self.ln1(x + self.dropout(self.attn(x, ctx, mem_valid,
                                                rel_emb)))
        ff = self.ff2(gelu(self.ff1(h)))
        return self.ln2(h + self.dropout(ff))


class TransformerXL(Layer):
    """LM head and stack; ``forward(ids, mems)`` returns ``(logits,
    new_mems)``, the new memories detached (the paper's stop-gradient
    across segments)."""

    def __init__(self, cfg: TransformerXLConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, device=device,
                               generator=gen)
        self.layers = LayerList([TransformerXLLayer(cfg, device, gen)
                                 for _ in range(cfg.n_layers)])
        self.drop = Dropout(cfg.dropout)
        self._rel: Dict[tuple, torch.Tensor] = {}

    def init_mems(self, batch_size: int, device=None) -> dict:
        """Memories start EMPTY: zero buffers and a zero ``valid``
        counter (a growing memory becomes a mask over fixed shapes)."""
        dev = self.embed.weight.device if device is None else \
            torch.device(device)
        return {"layers": [torch.zeros((batch_size, self.cfg.mem_len,
                                        self.cfg.d_model), device=dev)
                           for _ in self.layers],
                "valid": torch.zeros((), dtype=torch.int32, device=dev)}

    def _rel_emb(self, length: int, device) -> torch.Tensor:
        """The sinusoid over relative distances ``length - 1 .. 0``,
        formed in fp32 on the host once per length and device (a capture
        reads the kept copy)."""
        key = (length, str(device))
        if key not in self._rel:
            pos = np.arange(length - 1, -1, -1, dtype=np.float32)
            half = self.cfg.d_model // 2
            inv = np.float32(1.0) / (np.float32(10000.0) ** (
                np.arange(half, dtype=np.float32) / np.float32(half)))
            ang = pos[:, None] * inv[None, :]
            table = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
            self._rel[key] = torch.from_numpy(table).to(device)
        return self._rel[key]

    def forward(self, ids, mems: Optional[dict] = None):
        b, t = ids.shape
        if mems is None:
            mems = self.init_mems(b, ids.device)
        valid = mems["valid"]
        h = self.drop(self.embed(ids))
        rel = self._rel_emb(self.cfg.mem_len + t, ids.device)
        new_layers: List[torch.Tensor] = []
        for layer, mem in zip(self.layers, mems["layers"]):
            # the memory takes the layer's INPUT, detached across segments
            cat = torch.cat([mem, h], dim=1)
            new_layers.append(cat[:, -self.cfg.mem_len:].detach())
            h = layer(h, cat, valid, rel)
        logits = h @ self.embed.weight.t()  # tied softmax
        new_mems = {"layers": new_layers,
                    "valid": torch.clamp(valid + t, max=self.cfg.mem_len)}
        return logits, new_mems

    def loss(self, ids, target, mems: Optional[dict] = None):
        logits, new_mems = self.forward(ids, mems)
        return cross_entropy(logits.reshape(-1, self.cfg.vocab_size),
                             target.reshape(-1)), new_mems


class TransformerXLTrainStep(TrainStep):
    """The segment-recurrent train step: ``step(ids, target)`` runs one
    segment, updates the model and rewrites ``mems`` (the per-layer
    memories and ``valid``) in place; returns ``{"loss": ...}``. On the
    card it is captured (see the module note)."""

    def __init__(self, model: TransformerXL, optimizer, batch_size: int,
                 seed: int = 0, compiled: Optional[bool] = None) -> None:
        vocab = model.cfg.vocab_size
        super().__init__(model, optimizer,
                         lambda logits, target: cross_entropy(
                             logits.reshape(-1, vocab), target.reshape(-1)),
                         seed=seed, compiled=compiled)
        self.batch_size = batch_size
        self.mems = model.init_mems(batch_size, self.device)

    def _call_model(self, args, kwargs):
        logits, new = self.model(args[0], self.mems)
        with torch.no_grad():
            for dst, src in zip(self.mems["layers"], new["layers"]):
                dst.copy_(src)
            self.mems["valid"].copy_(new["valid"])
        return logits

    def __call__(self, ids, target):
        return super().__call__(ids, labels=(target,))

    def reset_mems(self, batch_size: int) -> None:
        """Empties the memories: zeroes the buffers in place (the captured
        graphs stay valid); a new batch size makes new buffers, and the
        graphs of the old ones are dropped."""
        if batch_size == self.batch_size:
            with torch.no_grad():
                for m in self.mems["layers"]:
                    m.zero_()
                self.mems["valid"].zero_()
            return
        self.batch_size = batch_size
        self.mems = self.model.init_mems(batch_size, self.device)
        self._graphs.clear()
