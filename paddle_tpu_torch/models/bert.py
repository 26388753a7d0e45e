"""BERT encoder for pretraining.

Counterpart of ``paddle_tpu.models.bert``: word + position (+ token
type) embeddings with LayerNorm eps 1e-12, a post-norm
``TransformerEncoder`` whose self-attention routes through
``kernels.maybe_flash_attention`` (the flash kernels in training at
sequence length >= ``flash_attention_min_seq_train``), a tanh pooler,
and the pretraining heads: a GELU transform, LayerNorm eps 1e-12, the
MLM decoder tied to the word embedding plus ``cls.decoder_bias``, and
the NSP classifier. With the ``fused_softmax_xent`` flag the MLM head
returns ``MLMHeadOutput`` (its hidden states, the tied weight and the
bias) instead of logits, and ``pretraining_loss`` runs the fused
projection + cross-entropy (``kernels.maybe_fused_linear_xent``), so the
``[B, T, V]`` logits never exist. ``attention_mask`` ``[B, T]`` (1
keeps) becomes the additive ``[B, 1, 1, T]`` mask
``(1 - m) * finfo(f32).min``, which the flash route turns into its key
bias. ``masked_positions`` ``[B, P]`` restricts the MLM head to those
positions.

Models and their parts build on ``device`` (None means ``cuda``, which
raises without a GPU; pass ``device="cpu"`` for the CPU); the whole model
draws its weights from ``seed``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from .. import kernels
from ..core.place import resolve_device
from ..nn import (GELU, Dropout, Embedding, LayerNorm, Linear, Tanh,
                  TransformerEncoder, TransformerEncoderLayer)
from ..ops import loss as L

__all__ = ["BertConfig", "BertEmbeddings", "BertModel",
           "BertPretrainingHeads", "BertForPretraining", "MLMHeadOutput",
           "pretraining_loss", "bert_base_config", "bert_large_config"]


class MLMHeadOutput(NamedTuple):
    """The fused MLM head's handoff to the loss (``fused_softmax_xent``):
    the transformed hidden states, the tied decoder weight and its bias
    in place of the ``[B, P, V]`` logits."""
    hidden: torch.Tensor
    weight: torch.Tensor
    bias: torch.Tensor


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2


def bert_base_config() -> BertConfig:
    return BertConfig()


def bert_large_config() -> BertConfig:
    return BertConfig(hidden_size=1024, num_hidden_layers=24,
                      num_attention_heads=16, intermediate_size=4096)


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.word_embeddings = Embedding(config.vocab_size,
                                         config.hidden_size, **kw)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, config.hidden_size, **kw)
        self.token_type_embeddings = Embedding(config.type_vocab_size,
                                               config.hidden_size, **kw)
        self.layer_norm = LayerNorm(config.hidden_size, epsilon=1e-12,
                                    device=device)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        pos_ids = torch.arange(input_ids.shape[1],
                               device=input_ids.device)[None, :]
        emb = self.word_embeddings(input_ids) \
            + self.position_embeddings(pos_ids)
        if token_type_ids is not None:
            emb = emb + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(emb))


class BertModel(nn.Module):
    def __init__(self, config: Optional[BertConfig] = None, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.config = config = config or BertConfig()
        kw = dict(device=resolve_device(device), generator=generator)
        self.embeddings = BertEmbeddings(config, **kw)
        self.encoder = TransformerEncoder(
            lambda: TransformerEncoderLayer(
                d_model=config.hidden_size,
                nhead=config.num_attention_heads,
                dim_feedforward=config.intermediate_size,
                dropout=config.hidden_dropout_prob,
                activation=config.hidden_act,
                attn_dropout=config.attention_probs_dropout_prob, **kw),
            config.num_hidden_layers)
        self.pooler = Linear(config.hidden_size, config.hidden_size, **kw)
        self.pooler_act = Tanh()

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        emb = self.embeddings(input_ids, token_type_ids)
        mask = None
        if attention_mask is not None:
            # [B, T] keep-mask -> additive [B, 1, 1, T]
            mask = (1.0 - attention_mask[:, None, None, :].to(emb.dtype)) \
                * torch.finfo(torch.float32).min
        seq_out = self.encoder(emb, src_mask=mask)
        pooled = self.pooler_act(self.pooler(seq_out[:, 0]))
        return seq_out, pooled


class BertPretrainingHeads(nn.Module):
    def __init__(self, config: BertConfig, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.transform = Linear(config.hidden_size, config.hidden_size,
                                **kw)
        self.transform_act = GELU()
        self.transform_norm = LayerNorm(config.hidden_size, epsilon=1e-12,
                                        device=device)
        self.decoder_bias = nn.Parameter(torch.zeros(
            config.vocab_size, dtype=torch.float32, device=device))
        self.seq_relationship = Linear(config.hidden_size, 2, **kw)

    def forward(self, sequence_output: torch.Tensor,
                pooled_output: torch.Tensor,
                word_embedding_weight: torch.Tensor) -> tuple:
        """(MLM logits, or ``MLMHeadOutput`` under the
        ``fused_softmax_xent`` flag; NSP logits)."""
        h = self.transform_norm(self.transform_act(
            self.transform(sequence_output)))
        nsp_logits = self.seq_relationship(pooled_output)
        if kernels.fused_softmax_xent_enabled():
            return MLMHeadOutput(h, word_embedding_weight,
                                 self.decoder_bias), nsp_logits
        mlm_logits = h @ word_embedding_weight.T + self.decoder_bias
        return mlm_logits, nsp_logits


class BertForPretraining(nn.Module):
    """MLM + NSP pretraining model. ``device`` None means ``cuda``."""

    def __init__(self, config: Optional[BertConfig] = None, device=None,
                 seed: int = 0) -> None:
        super().__init__()
        self.config = config = config or BertConfig()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        self.bert = BertModel(config, device=dev, generator=gen)
        self.cls = BertPretrainingHeads(config, device=dev, generator=gen)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                masked_positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``masked_positions`` [B, P] (per-row indices into the time
        axis) restricts the MLM head to those tokens: mlm_logits is then
        [B, P, V] and the MLM labels must be gathered the same way."""
        seq_out, pooled = self.bert(input_ids, token_type_ids,
                                    attention_mask)
        if masked_positions is not None:
            idx = masked_positions.long()[:, :, None].expand(
                -1, -1, seq_out.shape[-1])
            seq_out = torch.gather(seq_out, 1, idx)
        return self.cls(seq_out, pooled,
                        self.bert.embeddings.word_embeddings.weight)


def pretraining_loss(outputs, mlm_labels: torch.Tensor,
                     nsp_labels: torch.Tensor,
                     ignore_index: int = -100) -> torch.Tensor:
    """Masked-LM + next-sentence loss, each a mean over every position
    (ignored MLM positions count as 0). An ``MLMHeadOutput`` takes the
    fused projection + cross-entropy."""
    mlm_logits, nsp_logits = outputs
    if isinstance(mlm_logits, MLMHeadOutput):
        mlm = kernels.maybe_fused_linear_xent(
            *mlm_logits, mlm_labels, ignore_index=ignore_index).mean()
    else:
        mlm = L.cross_entropy(mlm_logits, mlm_labels,
                              ignore_index=ignore_index, reduction="mean")
    nsp = L.cross_entropy(nsp_logits, nsp_labels, reduction="mean")
    return mlm + nsp
