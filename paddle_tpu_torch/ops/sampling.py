"""Sampled and tree-structured classifier ops.

Counterpart of ``paddle_tpu.ops.sampling`` (the reference's
``hierarchical_sigmoid_op.cc``, ``nce_op.cc``, ``math/matrix_bit_code.h``,
``math/sampler.cc``): the tree paths are dense int matrices, so a batch
is two gathers and one batched product, and the noise draws have a
fixed shape. The draws come from the ``random`` stream of the inputs'
device (``ops.random_ops``: the generator an ``rng_scope`` binds, else
that device's global one), or from ``key``; Philox's bits never match
the JAX package's threefry, so ``custom_neg_samples`` hands both the
same negatives. ``hash_bucket`` computes its 32-bit wraparound hash in
int64, masked to 32 bits after each product.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import random_ops as _random

__all__ = ["hash_bucket", "hsigmoid_loss", "nce_loss",
           "sampled_softmax_with_cross_entropy"]

_U32 = 0xFFFFFFFF


def _default_code(label, num_classes: int, depth: int):
    """Complete-binary-tree bit codes (ref: matrix_bit_code.h SimpleCode):
    the internal node ids, the bits (1 = right child) and the valid
    levels, leaf-ward."""
    code = label.long() + num_classes  # heap index
    levels = []
    for _ in range(depth):
        levels.append(code)
        code = torch.div(code, 2, rounding_mode="floor")
    codes = torch.stack(levels[::-1], dim=1)
    node = torch.div(codes, 2, rounding_mode="floor") - 1
    return (node.clamp(min=0), (codes % 2).to(torch.float32),
            (node >= 0).to(torch.float32))


def hsigmoid_loss(x, weight, label, num_classes: Optional[int] = None,
                  bias=None, path_table=None, path_code=None):
    """Hierarchical sigmoid loss (ref: hierarchical_sigmoid_op.cc): x
    ``[B, D]``, weight ``[num_nodes, D]``, label ``[B]``. The default tree
    is complete binary over ``num_classes``; a custom one passes
    ``path_table``/``path_code`` ``[B, L]`` (-1-padded). Returns ``[B]``."""
    if path_table is not None:
        node = path_table.long().clamp(min=0)
        bit = path_code.clamp(min=0).to(x.dtype)
        valid = (path_table >= 0).to(x.dtype)
    else:
        if num_classes is None:
            raise ValueError("num_classes required without path_table")
        depth = max(1, math.ceil(math.log2(max(num_classes, 2))))
        node, bit, valid = _default_code(label, num_classes, depth)
    logits = torch.einsum("bld,bd->bl", weight[node], x)
    if bias is not None:
        logits = logits + bias[node]
    # -log sigmoid(+-logit): bit 1 wants the logit high
    losses = torch.nn.functional.softplus(logits) - bit * logits
    return torch.sum(losses * valid, dim=1)


def _log_uniform_sample(shape, range_max: int, device, key=None):
    """Log-uniform (Zipf) candidates (ref: sampler.cc LogUniformSampler):
    P(c) = (log(c+2) - log(c+1)) / log(range_max+1)."""
    u = _random.uniform(shape, "float32", 0.0, 1.0, key=key, device=device)
    s = torch.exp(u * math.log(float(range_max + 1))) - 1.0
    return s.long().clamp(0, range_max - 1)


def _sampler_prob(ids, range_max: int, sampler: str):
    if sampler == "log_uniform":
        ids_f = ids.to(torch.float32)
        return (torch.log(ids_f + 2.0) - torch.log(ids_f + 1.0)) \
            / math.log(float(range_max + 1))
    return torch.full(ids.shape, 1.0 / range_max, device=ids.device)


def nce_loss(x, weight, label, num_total_classes: int,
             num_neg_samples: int = 10, bias=None,
             sampler: str = "uniform", custom_neg_samples=None, key=None):
    """Noise-contrastive estimation loss (ref: nce_op.cc): x ``[B, D]``,
    weight ``[num_total_classes, D]``, label ``[B]``; the true class
    against ``num_neg_samples`` noise draws per row (``[B, S]``, or the
    given ``custom_neg_samples`` ``[B, S]``/``[S]``), by binary logistic
    discrimination. Returns ``[B]``."""
    b = x.shape[0]
    if custom_neg_samples is not None:
        neg = custom_neg_samples
        if neg.ndim == 1:
            neg = neg[None, :].expand(b, neg.shape[0])
    elif sampler == "log_uniform":
        neg = _log_uniform_sample((b, num_neg_samples), num_total_classes,
                                  x.device, key)
    else:
        neg = _random.randint(0, num_total_classes, (b, num_neg_samples),
                              key=key, device=x.device)
    neg = neg.long()
    label = label.long().reshape(b)

    pos_logit = torch.einsum("bd,bd->b", weight[label], x)
    neg_logit = torch.einsum("bsd,bd->bs", weight[neg], x)
    if bias is not None:
        pos_logit = pos_logit + bias[label]
        neg_logit = neg_logit + bias[neg]
    k = float(num_neg_samples)
    # P(D=1 | c) = sigmoid(s(c) - log(k Pn(c)))
    pos_adj = pos_logit - torch.log(
        k * _sampler_prob(label, num_total_classes, sampler) + 1e-12)
    neg_adj = neg_logit - torch.log(
        k * _sampler_prob(neg, num_total_classes, sampler) + 1e-12)
    softplus = torch.nn.functional.softplus
    return softplus(-pos_adj) + torch.sum(softplus(neg_adj), dim=1)


def sampled_softmax_with_cross_entropy(x, weight, label,
                                       num_total_classes: int,
                                       num_samples: int = 100, bias=None,
                                       key=None):
    """Sampled-softmax cross-entropy over the true class and
    ``num_samples`` log-uniform draws (ref: sample_logits_op.cc with
    softmax_with_cross_entropy), log expected counts subtracted; a draw
    equal to the true class is masked out. Returns ``[B]``."""
    b = x.shape[0]
    neg = _log_uniform_sample((b, num_samples), num_total_classes,
                              x.device, key)
    ids = torch.cat([label.long().reshape(b, 1), neg], dim=1)
    logits = torch.einsum("bsd,bd->bs", weight[ids], x)
    if bias is not None:
        logits = logits + bias[ids]
    logits = logits - torch.log(
        _sampler_prob(ids, num_total_classes, "log_uniform") + 1e-12)
    dup = ids[:, 1:] == ids[:, :1]
    logits = torch.cat([logits[:, :1], torch.where(
        dup, -1e9, logits[:, 1:])], dim=1)
    return -torch.log_softmax(logits, dim=1)[:, 0]


def hash_bucket(ids, num_buckets: int, num_hash: int = 1,
                mod_by: int = 100000007):
    """(ref: hash_op.cc) int ids ``[..., 1]`` or ``[...]`` hashed into
    ``num_hash`` columns of bucket ids ``[..., num_hash]`` (int64; the
    JAX package: int32) by a 32-bit integer mix, one seed a column."""
    x = torch.as_tensor(ids)
    if x.ndim >= 2 and x.shape[-1] == 1:
        x = x[..., 0]
    x = x.long() & _U32

    def mix(v, seed: int):
        v = v ^ seed
        v = ((v ^ (v >> 16)) * 0x45D9F3B) & _U32
        v = ((v ^ (v >> 16)) * 0x45D9F3B) & _U32
        return v ^ (v >> 16)

    cols = [mix(x, (0x9E3779B9 + 0x85EBCA6B * k) & _U32) % mod_by
            % num_buckets for k in range(num_hash)]
    return torch.stack(cols, dim=-1)
