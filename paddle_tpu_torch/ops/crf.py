"""Linear-chain CRF ops.

Counterpart of ``paddle_tpu.ops.crf`` (the reference's
``linear_chain_crf_op.cc``, ``crf_decoding_op.cc``, ``chunk_eval_op.cc``)
over the dense padded ``[B, T, ...]`` + lengths layout: the time
recursions are Python loops over the static steps, vectorised over the
batch and the tags, with gradients by autograd.

The transition parameter has the reference's layout, ``[D + 2, D]``:
row 0 the start scores, row 1 the end scores, rows 2.. the square
tag-to-tag matrix ``a[i][j]`` scoring tag ``i`` -> tag ``j``. Tags out
of ``crf_decoding`` are int64 (the JAX package: int32); ``chunk_eval``'s
counts are int64 0-d tensors.
"""

from __future__ import annotations

import torch

from ._common import as_tensor

__all__ = ["linear_chain_crf", "crf_decoding", "chunk_eval"]


def _split_transition(transition):
    transition = transition.to(torch.float32)
    return transition[0], transition[1], transition[2:]


def _time_mask(t: int, length, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(t, device=like.device)[None, :] \
        < as_tensor(length, like=like).reshape(-1, 1)


def linear_chain_crf(emission, transition, label, length):
    """Negative log-likelihood of the tag sequences (ref:
    linear_chain_crf_op.cc): emission ``[B, T, D]``, transition ``[D+2,
    D]``, label ``[B, T]``, length ``[B]``; returns ``[B]``."""
    emission = emission.to(torch.float32)
    t = emission.shape[1]
    start, end, trans = _split_transition(transition)
    label = label.long()
    mask = _time_mask(t, length, emission)
    # the partition function: the alpha recursion in log space
    alpha = start[None, :] + emission[:, 0, :]
    for s in range(1, t):
        new = torch.logsumexp(alpha[:, :, None] + trans[None, :, :],
                              dim=1) + emission[:, s, :]
        alpha = torch.where(mask[:, s, None], new, alpha)
    log_z = torch.logsumexp(alpha + end[None, :], dim=1)
    # the gold path's score
    emit_gold = torch.gather(emission, 2, label[:, :, None])[..., 0]
    emit_score = torch.sum(emit_gold * mask, dim=1)
    trans_score = torch.sum(trans[label[:, :-1], label[:, 1:]]
                            * mask[:, 1:], dim=1)
    last = (as_tensor(length, like=label).long() - 1).clamp(min=0)
    last_tag = torch.gather(label, 1, last[:, None])[:, 0]
    gold = start[label[:, 0]] + emit_score + trans_score + end[last_tag]
    return log_z - gold


def crf_decoding(emission, transition, length):
    """Viterbi decoding (ref: crf_decoding_op.cc): the most likely tag
    path ``[B, T]``, 0 past ``length``. Ties go to the lowest tag, as
    ``jnp.argmax`` and ``torch.argmax`` both take the first maximum."""
    emission = emission.to(torch.float32)
    t, d = emission.shape[1], emission.shape[2]
    start, end, trans = _split_transition(transition)
    mask = _time_mask(t, length, emission)
    ident = torch.arange(d, device=emission.device)[None, :]
    v = start[None, :] + emission[:, 0, :]
    ptrs = []
    for s in range(1, t):
        scores = v[:, :, None] + trans[None, :, :]  # [B, i, j]
        best, best_prev = scores.amax(dim=1), scores.argmax(dim=1)
        active = mask[:, s, None]
        v = torch.where(active, best + emission[:, s, :], v)
        # an inactive step points at itself: backtracking is identity
        ptrs.append(torch.where(active, best_prev, ident))
    tag = torch.argmax(v + end[None, :], dim=1)
    path = [tag]
    for ptr in reversed(ptrs):
        tag = torch.gather(ptr, 1, tag[:, None])[:, 0]
        path.append(tag)
    path = torch.stack(path[::-1], dim=1)
    return torch.where(mask, path, torch.zeros_like(path))


def _shift(x, fill, forward: bool):
    """``x`` shifted one step along time: ``forward`` puts ``fill`` first
    (each position sees its predecessor), else last (its successor)."""
    pad = torch.full_like(x[:, :1], fill)
    return torch.cat([pad, x[:, :-1]], dim=1) if forward \
        else torch.cat([x[:, 1:], pad], dim=1)


def _chunk_starts_ends(tags, mask, num_chunk_types: int, scheme="IOB"):
    """Per position (is_chunk_start, is_chunk_end, chunk_type, valid) as
    ``chunk_eval_op.cc`` encodes the tags: IOB's B of type ``k`` is
    ``2k``, its I ``2k + 1``; a tag at or above ``2 * num_chunk_types``
    is outside."""
    if scheme not in ("IOB", "IOE"):
        raise ValueError(f"unsupported chunk scheme {scheme}")
    ctype = torch.div(tags, 2, rounding_mode="floor")
    valid = mask & (tags < num_chunk_types * 2)
    prev_valid, next_valid = _shift(valid, False, True), \
        _shift(valid, False, False)
    prev_type, next_type = _shift(ctype, -1, True), _shift(ctype, -1, False)
    if scheme == "IOB":
        starts = valid & ((tags % 2 == 0) | ~prev_valid
                          | (prev_type != ctype))
        next_inside = next_valid & (next_type == ctype) \
            & (_shift(tags, 0, False) % 2 == 1)
        ends = valid & ~next_inside
    else:
        ends = valid & ((tags % 2 == 1) | ~next_valid
                        | (next_type != ctype))
        prev_inside = prev_valid & (prev_type == ctype) \
            & (_shift(tags, 0, True) % 2 == 0)
        starts = valid & ~prev_inside
    return starts, ends, ctype, valid


def chunk_eval(inference, label, length, num_chunk_types,
               chunk_scheme: str = "IOB"):
    """Chunk-level counts and scores (ref: chunk_eval_op.cc): a dict of
    num_infer_chunks, num_label_chunks, num_correct_chunks, precision,
    recall, f1. A chunk is correct when its start, end and type agree
    (the realised tags may differ)."""
    inference = inference.long()
    label = label.long()
    t = inference.shape[1]
    mask = _time_mask(t, length, inference)
    i_s, i_e, i_t, i_v = _chunk_starts_ends(inference, mask,
                                            num_chunk_types, chunk_scheme)
    l_s, l_e, l_t, l_v = _chunk_starts_ends(label, mask, num_chunk_types,
                                            chunk_scheme)
    n_infer = i_s.sum()
    n_label = l_s.sum()
    same = i_v & l_v & (i_t == l_t) & (i_s == l_s) & (i_e == l_e)
    both_start, both_end = i_s & l_s, i_e & l_e
    ok = torch.zeros(inference.shape[0], dtype=torch.bool,
                     device=inference.device)
    n_correct = torch.zeros((), dtype=torch.int64, device=inference.device)
    for s in range(t):
        # a running flag: inside a chunk both agree on since its start
        ok = torch.where(both_start[:, s], same[:, s], ok & same[:, s])
        n_correct = n_correct + (ok & both_end[:, s]).sum()
    zero = torch.zeros((), dtype=torch.float32, device=inference.device)
    precision = torch.where(n_infer > 0, n_correct / n_infer.clamp(min=1),
                            zero)
    recall = torch.where(n_label > 0, n_correct / n_label.clamp(min=1),
                         zero)
    f1 = torch.where(precision + recall > 0, 2 * precision * recall
                     / (precision + recall).clamp(min=1e-12), zero)
    return {"num_infer_chunks": n_infer, "num_label_chunks": n_label,
            "num_correct_chunks": n_correct, "precision": precision,
            "recall": recall, "f1": f1}
