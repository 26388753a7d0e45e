"""Seq2seq decoding: the reference's RNNCell/Decoder family
(``fluid/layers/rnn.py``: Decoder, BasicDecoder, DecodeHelper,
TrainingHelper, GreedyEmbeddingHelper, SampleEmbeddingHelper,
BeamSearchDecoder, dynamic_decode).

Counterpart of ``paddle_tpu.nn.decode``: ``dynamic_decode`` runs all
``max_step_num`` steps (a static loop, as the JAX package's one scan)
with a ``finished`` mask; once a row has finished its state is frozen
(``impute_finished``) and its length stops growing. There is no early
exit on a host read, so a CUDA graph capture records the whole decode.
The cell protocol is ``cell(inputs, states) -> (outputs, new_states)``,
so ``nn.LSTMCell``/``nn.GRUCell`` plug in. ``BeamSearchDecoder`` runs
``ops.beam.beam_search``. ``SampleEmbeddingHelper`` draws from ``key``
(a generator, or an int seeding one) or the ``random`` stream of the
outputs' device; its bits differ from the JAX package's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core import random as _random
from ..ops.beam import beam_search

__all__ = ["Decoder", "BasicDecoder", "DecodeHelper", "TrainingHelper",
           "GreedyEmbeddingHelper", "SampleEmbeddingHelper",
           "BeamSearchDecoder", "dynamic_decode"]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, (tuple, list)):
        return type(a)(_map2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def _first_leaf(tree) -> torch.Tensor:
    if isinstance(tree, dict):
        return _first_leaf(next(iter(tree.values())))
    if isinstance(tree, (tuple, list)):
        return _first_leaf(tree[0])
    return tree


class DecodeHelper:
    """The sampling and feeding policy of a ``BasicDecoder``."""

    def initialize(self, batch_size: int):
        """(finished [B] bool, first inputs)."""
        raise NotImplementedError

    def sample(self, time: int, outputs):
        raise NotImplementedError

    def next_inputs(self, time: int, outputs, sample_ids):
        """(finished [B] bool, next inputs)."""
        raise NotImplementedError


class TrainingHelper(DecodeHelper):
    """Teacher forcing: feeds the given sequence, inputs ``[B, T, ...]``
    (``[T, B, ...]`` with ``time_major``)."""

    def __init__(self, inputs, sequence_length=None, time_major=False):
        self.inputs = inputs if time_major else inputs.transpose(0, 1)
        self.sequence_length = sequence_length
        self.t_max = self.inputs.shape[0]

    def initialize(self, batch_size: int):
        dev = self.inputs.device
        fin = torch.zeros((batch_size,), dtype=torch.bool, device=dev) \
            if self.sequence_length is None \
            else torch.as_tensor(self.sequence_length, device=dev) <= 0
        return fin, self.inputs[0]

    def sample(self, time, outputs):
        return torch.argmax(outputs, dim=-1)

    def next_inputs(self, time, outputs, sample_ids):
        nxt = min(max(time + 1, 0), self.t_max - 1)
        if self.sequence_length is not None:
            finished = torch.as_tensor(self.sequence_length,
                                       device=outputs.device) <= time + 1
        else:
            finished = torch.full((outputs.shape[0],),
                                  time + 1 >= self.t_max, dtype=torch.bool,
                                  device=outputs.device)
        return finished, self.inputs[nxt]


class GreedyEmbeddingHelper(DecodeHelper):
    """Inference: the argmax fed back through ``embedding_fn``."""

    def __init__(self, embedding_fn: Callable, start_tokens, end_token):
        self.embedding_fn = embedding_fn
        self.start_tokens = torch.as_tensor(start_tokens).long()
        self.end_token = int(end_token)

    def initialize(self, batch_size: int):
        fin = torch.zeros((batch_size,), dtype=torch.bool,
                          device=self.start_tokens.device)
        return fin, self.embedding_fn(self.start_tokens)

    def sample(self, time, outputs):
        return torch.argmax(outputs, dim=-1)

    def next_inputs(self, time, outputs, sample_ids):
        return sample_ids == self.end_token, self.embedding_fn(sample_ids)


class SampleEmbeddingHelper(GreedyEmbeddingHelper):
    """Inference with a categorical draw from the (tempered) outputs in
    place of the argmax."""

    def __init__(self, embedding_fn, start_tokens, end_token,
                 softmax_temperature: Optional[float] = None, key=None):
        super().__init__(embedding_fn, start_tokens, end_token)
        self.temperature = softmax_temperature
        self.key = key

    def sample(self, time, outputs):
        logits = outputs if self.temperature is None \
            else outputs / self.temperature
        probs = torch.softmax(logits.float(), dim=-1)

        def fn(gen):
            return torch.multinomial(probs, 1, generator=gen)[:, 0]

        if isinstance(self.key, int):
            self.key = torch.Generator(device=outputs.device).manual_seed(
                self.key)
        if self.key is not None:
            return fn(self.key)
        return _random.draw("random", outputs.device, fn)


class Decoder:
    """One-step decode interface."""

    def initialize(self, inits, batch_size: int):
        raise NotImplementedError

    def step(self, time: int, inputs, states):
        """(outputs, next_states, next_inputs, finished)."""
        raise NotImplementedError


class BasicDecoder(Decoder):
    """A cell, a helper and an optional output layer; each step's outputs
    are ``(cell_outputs, sample_ids)``."""

    def __init__(self, cell, helper: DecodeHelper,
                 output_fn: Optional[Callable] = None):
        self.cell = cell
        self.helper = helper
        self.output_fn = output_fn

    def initialize(self, inits, batch_size: int):
        finished, first_inputs = self.helper.initialize(batch_size)
        return first_inputs, inits, finished

    def step(self, time, inputs, states):
        cell_out, next_states = self.cell(inputs, states)
        if self.output_fn is not None:
            cell_out = self.output_fn(cell_out)
        sample_ids = self.helper.sample(time, cell_out)
        finished, next_inputs = self.helper.next_inputs(time, cell_out,
                                                        sample_ids)
        return (cell_out, sample_ids), next_states, next_inputs, finished


class BeamSearchDecoder:
    """Beam search over ``ops.beam.beam_search``: the cell runs on the
    beams flattened into the batch; consumed by :func:`dynamic_decode`."""

    def __init__(self, cell, start_token: int, end_token: int,
                 beam_size: int, embedding_fn: Callable,
                 output_fn: Optional[Callable] = None,
                 length_penalty: float = 0.0):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = beam_size
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn
        self.length_penalty = length_penalty

    def decode(self, inits, batch_size: int, max_step_num: int):
        k = self.beam_size
        tiled = _map(lambda t: t[:, None].expand(
            (batch_size, k) + tuple(t.shape[1:])), inits)

        def step_fn(tokens, cell_state):
            emb = self.embedding_fn(tokens.reshape(-1).long())
            flat = _map(lambda t: t.reshape((-1,) + tuple(t.shape[2:])),
                        cell_state)
            out, new_state = self.cell(emb, flat)
            if self.output_fn is not None:
                out = self.output_fn(out)
            log_probs = torch.log_softmax(out, dim=-1).reshape(
                batch_size, k, -1)
            new_state = _map(lambda t: t.reshape(
                (batch_size, k) + tuple(t.shape[1:])), new_state)
            return log_probs, new_state

        return beam_search(step_fn, tiled, batch_size, k, max_step_num,
                           self.start_token, self.end_token,
                           self.length_penalty,
                           device=_first_leaf(inits).device)


def dynamic_decode(decoder, inits=None, max_step_num: int = 100,
                   batch_size: Optional[int] = None,
                   output_time_major: bool = False,
                   impute_finished: bool = True):
    """Runs a decoder to the end (ref: rnn.py dynamic_decode). A
    :class:`BeamSearchDecoder` gives (sequences [B, beam, T], scores [B,
    beam]); a step decoder (outputs stacked over time, final states,
    sequence lengths [B] int64), all ``max_step_num`` steps run."""
    if batch_size is None:
        batch_size = _first_leaf(inits).shape[0]
    if isinstance(decoder, BeamSearchDecoder):
        return decoder.decode(inits, batch_size, max_step_num)
    inputs, states, finished = decoder.initialize(inits, batch_size)
    seq_len = torch.zeros((batch_size,), dtype=torch.int64,
                          device=finished.device)
    outputs = []
    for time in range(max_step_num):
        out, next_states, inputs, step_fin = decoder.step(time, inputs,
                                                          states)
        if impute_finished:
            # a finished row keeps its state
            fin = finished
            next_states = _map2(lambda new, old: torch.where(
                fin.reshape((-1,) + (1,) * (new.ndim - 1)), old, new),
                next_states, states)
        seq_len = torch.where(finished, seq_len, time + 1)
        finished = finished | step_fin
        states = next_states
        outputs.append(out)
    dim = 0 if output_time_major else 1
    stacked = outputs[0]
    if isinstance(stacked, (tuple, list)):
        stacked = type(stacked)(torch.stack([o[i] for o in outputs], dim)
                                for i in range(len(stacked)))
    else:
        stacked = torch.stack(outputs, dim)
    return stacked, states, seq_len
