"""Recurrent layers: the cells, ``RNN`` and the stacked ``LSTM``, ``GRU``
and ``SimpleRNN``.

Counterparts of ``paddle_tpu.nn.layers.rnn``, with its parameter names
and layouts, so a JAX ``param_dict()`` loads by name
(``convert.load_jax_params``): weights ``[in, gates * H]`` and
``[H, gates * H]``, two biases ``[gates * H]``; the LSTM's gates are
``i, f, g, o``, the GRU's ``r, z, n`` with ``n = tanh(xn + r * hn)``
(``b_hh`` inside ``hn``). ``torch.nn.LSTM``/``GRU`` store the same gates
transposed, ``[gates * H, in]``.

``RNN`` runs a cell over the (static) time steps in a Python loop, which
a CUDA graph capture records whole. For the port's own cells the input
projection ``x @ W_ih + b_ih`` is hoisted out of the loop: one product
over every step (``cell.project``), then one ``h @ W_hh`` product and
the gate arithmetic a step (``cell.recur``); the sums associate as the
JAX cell's ``x @ W_ih + b_ih + h @ W_hh + b_hh`` does, and only the
blocking of the hoisted product differs. Any other ``RNNCell`` is called
a step at a time. With ``sequence_length`` a padded step keeps the
state it had and emits zeros; in reverse the loop starts on the padding,
whose state stays the initial one until the first valid step. The masks
are comparisons of the lengths on the device (no host read).

The stacked layers keep the JAX layouts: the final states are
layer-major ``[l0fw, l0bw, l1fw, ...]`` (``[num_layers * dirs, B, H]``,
a ``(h, c)`` pair for the LSTM), and ``initial_states`` takes the same
layout, so ``out, st = rnn(x); rnn(y, st)`` carries the state across;
dropout runs between layers in training only; ``time_major`` inputs are
``[T, B, ...]``. Weights are drawn from ``Uniform(-1/sqrt(H), 1/sqrt(H))``
on ``device`` (None: the card) from ``generator``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.place import resolve_device
from . import functional as F
from . import initializer as I
from .layer import Layer, LayerList

__all__ = ["RNNCell", "LSTMCell", "GRUCell", "SimpleRNNCell", "RNN",
           "LSTM", "GRU", "SimpleRNN"]


def _tree_map(fn, *trees):
    if isinstance(trees[0], (tuple, list)):
        return type(trees[0])(_tree_map(fn, *leaves)
                              for leaves in zip(*trees))
    return fn(*trees)


class RNNCell(Layer):
    """The single-step cell protocol: ``forward(inputs, states) ->
    (outputs, new_states)`` and ``get_initial_states(batch_size)``;
    ``RNN`` and ``nn.decode`` drive any cell through it."""

    def get_initial_states(self, batch_size: int):
        raise NotImplementedError


class _ProjectedCell(RNNCell):
    """A cell whose input enters through ``x @ weight_ih + bias_ih``:
    ``project`` computes that for any number of steps at once and
    ``recur`` the rest of a step."""

    _gates = 1

    def __init__(self, input_size: int, hidden_size: int, attrs=(),
                 device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.input_size = input_size
        self.hidden_size = hidden_size
        k = 1.0 / (hidden_size ** 0.5)
        init = I.Uniform(-k, k)
        g = self._gates * hidden_size
        attrs = tuple(attrs) + (None,) * (4 - len(attrs))
        for name, attr, shape in zip(
                ("weight_ih", "weight_hh", "bias_ih", "bias_hh"), attrs,
                ((input_size, g), (hidden_size, g), (g,), (g,))):
            setattr(self, name, I.make_param(attr, init, shape,
                                             device=device,
                                             generator=generator))

    def project(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight_ih + self.bias_ih

    def recur(self, xp: torch.Tensor, states):
        raise NotImplementedError

    def forward(self, x, states=None):
        if states is None:
            states = self.get_initial_states(x.shape[0])
        return self.recur(self.project(x), states)

    def _zeros(self, batch_size: int) -> torch.Tensor:
        w = self.weight_hh
        return torch.zeros((batch_size, self.hidden_size), dtype=w.dtype,
                           device=w.device)

    def get_initial_states(self, batch_size: int):
        return self._zeros(batch_size)


class LSTMCell(_ProjectedCell):
    """(ref: lstm_unit_op.cc) gates ``i, f, g, o``; states ``(h, c)``."""

    _gates = 4

    def __init__(self, input_size: int, hidden_size: int,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(input_size, hidden_size,
                         (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                          bias_hh_attr), device, generator)

    def recur(self, xp, states):
        h, c = states
        gates = xp + h @ self.weight_hh + self.bias_hh
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return new_h, (new_h, new_c)

    def get_initial_states(self, batch_size: int):
        z = self._zeros(batch_size)
        return (z, z)


class GRUCell(_ProjectedCell):
    """(ref: gru_unit_op.cc) gates ``r, z, n``; ``b_hh`` inside ``hn``."""

    _gates = 3

    def __init__(self, input_size: int, hidden_size: int, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(input_size, hidden_size, (), device, generator)

    def recur(self, xp, states):
        h = states
        xr, xz, xn = torch.chunk(xp, 3, dim=-1)
        hr, hz, hn = torch.chunk(h @ self.weight_hh + self.bias_hh, 3,
                                 dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        new_h = (1.0 - z) * n + z * h
        return new_h, new_h


class SimpleRNNCell(_ProjectedCell):
    """``h = act(x W_ih + b_ih + h W_hh + b_hh)``, ``act`` tanh or relu."""

    def __init__(self, input_size: int, hidden_size: int,
                 activation: str = "tanh", device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(input_size, hidden_size, (), device, generator)
        self.activation = activation

    def recur(self, xp, states):
        pre = xp + states @ self.weight_hh + self.bias_hh
        new_h = torch.tanh(pre) if self.activation == "tanh" \
            else torch.relu(pre)
        return new_h, new_h


class RNN(Layer):
    """A cell run over time (ref: layers/rnn.py RNN): ``(outputs,
    final_states)`` (see the module note)."""

    def __init__(self, cell: RNNCell, is_reverse: bool = False,
                 time_major: bool = False) -> None:
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        xs = inputs if self.time_major else inputs.transpose(0, 1)
        t_max, batch = xs.shape[0], xs.shape[1]
        cell = self.cell
        states = initial_states if initial_states is not None \
            else cell.get_initial_states(batch)
        hoisted = isinstance(cell, _ProjectedCell)
        if hoisted:
            xs = cell.project(xs)
        seq_len = None if sequence_length is None else torch.as_tensor(
            sequence_length, device=xs.device)
        outs = [None] * t_max
        steps = range(t_max - 1, -1, -1) if self.is_reverse \
            else range(t_max)
        for t in steps:
            out_t, new_states = cell.recur(xs[t], states) if hoisted \
                else cell(xs[t], states)
            if seq_len is not None:
                alive = seq_len > t

                def keep(new, old):
                    return torch.where(
                        alive.reshape((-1,) + (1,) * (new.ndim - 1)),
                        new, old)

                new_states = _tree_map(keep, new_states, states)
                out_t = keep(out_t, torch.zeros_like(out_t))
            states = new_states
            outs[t] = out_t
        outs = torch.stack(outs, dim=0 if self.time_major else 1)
        return outs, states


class _StackedRNNBase(Layer):
    _cell_cls = None

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, direction: str = "forward",
                 dropout: float = 0.0, time_major: bool = False,
                 device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.num_layers = num_layers
        self.direction = direction
        self.dropout = dropout
        self.time_major = time_major
        self.hidden_size = hidden_size
        self.bidirect = direction in ("bidirect", "bidirectional")
        kw = dict(device=device, generator=generator)
        self.fw = LayerList()
        self.bw = LayerList() if self.bidirect else None
        for i in range(num_layers):
            in_size = input_size if i == 0 else \
                hidden_size * (2 if self.bidirect else 1)
            self.fw.append(RNN(self._cell_cls(in_size, hidden_size, **kw)))
            if self.bidirect:
                self.bw.append(RNN(self._cell_cls(in_size, hidden_size,
                                                  **kw), is_reverse=True))

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs.transpose(0, 1) if self.time_major else inputs
        finals = []
        for i in range(self.num_layers):
            out, fin = self.fw[i](x, self._slice_initial(
                initial_states, i, False), sequence_length)
            finals.append(fin)
            if self.bidirect:
                out_b, fin_b = self.bw[i](x, self._slice_initial(
                    initial_states, i, True), sequence_length)
                finals.append(fin_b)
                out = torch.cat([out, out_b], dim=-1)
            x = out
            if self.dropout > 0 and i < self.num_layers - 1:
                x = F.dropout(x, self.dropout, training=self.training)
        if self.time_major:
            x = x.transpose(0, 1)
        if isinstance(finals[0], tuple):
            return x, tuple(torch.stack([f[k] for f in finals])
                            for k in range(len(finals[0])))
        return x, torch.stack(finals)

    def _slice_initial(self, initial_states, layer: int, backward: bool):
        """The states of one layer and direction out of the layer-major
        stacked layout."""
        if initial_states is None:
            return None
        idx = layer * (2 if self.bidirect else 1) + int(backward)
        if isinstance(initial_states, (tuple, list)):
            return tuple(s[idx] for s in initial_states)
        return initial_states[idx]


class LSTM(_StackedRNNBase):
    """(ref: cudnn_lstm_op.cu capability)."""
    _cell_cls = LSTMCell


class GRU(_StackedRNNBase):
    _cell_cls = GRUCell


class SimpleRNN(_StackedRNNBase):
    _cell_cls = SimpleRNNCell
