"""Functional recurrent ops (the reference's fluid.layers surface).

Counterpart of ``paddle_tpu.ops.rnn_functional`` (the reference's
``lstm_op.cc``, ``lstmp_op.cc``, ``gru_op.cc``, ``lstm_unit_op.cc``,
``gru_unit_op.cc``, ``cudnn_lstm_op.cu``). Sequences are dense padded
``[B, T, ...]`` with optional lengths; the recurrence is a Python loop
over the (static) time steps, each step one ``h @ W_hh`` product and its
gate arithmetic, which a CUDA graph capture records whole. A padded
step keeps the state it had (``_masked``): its output repeats the
state, as the JAX scan emits it.

The gate layouts are the reference's: ``dynamic_lstm`` takes the input
already projected, ``[B, T, 4H]`` (order i, f, c, o), and a
hidden-to-hidden weight ``[H, 4H]``; ``dynamic_gru`` takes ``[B, T,
3H]`` (order u, r, c).
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["lstm_unit", "gru_unit", "dynamic_lstm", "dynamic_lstmp",
           "dynamic_gru", "lstm"]


def _act(name: str):
    return {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
            "relu": torch.relu, "identity": lambda x: x}[name]


def lstm_unit(x_t, h_prev, c_prev, weight_hh, bias=None,
              forget_bias: float = 0.0, gate_activation: str = "sigmoid",
              cell_activation: str = "tanh"):
    """One LSTM step (ref: lstm_unit_op.cc). x_t: [B, 4H] pre-projected;
    weight_hh: [H, 4H]; gate order i, f, c, o. Returns (h, c)."""
    gates = x_t + h_prev @ weight_hh
    if bias is not None:
        gates = gates + bias
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    ga, ca = _act(gate_activation), _act(cell_activation)
    c = ga(f + forget_bias) * c_prev + ga(i) * ca(g)
    return ga(o) * ca(c), c


def gru_unit(x_t, h_prev, weight_hh, bias=None,
             gate_activation: str = "sigmoid", activation: str = "tanh"):
    """One GRU step (ref: gru_unit_op.cc). x_t: [B, 3H] pre-projected
    (order u, r, c); weight_hh: [H, 3H] with the candidate block last.
    Returns (h, reset_h, gates)."""
    h_dim = h_prev.shape[-1]
    ga, ca = _act(gate_activation), _act(activation)
    xu, xr, xc = torch.chunk(x_t, 3, dim=-1)
    hu, hr = torch.chunk(h_prev @ weight_hh[:, :2 * h_dim], 2, dim=-1)
    bu = br = bc = 0.0
    if bias is not None:
        bu, br, bc = torch.chunk(bias, 3, dim=-1)
    u = ga(xu + hu + bu)
    r = ga(xr + hr + br)
    reset_h = r * h_prev
    c = ca(xc + reset_h @ weight_hh[:, 2 * h_dim:] + bc)
    h = u * h_prev + (1.0 - u) * c
    return h, reset_h, torch.cat([u, r, c], dim=-1)


def _masked(new, old, t: int, lengths):
    """``new`` where step ``t`` is inside the row's length, else ``old``
    (a comparison on the device: no host read)."""
    if lengths is None:
        return new
    return torch.where((lengths > t)[:, None], new, old)


def _order(t_max: int, is_reverse: bool):
    return range(t_max - 1, -1, -1) if is_reverse else range(t_max)


def _peepholes(bias, h_dim: int, use_peepholes: bool):
    """The gate bias and, with ``use_peepholes``, the peephole weights
    Wic|Wif|Woc appended to it ([7H])."""
    if bias is None:
        return None, None, None, None
    if not use_peepholes:
        return bias[:4 * h_dim], None, None, None
    return (bias[:4 * h_dim], bias[4 * h_dim:5 * h_dim],
            bias[5 * h_dim:6 * h_dim], bias[6 * h_dim:7 * h_dim])


def _lstm_cell(x_t, r_prev, c_prev, weight, b_gate, w_ic, w_if, w_oc,
               use_peepholes, ga, ca, na, forget_bias):
    gates = x_t + r_prev @ weight
    if b_gate is not None:
        gates = gates + b_gate
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    if use_peepholes:
        i = i + c_prev * w_ic
        f = f + c_prev * w_if
    c_new = ga(f + forget_bias) * c_prev + ga(i) * na(g)
    if use_peepholes:
        o = o + c_new * w_oc
    return ga(o) * ca(c_new), c_new


def dynamic_lstm(input, weight, bias=None, lengths=None, h0=None, c0=None,
                 is_reverse: bool = False, use_peepholes: bool = False,
                 gate_activation: str = "sigmoid",
                 cell_activation: str = "tanh",
                 candidate_activation: str = "tanh",
                 forget_bias: float = 0.0):
    """(ref: lstm_op.cc) input: [B, T, 4H] pre-projected; weight: [H, 4H];
    bias: [4H] or [7H] with the peephole weights appended. Returns
    (hidden [B, T, H], cell [B, T, H])."""
    b, t_max, four_h = input.shape
    h_dim = four_h // 4
    acts = (_act(gate_activation), _act(cell_activation),
            _act(candidate_activation))
    b_gate, w_ic, w_if, w_oc = _peepholes(bias, h_dim, use_peepholes)
    h = h0 if h0 is not None else input.new_zeros((b, h_dim))
    c = c0 if c0 is not None else input.new_zeros((b, h_dim))
    hs, cs = [None] * t_max, [None] * t_max
    for t in _order(t_max, is_reverse):
        h_new, c_new = _lstm_cell(input[:, t], h, c, weight, b_gate, w_ic,
                                  w_if, w_oc, use_peepholes, *acts,
                                  forget_bias)
        h = hs[t] = _masked(h_new, h, t, lengths)
        c = cs[t] = _masked(c_new, c, t, lengths)
    return torch.stack(hs, dim=1), torch.stack(cs, dim=1)


def dynamic_lstmp(input, weight, proj_weight, bias=None, lengths=None,
                  h0=None, c0=None, is_reverse: bool = False,
                  use_peepholes: bool = False,
                  gate_activation: str = "sigmoid",
                  cell_activation: str = "tanh",
                  candidate_activation: str = "tanh",
                  proj_activation: str = "tanh",
                  forget_bias: float = 0.0):
    """(ref: lstmp_op.cc) LSTM with a recurrent projection: the state fed
    back is r = act(h @ P), P: [H, P_dim]; weight: [P_dim, 4H]. Returns
    (projection [B, T, P], cell [B, T, H])."""
    b, t_max, four_h = input.shape
    h_dim = four_h // 4
    p_dim = proj_weight.shape[1]
    acts = (_act(gate_activation), _act(cell_activation),
            _act(candidate_activation))
    pa = _act(proj_activation)
    b_gate, w_ic, w_if, w_oc = _peepholes(bias, h_dim, use_peepholes)
    r = h0 if h0 is not None else input.new_zeros((b, p_dim))
    c = c0 if c0 is not None else input.new_zeros((b, h_dim))
    rs, cs = [None] * t_max, [None] * t_max
    for t in _order(t_max, is_reverse):
        h_new, c_new = _lstm_cell(input[:, t], r, c, weight, b_gate, w_ic,
                                  w_if, w_oc, use_peepholes, *acts,
                                  forget_bias)
        r = rs[t] = _masked(pa(h_new @ proj_weight), r, t, lengths)
        c = cs[t] = _masked(c_new, c, t, lengths)
    return torch.stack(rs, dim=1), torch.stack(cs, dim=1)


def dynamic_gru(input, weight, bias=None, lengths=None, h0=None,
                is_reverse: bool = False, gate_activation: str = "sigmoid",
                candidate_activation: str = "tanh"):
    """(ref: gru_op.cc) input: [B, T, 3H] pre-projected (order u, r, c);
    weight: [H, 3H]. Returns hidden [B, T, H]."""
    b, t_max, three_h = input.shape
    h = h0 if h0 is not None else input.new_zeros((b, three_h // 3))
    hs = [None] * t_max
    for t in _order(t_max, is_reverse):
        h_new, _, _ = gru_unit(input[:, t], h, weight, bias,
                               gate_activation, candidate_activation)
        h = hs[t] = _masked(h_new, h, t, lengths)
    return torch.stack(hs, dim=1)


def lstm(input, init_h, init_c, weights: Sequence, lengths=None,
         num_layers: int = 1, is_bidirec: bool = False,
         dropout_prob: float = 0.0, training: bool = False, key=None):
    """Multi-layer, optionally bidirectional LSTM (ref:
    cudnn_lstm_op.cu). input: [B, T, C]; init_h/init_c: [L*D, B, H];
    weights: one dict per (layer, direction) with w_ih [C_in, 4H], w_hh
    [H, 4H], b [4H]. Returns (out [B, T, H*D], last_h, last_c). Dropout
    between layers in training draws from ``key`` (a generator, or an
    int seeding one), else from the ``dropout`` stream."""
    from ..nn.functional import dropout
    d = 2 if is_bidirec else 1
    x = input
    if lengths is not None:
        idx = (lengths.long() - 1).clamp(min=0)
        bi = torch.arange(x.shape[0], device=x.device)
    last_h, last_c = [], []
    for layer in range(num_layers):
        outs = []
        for direction in range(d):
            wd = weights[layer * d + direction]
            k = layer * d + direction
            hs, cs = dynamic_lstm(x @ wd["w_ih"], wd["w_hh"], wd.get("b"),
                                  lengths=lengths, h0=init_h[k],
                                  c0=init_c[k], is_reverse=direction == 1)
            outs.append(hs)
            if direction == 1:
                last_h.append(hs[:, 0])
                last_c.append(cs[:, 0])
            elif lengths is None:
                last_h.append(hs[:, -1])
                last_c.append(cs[:, -1])
            else:
                last_h.append(hs[bi, idx])
                last_c.append(cs[bi, idx])
        x = outs[0] if d == 1 else torch.cat(outs, dim=-1)
        if dropout_prob > 0.0 and training and layer < num_layers - 1:
            if key is None:
                x = dropout(x, dropout_prob, training=True)
            else:
                if not isinstance(key, torch.Generator):
                    key = torch.Generator(device=x.device).manual_seed(
                        int(key))
                keep = torch.rand(x.shape, generator=key,
                                  device=x.device) < 1.0 - dropout_prob
                x = torch.where(keep, x / (1.0 - dropout_prob),
                                torch.zeros_like(x))
    return x, torch.stack(last_h), torch.stack(last_c)
