"""PyTorch port: the recurrent layers (``nn.rnn``) and
``ops.rnn_functional`` against the JAX package on the CPU.

Inputs come from numpy with a fixed seed; the JAX layer's weights move
into the port through ``convert.load_jax_params``. Outputs, final states
and gradients (of a seeded weighted sum of the outputs and the final
states, taken with respect to the input and every parameter) agree
within ``TOL`` of the reference's largest entry: fp32 with the sums in
another order (the port hoists the input projection of all steps into
one product).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import paddle_tpu as jpt  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.ops import rnn_functional as jrf  # noqa: E402

from paddle_tpu_torch import nn as pnn  # noqa: E402
from paddle_tpu_torch.convert import load_jax_params  # noqa: E402
from paddle_tpu_torch.ops import rnn_functional as prf  # noqa: E402

TOL = 1e-5
B, T, IN, H = 3, 5, 4, 6
LENS = np.array([5, 2, 3])


def _close(got, want, what=""):
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = max(float(np.max(np.abs(w), initial=0.0)), 1e-30)
    err = float(np.max(np.abs(g - w), initial=0.0)) / scale
    assert err <= TOL, (what, err)


def _flat(tree):
    if isinstance(tree, (tuple, list)):
        return [a for t in tree for a in _flat(t)]
    return [tree]


def _weights(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in n]


def _pair(jlayer, plain_layer, x, call, seed=7):
    """Runs ``call(layer, x)`` -> (out, states) on both, and the grads of
    a seeded weighted sum of every output with respect to ``x`` and the
    parameters; returns (port outs, JAX outs, port grads, JAX grads)."""
    load_jax_params(plain_layer, {k: np.asarray(v) for k, v in
                                  jlayer.param_dict().items()})
    jparams = jlayer.param_dict()

    def jfun(p, xx):
        with jlayer.bind(p, None):
            outs = _flat(call(jlayer, xx))
        ws = _weights([o.shape for o in outs], seed)
        return sum(jnp.sum(o * w) for o, w in zip(outs, ws)), outs

    (_, jouts), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jfun, argnums=(0, 1), has_aux=True))(jparams, jnp.asarray(x))
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    pouts = _flat(call(plain_layer, xt))
    ws = _weights([tuple(o.shape) for o in pouts], seed)
    sum(torch.sum(o * torch.from_numpy(w))
        for o, w in zip(pouts, ws)).backward()
    pg = {n: p.grad for n, p in plain_layer.named_parameters()}
    assert set(pg) == set(jgp)
    for a, b in zip(pouts, jouts):
        _close(a, b, "output")
    _close(xt.grad, jgx, "d input")
    for n in jgp:
        _close(pg[n], jgp[n], f"d {n}")


def _x(shape=(B, T, IN), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


CELLS = {"LSTMCell": (jnn.LSTMCell, pnn.LSTMCell),
         "GRUCell": (jnn.GRUCell, pnn.GRUCell),
         "SimpleRNNCell": (jnn.SimpleRNNCell, pnn.SimpleRNNCell)}


@pytest.mark.parametrize("name", list(CELLS))
def test_cell_step_matches_jax(name):
    jcls, pcls = CELLS[name]
    jpt.seed(1)
    jc, pc = jcls(IN, H), pcls(IN, H, device="cpu")
    rng = np.random.default_rng(3)
    st = rng.standard_normal((B, H)).astype(np.float32)

    def call(cell, x):
        s = torch.from_numpy(st) if isinstance(x, torch.Tensor) \
            else jnp.asarray(st)
        return cell(x, (s, s * 0.5) if "LSTM" in name else s)

    _pair(jc, pc, _x((B, IN)), call)
    # the zero initial states when none are given
    out, _ = pc(torch.from_numpy(_x((B, IN))))
    jout, _ = jc(jnp.asarray(_x((B, IN))))
    _close(out, jout)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_rnn_over_a_cell_matches_jax(reverse, ragged):
    jpt.seed(2)
    jr = jnn.RNN(jnn.LSTMCell(IN, H), is_reverse=reverse)
    pr = pnn.RNN(pnn.LSTMCell(IN, H, device="cpu"), is_reverse=reverse)
    lens = LENS if ragged else None

    def call(layer, x):
        ln = None if lens is None else (
            torch.from_numpy(lens) if isinstance(x, torch.Tensor)
            else jnp.asarray(lens))
        return layer(x, sequence_length=ln)

    _pair(jr, pr, _x(), call)


@pytest.mark.parametrize("kind", ["LSTM", "GRU", "SimpleRNN"])
@pytest.mark.parametrize("layers,direction", [(1, "forward"),
                                              (2, "bidirect")])
@pytest.mark.parametrize("ragged", [False, True])
def test_stacked_rnn_matches_jax(kind, layers, direction, ragged):
    jpt.seed(4)
    jl = getattr(jnn, kind)(IN, H, num_layers=layers, direction=direction)
    pl = getattr(pnn, kind)(IN, H, num_layers=layers, direction=direction,
                            device="cpu")
    lens = LENS if ragged else None

    def call(layer, x):
        ln = None if lens is None else (
            torch.from_numpy(lens) if isinstance(x, torch.Tensor)
            else jnp.asarray(lens))
        return layer(x, sequence_length=ln)

    _pair(jl, pl, _x(), call)


def test_state_carries_across_calls_and_time_major():
    """``out, st = rnn(x); rnn(y, st)`` in the layer-major layout, and a
    time-major stack, against JAX."""
    jpt.seed(5)
    jl = jnn.LSTM(IN, H, num_layers=2, direction="bidirect")
    pl = pnn.LSTM(IN, H, num_layers=2, direction="bidirect", device="cpu")
    y = _x(seed=9)

    def call(layer, x):
        yy = torch.from_numpy(y) if isinstance(x, torch.Tensor) \
            else jnp.asarray(y)
        out1, st = layer(x)
        out2, st2 = layer(yy, st)
        return out1, out2, st2

    _pair(jl, pl, _x(), call)
    jt = jnn.GRU(IN, H, num_layers=2, time_major=True)
    pt_ = pnn.GRU(IN, H, num_layers=2, time_major=True, device="cpu")
    _pair(jt, pt_, _x((T, B, IN)), lambda layer, x: layer(x))


def test_dropout_between_layers_only_while_training():
    pl = pnn.LSTM(IN, H, num_layers=2, dropout=0.5, device="cpu")
    x = torch.from_numpy(_x())
    pl.eval()
    a, _ = pl(x)
    b, _ = pl(x)
    assert torch.equal(a, b)
    pl.train()
    c, _ = pl(x)
    assert not torch.equal(a, c)


def _rf_inputs(seed=11):
    rng = np.random.default_rng(seed)

    def r(*s):
        return rng.standard_normal(s).astype(np.float32) * 0.5

    return r


def _fn_pair(jfn, pfn, x, weights, seed=7):
    names = list(weights)

    def jf(ws, xx):
        outs = _flat(jfn(xx, {n: ws[n] for n in names}))
        return sum(jnp.sum(o * w) for o, w in zip(
            outs, _weights([o.shape for o in outs], seed))), outs

    (_, jouts), (jgw, jgx) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(
        {n: jnp.asarray(v) for n, v in weights.items()}, jnp.asarray(x))
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    wt = {n: torch.from_numpy(v.copy()).requires_grad_(True)
          for n, v in weights.items()}
    pouts = _flat(pfn(xt, wt))
    sum(torch.sum(o * torch.from_numpy(w)) for o, w in zip(
        pouts, _weights([tuple(o.shape) for o in pouts], seed))).backward()
    for a, b in zip(pouts, jouts):
        _close(a, b, "output")
    _close(xt.grad, jgx, "d input")
    for n in names:
        _close(wt[n].grad, jgw[n], f"d {n}")


def _lens(x):
    return torch.from_numpy(LENS) if isinstance(x, torch.Tensor) \
        else jnp.asarray(LENS)


RF_CASES = {
    "lstm_unit": (lambda m, x, w: m.lstm_unit(
        x, w["h"], w["c"], w["w"], w["b"], forget_bias=0.5),
        lambda r: (r(B, 4 * H), {"h": r(B, H), "c": r(B, H),
                                 "w": r(H, 4 * H), "b": r(4 * H)})),
    "gru_unit": (lambda m, x, w: m.gru_unit(x, w["h"], w["w"], w["b"]),
                 lambda r: (r(B, 3 * H), {"h": r(B, H), "w": r(H, 3 * H),
                                          "b": r(3 * H)})),
    "dynamic_lstm": (lambda m, x, w: m.dynamic_lstm(
        x, w["w"], w["b"], lengths=_lens(x), h0=w["h"], c0=w["c"],
        is_reverse=True, use_peepholes=True, forget_bias=1.0),
        lambda r: (r(B, T, 4 * H), {"w": r(H, 4 * H), "b": r(7 * H),
                                    "h": r(B, H), "c": r(B, H)})),
    "dynamic_lstmp": (lambda m, x, w: m.dynamic_lstmp(
        x, w["w"], w["p"], w["b"], lengths=_lens(x), use_peepholes=True),
        lambda r: (r(B, T, 4 * H), {"w": r(3, 4 * H), "p": r(H, 3),
                                    "b": r(7 * H)})),
    "dynamic_gru": (lambda m, x, w: m.dynamic_gru(
        x, w["w"], w["b"], lengths=_lens(x), h0=w["h"], is_reverse=True),
        lambda r: (r(B, T, 3 * H), {"w": r(H, 3 * H), "b": r(3 * H),
                                    "h": r(B, H)})),
    "lstm": (lambda m, x, w: m.lstm(
        x, w["h0"], w["c0"],
        [{"w_ih": w[f"ih{k}"], "w_hh": w[f"hh{k}"], "b": w[f"b{k}"]}
         for k in range(4)], lengths=_lens(x), num_layers=2,
        is_bidirec=True),
        lambda r: (r(B, T, IN), {
            "h0": r(4, B, H), "c0": r(4, B, H),
            **{f"ih{k}": r(IN if k < 2 else 2 * H, 4 * H)
               for k in range(4)},
            **{f"hh{k}": r(H, 4 * H) for k in range(4)},
            **{f"b{k}": r(4 * H) for k in range(4)}})),
}


@pytest.mark.parametrize("name", list(RF_CASES))
def test_rnn_functional_matches_jax(name):
    call, make = RF_CASES[name]
    x, w = make(_rf_inputs())
    _fn_pair(lambda xx, ww: call(jrf, xx, ww),
             lambda xx, ww: call(prf, xx, ww), x, w)


ACTS = ["ReLU6", "LeakyReLU", "ELU", "SELU", "CELU", "Sigmoid",
        "LogSigmoid", "Hardsigmoid", "Hardswish", "Hardshrink",
        "Softshrink", "Hardtanh", "Tanhshrink", "Softplus", "Softsign",
        "Swish", "Silu", "Mish", "ThresholdedReLU", "LogSoftmax", "Softmax",
        "GLU", "GELU", "Tanh", "ReLU"]
IMG = np.random.default_rng(12).standard_normal((2, 3, 4, 5)).astype(
    np.float32)

# (name, JAX layer, port layer, inputs): the rest of the common layers
COMMON = [
    ("Upsample-nearest", lambda m: m.Upsample(scale_factor=2), (IMG,)),
    ("Upsample-bilinear", lambda m: m.Upsample(size=(7, 9),
                                               mode="bilinear"), (IMG,)),
    ("Upsample-bilinear-corners", lambda m: m.Upsample(
        size=(7, 3), mode="bilinear", align_corners=True), (IMG,)),
    ("Upsample-nearest-corners", lambda m: m.Upsample(
        size=(6, 8), align_corners=True), (IMG,)),
    ("Pad2D", lambda m: m.Pad2D([1, 2, 0, 3], mode="reflect"), (IMG,)),
    ("CosineSimilarity", lambda m: m.CosineSimilarity(axis=1),
     (IMG, IMG[::-1].copy())),
    ("Maxout", lambda m: m.Maxout(groups=3, axis=1),
     (np.tile(IMG, (1, 2, 1, 1)),)),
]


# (mode, input shape, size, align_corners): shrinking and growing in
# 1-D, 2-D and 3-D, where the antialiased and cubic weights show
RESIZES = [
    ("linear", (2, 3, 11), (4,), False),
    ("linear", (2, 3, 5), (9,), False),
    ("linear", (2, 3, 7), (4,), True),
    ("nearest", (2, 3, 10), (4,), False),
    ("bilinear", (2, 3, 9, 10), (4, 3), False),
    ("bicubic", (2, 3, 4, 5), (7, 9), False),
    ("bicubic", (2, 3, 9, 10), (4, 6), False),
    ("bicubic", (2, 3, 4, 5), (7, 3), True),
    ("area", (2, 3, 9, 10), (3, 5), False),
    ("nearest", (2, 3, 9, 10), (4, 7), False),
    ("trilinear", (1, 2, 6, 7, 8), (3, 4, 5), False),
    ("trilinear", (1, 2, 4, 5, 3), (6, 2, 5), True),
    ("area", (1, 2, 6, 7, 8), (2, 3, 4), False),
    ("nearest", (1, 2, 4, 5, 6), (7, 2, 6), False),
]


@pytest.mark.parametrize("mode,shape,size,corners", RESIZES,
                         ids=[f"{m}-{len(s) - 2}d-{'x'.join(map(str, o))}"
                              f"{'-corners' if c else ''}"
                              for m, s, o, c in RESIZES])
def test_interpolate_matches_jax(mode, shape, size, corners):
    """``ops.interpolate`` and its gradient against the JAX op."""
    from paddle_tpu.ops import nn_functional as jF
    from paddle_tpu_torch.ops import nn_functional as pF
    x = _x(shape, seed=13)
    fmt = {3: "NCL", 4: "NCHW", 5: "NCDHW"}[len(shape)]
    want = jF.interpolate(jnp.asarray(x), size=size, mode=mode,
                          align_corners=corners, data_format=fmt)
    w = _x(want.shape, seed=14)
    jgrad = jax.grad(lambda a: jnp.sum(jF.interpolate(
        a, size=size, mode=mode, align_corners=corners,
        data_format=fmt) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pF.interpolate(xt, size=size, mode=mode, align_corners=corners,
                         data_format=fmt)
    (got * torch.from_numpy(w)).sum().backward()
    _close(got, want, mode)
    _close(xt.grad, jgrad, mode + " grad")


@pytest.mark.parametrize("name", ACTS)
def test_activation_layers_match_jax(name):
    x = _x((3, 4))
    _close(getattr(pnn, name)()(torch.from_numpy(x)),
           getattr(jnn, name)()(jnp.asarray(x)), name)


@pytest.mark.parametrize("name,make,args", COMMON,
                         ids=[c[0] for c in COMMON])
def test_common_layers_match_jax(name, make, args):
    _close(make(pnn)(*(torch.from_numpy(a) for a in args)),
           make(jnn)(*(jnp.asarray(a) for a in args)), name)


def test_parametrised_common_layers_match_jax():
    """Bilinear, PReLU and Embedding(padding_idx, sparse) with the JAX
    weights, and the two dropouts (identity in eval, scaled in train)."""
    jpt.seed(8)
    a, b = _x((3, 4)), _x((3, 5), seed=1)
    for jl, pl, args in (
            (jnn.Bilinear(4, 5, 6), pnn.Bilinear(4, 5, 6, device="cpu"),
             (a, b)),
            (jnn.PReLU(3, init=0.1), pnn.PReLU(3, init=0.1, device="cpu"),
             (IMG,)),
            (jnn.Embedding(9, 4, padding_idx=2, sparse=True),
             pnn.Embedding(9, 4, padding_idx=2, sparse=True, device="cpu"),
             (np.array([[2, 5, 1], [2, 2, 8]]),))):
        load_jax_params(pl, {k: np.asarray(v)
                             for k, v in jl.param_dict().items()})
        _close(pl(*(torch.from_numpy(v) for v in args)),
               jl(*(jnp.asarray(v) for v in args)), type(pl).__name__)
    x = torch.from_numpy(IMG)
    for layer in (pnn.Dropout2D(0.5), pnn.AlphaDropout(0.5)):
        layer.eval()
        assert torch.equal(layer(x), x)
        layer.train()
        y = layer(x)
        assert y.shape == x.shape and not torch.equal(y, x)
    kept = pnn.Dropout2D(0.5).train()(x)
    # whole channels dropped, the kept ones scaled by 2
    for n in range(2):
        for c in range(3):
            ch = kept[n, c]
            assert torch.equal(ch, x[n, c] * 2) or not ch.any()
