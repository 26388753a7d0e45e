"""PyTorch port: the transformer layer family against the JAX package on
the CPU.

Cross-attention with ``kdim``/``vdim``, ``need_weights``, post- and
pre-norm encoder and decoder layers and ``nn.Transformer``: the JAX
layer's ``param_dict()`` moves into the port by name, both run fp32 on
the same numpy inputs, and the outputs and every parameter's gradient of
``sum(out * w)`` must agree. The port runs its plain attention, or with
``flash_attention_min_seq_train`` lowered the plain version of its flash
kernels (causal, Tq != Tk), under both ``attention_bthd_layout`` values.
``transformer_remat`` is held against the same steps without it, with
dropout 0.1 in the flash kernels and in the layers: equal bit for bit.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as pt  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.nn.layer import functional_call as jax_call  # noqa: E402

from paddle_tpu_torch import get_flags, nn, set_flags  # noqa: E402
from paddle_tpu_torch.convert import load_jax_params  # noqa: E402
from paddle_tpu_torch.core import random as prandom  # noqa: E402
from paddle_tpu_torch.optimizer import Adam  # noqa: E402
from paddle_tpu_torch.static import TrainStep  # noqa: E402

# the tolerances of tests/test_torch_bert.py
OUT_TOL = 2e-5
GRAD_TOL = 5e-5
B, TQ, TK, D, H = 2, 6, 9, 32, 4


class Flags:
    """Sets the port's flags for a block, restoring them after."""

    def __init__(self, **flags) -> None:
        self.flags = flags

    def __enter__(self):
        self.old = get_flags(list(self.flags))
        set_flags(self.flags)

    def __exit__(self, *exc):
        set_flags(self.old)


def _pair(jax_ctor, port_ctor):
    pt.seed(0)
    jm = jax_ctor()
    pm = port_ctor()
    load_jax_params(pm, {k: np.asarray(v)
                         for k, v in jm.param_dict().items()})
    return jm, pm


def _inputs(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _jax_grads(jm, args, w, **kw):
    def f(params):
        out = jax_call(jm, params, jm.buffer_dict(),
                       *[jnp.asarray(a) for a in args], **kw)
        return jnp.sum(_first(out) * jnp.asarray(w)), out

    (_, out), grads = jax.value_and_grad(f, has_aux=True)(jm.param_dict())
    return out, grads


def _port_grads(pm, args, w, **kw):
    pm.zero_grad()
    out = pm(*[torch.from_numpy(a) for a in args], **kw)
    (_first(out) * torch.from_numpy(w)).sum().backward()
    return out, {n: p.grad for n, p in pm.named_parameters()}


def _hold(jout, jgrads, pout, pgrads):
    jo = jout if isinstance(jout, tuple) else (jout,)
    po = pout if isinstance(pout, tuple) else (pout,)
    for a, e in zip(po, jo):
        assert a.shape == e.shape
        err = np.max(np.abs(a.detach().numpy() - np.asarray(e)))
        assert err <= OUT_TOL, err
    assert set(jgrads) == set(pgrads)
    for name, g in jgrads.items():
        err = np.max(np.abs(pgrads[name].numpy() - np.asarray(g)))
        assert err <= GRAD_TOL, (name, err)


@pytest.mark.parametrize("gate", [512, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_cross_attention_with_kdim_vdim_matches_jax(gate, causal):
    jm, pm = _pair(lambda: jnn.MultiHeadAttention(D, H, kdim=24, vdim=16),
                   lambda: nn.MultiHeadAttention(D, H, kdim=24, vdim=16,
                                                 device="cpu"))
    assert set(jm.param_dict()) == set(pm.param_dict())
    q, k, v, w = _inputs((B, TQ, D), (B, TK, 24), (B, TK, 16), (B, TQ, D))
    jout, jg = _jax_grads(jm, (q, k, v), w, causal=causal)
    with Flags(flash_attention_min_seq_train=gate):
        pout, pg = _port_grads(pm, (q, k, v), w, causal=causal)
    _hold(jout, jg, pout, pg)


@pytest.mark.parametrize("causal", [False, True])
def test_need_weights_returns_the_jax_weights(causal):
    jm, pm = _pair(
        lambda: jnn.MultiHeadAttention(D, H, need_weights=True),
        lambda: nn.MultiHeadAttention(D, H, need_weights=True,
                                      device="cpu"))
    x, mem, w = _inputs((B, TQ, D), (B, TK, D), (B, TQ, D), seed=1)
    jout, jg = _jax_grads(jm, (x, mem), w, causal=causal)
    pout, pg = _port_grads(pm, (x, mem), w, causal=causal)
    assert pout[1].shape == (B, H, TQ, TK)
    _hold(jout, jg, pout, pg)


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("gate", [512, 4])
def test_encoder_layer_matches_jax(pre, gate):
    jm, pm = _pair(
        lambda: jnn.TransformerEncoderLayer(D, H, 64, dropout=0.0,
                                            normalize_before=pre),
        lambda: nn.TransformerEncoderLayer(D, H, 64, dropout=0.0,
                                           normalize_before=pre,
                                           device="cpu"))
    x, w = _inputs((B, TK, D), (B, TK, D), seed=2)
    jout, jg = _jax_grads(jm, (x,), w)
    with Flags(flash_attention_min_seq_train=gate):
        pout, pg = _port_grads(pm, (x,), w)
    _hold(jout, jg, pout, pg)


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("gate", [512, 4])
def test_decoder_layer_matches_jax(pre, gate):
    # causal self-attention (no tgt_mask) and attention over a longer
    # memory (Tq != Tk)
    jm, pm = _pair(
        lambda: jnn.TransformerDecoderLayer(D, H, 64, dropout=0.0,
                                            normalize_before=pre),
        lambda: nn.TransformerDecoderLayer(D, H, 64, dropout=0.0,
                                           normalize_before=pre,
                                           device="cpu"))
    x, mem, w = _inputs((B, TQ, D), (B, TK, D), (B, TQ, D), seed=3)
    jout, jg = _jax_grads(jm, (x, mem), w)
    with Flags(flash_attention_min_seq_train=gate):
        pout, pg = _port_grads(pm, (x, mem), w)
    _hold(jout, jg, pout, pg)


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("bthd", [True, False])
def test_transformer_matches_jax_in_both_layouts(pre, bthd):
    ctor = dict(d_model=D, nhead=H, num_encoder_layers=2,
                num_decoder_layers=2, dim_feedforward=64, dropout=0.0,
                normalize_before=pre)
    jm, pm = _pair(lambda: jnn.Transformer(**ctor),
                   lambda: nn.Transformer(**ctor, device="cpu"))
    assert list(jm.param_dict()) == list(pm.param_dict())
    src, tgt, w = _inputs((B, TK, D), (B, TQ, D), (B, TQ, D), seed=4)
    jout, jg = _jax_grads(jm, (src, tgt), w)
    with Flags(flash_attention_min_seq_train=4,
               attention_bthd_layout=bthd):
        pout, pg = _port_grads(pm, (src, tgt), w)
    _hold(jout, jg, pout, pg)


def test_layouts_give_equal_results_with_flash_dropout():
    # the flash mask is a hash of (seed, batch, head, query, key): the
    # [B, H, T, D] views take the same kernels and the same bits
    torch.manual_seed(0)
    pm = nn.Transformer(D, H, 1, 1, 64, dropout=0.1, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    src, tgt = (torch.from_numpy(a) for a in
                _inputs((B, TK, D), (B, TQ, D), seed=5))
    outs = []
    for bthd in (True, False):
        gen = torch.Generator().manual_seed(7)
        with Flags(flash_attention_min_seq_train=4,
                   attention_bthd_layout=bthd), \
                prandom.rng_scope(dropout=gen):
            pm.zero_grad()
            out = pm(src, tgt)
            out.sum().backward()
        outs.append((out.detach(), {n: p.grad.clone()
                                    for n, p in pm.named_parameters()}))
    (a, ga), (b, gb) = outs
    assert torch.allclose(a, b, rtol=0, atol=1e-6)
    for n in ga:
        assert torch.allclose(ga[n], gb[n], rtol=0, atol=1e-6), n


def _encoder(dropout):
    gen = torch.Generator().manual_seed(3)
    return nn.TransformerEncoder(
        lambda: nn.TransformerEncoderLayer(D, H, 64, dropout=dropout,
                                           activation="gelu", device="cpu",
                                           generator=gen), 2,
        norm=nn.LayerNorm(D, device="cpu"))


def _remat_run(remat: bool, gate: int):
    model = _encoder(0.1)
    calls = [0]
    model.layers[0].register_forward_pre_hook(
        lambda layer, args: calls.__setitem__(0, calls[0] + 1))
    step = TrainStep(model, Adam(1e-3), lambda out, w: (out * w).sum(),
                     seed=11)
    x, w = _inputs((B, 24, D), (B, 24, D), seed=6)
    losses = []
    with Flags(transformer_remat=remat, flash_attention_min_seq_train=gate):
        for _ in range(3):
            losses.append(step(torch.from_numpy(x),
                               labels=(torch.from_numpy(w),))["loss"])
    return losses, {n: p.detach().clone()
                    for n, p in model.named_parameters()}, calls[0], step


@pytest.mark.parametrize("gate", [512, 4])
def test_remat_equals_no_remat_with_dropout(gate):
    # dropout 0.1 in the layers' Dropouts and in attention (the flash
    # kernels' seeds at gate 4, the plain composition's masks at 512):
    # the recompute replays the forward's draws, so remat changes nothing
    l0, p0, calls0, s0 = _remat_run(False, gate)
    l1, p1, calls1, s1 = _remat_run(True, gate)
    assert calls0 == 3 and calls1 == 6  # each step recomputed the layer
    assert [float(v) for v in l0] == [float(v) for v in l1]
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n
    assert torch.equal(s0.generator.get_state(), s1.generator.get_state())
    # and dropout was on: another seed gives another loss
    assert len({float(v) for v in l0}) == 3


def test_remat_needs_the_replay():
    # without the replay the recompute draws new masks: the gradient is
    # not the one of the forward that ran (what the replay guards)
    from torch.utils.checkpoint import checkpoint
    model = _encoder(0.5)
    x = torch.from_numpy(_inputs((B, 24, D), seed=7)[0]).requires_grad_()
    gen = torch.Generator().manual_seed(5)
    with prandom.rng_scope(dropout=gen):
        want = torch.autograd.grad(model(x).sum(), x)[0]
    gen.manual_seed(5)
    with prandom.rng_scope(dropout=gen), Flags(transformer_remat=True):
        got = torch.autograd.grad(model(x).sum(), x)[0]
    assert torch.equal(got, want)
    gen.manual_seed(5)
    layer = model.layers[0]
    with prandom.rng_scope(dropout=gen):
        h = checkpoint(layer, x, use_reentrant=False,
                       preserve_rng_state=False)
        h = model.norm(model.layers[1](h))
        bad = torch.autograd.grad(h.sum(), x)[0]
    assert not torch.equal(bad, want)
