"""PyTorch port: the fused linear + softmax cross-entropy against the JAX
package on the CPU.

The CUDA kernels run only on a GPU (``python3 chip_smoke.py`` holds them
against their plain version there). Here the port's plain version is
held against the Pallas kernels in interpret mode, forward and
``jax.grad``, on the same numpy inputs (the shapes of
``tests/test_fused_loss.py``: ragged rows, vocab remainders, ignored rows,
no bias); the flag's routing; ``FusedLinearCrossEntropy``; and a small
BERT whose MLM head hands ``MLMHeadOutput`` to the loss, against the JAX
BERT with the fused head on (its kernel in interpret mode) or off.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as pt  # noqa: E402
from paddle_tpu import kernels as jax_kernels  # noqa: E402
from paddle_tpu.kernels import fused_softmax_xent as jax_fx  # noqa: E402
from paddle_tpu.models import BertConfig as JaxBertConfig  # noqa: E402
from paddle_tpu.models import BertForPretraining as JaxBert  # noqa: E402
from paddle_tpu.models import pretraining_loss as jax_pretraining_loss  # noqa: E402,E501

from paddle_tpu_torch import kernels, set_flags  # noqa: E402
from paddle_tpu_torch.convert import load_jax_params  # noqa: E402
from paddle_tpu_torch.kernels import fused_softmax_xent as fx  # noqa: E402
from paddle_tpu_torch.models import (BertConfig,  # noqa: E402
                                     BertForPretraining, MLMHeadOutput,
                                     pretraining_loss)
from paddle_tpu_torch.nn import FusedLinearCrossEntropy  # noqa: E402

# fp32: the loss as the JAX kernel test holds it against its reference;
# gradients summed over up to 1024 vocab columns in another order
LOSS_TOL = 2e-6
GRAD_TOL = 1e-5
# the small BERT, as tests/test_torch_bert.py holds it
BERT_LOSS_TOL = 2e-5
BERT_GRAD_TOL = 5e-5

# ragged rows (14, 13, 15), vocab one chunk short, one past, exact
SHAPES = [((2, 7), 300, 32), ((1, 13), 513, 64), ((3, 5), 1024, 48)]


def _case(lead, v, h, ignore_frac=0.3, seed=0):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((*lead, h)).astype(np.float32)
    weight = (rng.standard_normal((v, h)) * 0.5).astype(np.float32)
    bias = rng.standard_normal((v,)).astype(np.float32)
    labels = rng.integers(0, v, lead).astype(np.int64)
    labels = np.where(rng.random(lead) < ignore_frac, -100, labels)
    labels.reshape(-1)[0] = -100  # at least one ignored row
    ct = rng.standard_normal(lead).astype(np.float32)
    return hidden, weight, bias, labels, ct


@pytest.mark.parametrize("lead,v,h,with_bias", [
    *(shape + (True,) for shape in SHAPES), SHAPES[0] + (False,)])
def test_plain_matches_jax_kernel(lead, v, h, with_bias):
    hidden, weight, bias, labels, ct = _case(lead, v, h, seed=v + h)
    bias = bias if with_bias else None

    def jax_loss(*a):
        out = jax_fx.fused_linear_softmax_xent(
            a[0], a[1], a[2] if with_bias else None, jnp.asarray(labels),
            interpret=True)
        return jnp.sum(out * ct), out

    args = [jnp.asarray(a) for a in (hidden, weight, bias) if a is not None]
    (_, want), jgrads = jax.value_and_grad(
        jax_loss, argnums=tuple(range(len(args))), has_aux=True)(*args)

    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (hidden, weight, bias) if a is not None]
    got = fx.fused_linear_xent_plain(
        leaves[0], leaves[1], leaves[2] if with_bias else None,
        torch.from_numpy(labels))
    (got * torch.from_numpy(ct)).sum().backward()

    assert got.shape == lead
    assert np.max(np.abs(got.detach().numpy() - np.asarray(want))) \
        <= LOSS_TOL
    assert np.all(got.detach().numpy()[labels == -100] == 0.0)
    for name, t, jg in zip(("dh", "dw", "db"), leaves, jgrads):
        err = np.max(np.abs(t.grad.numpy() - np.asarray(jg)))
        assert err <= GRAD_TOL, (name, err)
    # an ignored row gets no gradient
    assert np.all(leaves[0].grad.numpy()[labels == -100] == 0.0)


def test_router_flag_on_and_off_agree_and_the_cpu_counts_nothing():
    hidden, weight, bias, labels, ct = _case((3, 7), 300, 32, seed=3)
    outs, grads = [], []
    kernels.reset_launch_counts()
    for flag in (False, True):
        set_flags({"fused_softmax_xent": flag})
        try:
            assert kernels.fused_softmax_xent_enabled() is flag
            leaves = [torch.from_numpy(a).requires_grad_()
                      for a in (hidden, weight, bias)]
            out = kernels.maybe_fused_linear_xent(
                *leaves, torch.from_numpy(labels))
            (out * torch.from_numpy(ct)).sum().backward()
        finally:
            set_flags({"fused_softmax_xent": False})
        outs.append(out.detach())
        grads.append([t.grad for t in leaves])
    assert outs[0].shape == outs[1].shape == (3, 7)
    assert float((outs[0] - outs[1]).abs().max()) <= LOSS_TOL
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= GRAD_TOL
    assert not any(kernels.launch_counts().values())


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_fused_linear_cross_entropy_layer_matches_jax(reduction):
    hidden, weight, bias, labels, _ = _case((3, 7), 300, 32, seed=5)
    want = pt.nn.FusedLinearCrossEntropy(reduction=reduction)(
        jnp.asarray(hidden), jnp.asarray(weight), jnp.asarray(labels),
        bias=jnp.asarray(bias))
    layer = FusedLinearCrossEntropy(reduction=reduction)
    for flag in (False, True):
        set_flags({"fused_softmax_xent": flag})
        try:
            got = layer(torch.from_numpy(hidden), torch.from_numpy(weight),
                        torch.from_numpy(labels),
                        bias=torch.from_numpy(bias))
        finally:
            set_flags({"fused_softmax_xent": False})
        assert got.shape == np.shape(want)
        assert np.max(np.abs(got.numpy() - np.asarray(want))) <= LOSS_TOL


def test_cuda_wrappers_refuse_cpu_tensors():
    h, w = torch.randn(4, 8), torch.randn(10, 8)
    lab = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        fx.fused_linear_xent(h, w, None, lab)
    with pytest.raises(ValueError, match="CUDA"):
        fx.xent_fwd(h, w, None, lab)
    lse, g = torch.zeros(4), torch.ones(4)
    for need_dh, need_dw in ((True, True), (True, False), (False, True)):
        with pytest.raises(ValueError, match="CUDA"):
            fx.xent_bwd(h, w, None, lab, lse, g, need_dh=need_dh,
                        need_dw=need_dw)


@pytest.mark.parametrize("n,v,sms,splits", [
    (4096, 30522, 132, 239), (77, 300, 132, 3), (64, 64, 132, 1),
    (100000, 30522, 132, 239), (1000, 513, 132, 5), (300, 1000, 132, 8),
    (4096, 30522, 16, 1)])
def test_forward_vocab_splits(n, v, sms, splits):
    # one (128-row tile, split) block per SM; the split count whose waves
    # end soonest, at most one split per 128-column vocab tile: at
    # BERT-base's MLM head 32 row tiles x 239 splits fill 57.9 waves of
    # 132 blocks (58 waves of one tile each)
    assert fx.vocab_splits(n, v, sms) == splits
    tiles, rows = -(-v // 128), -(-n // 128)

    def cost(s):
        return -(-rows * s // sms) * -(-tiles // s)
    assert all(cost(splits) <= cost(s) for s in range(1, tiles + 1))


# (N, V, H, bias, splits, labels in the last ragged tile): V = 300 is 3
# vocab tiles, the last of 44 columns; 4 splits of one tile leave the last
# split without a column; 2 splits give one two tiles
SPLIT_CASES = [(14, 300, 32, True, 4, True), (13, 300, 48, False, 4, True),
               (21, 513, 64, True, 2, False),
               (9, 1024, 16, True, fx.vocab_splits(9, 1024, 132), False)]


@pytest.mark.parametrize("n,v,h,with_bias,splits,last_tile", SPLIT_CASES)
def test_forward_split_merge_matches_jax_fwd_kernel(n, v, h, with_bias,
                                                    splits, last_tile):
    # the forward kernels' decomposition (partials per vocab split, then
    # the merge) against the JAX _fwd_kernel in interpret mode, with the
    # tiles fused_linear_softmax_xent picks
    hidden, weight, bias, labels, _ = _case((n,), v, h, seed=n + v)
    if last_tile:
        labels[1:4] = [v - 1, 256, v - 40]  # inside the last ragged tile
    bn = min(jax_fx._ROW_BLOCK, jax_fx._ceil_to(n, 8))
    bv = min(jax_fx._VOCAB_BLOCK, jax_fx._ceil_to(v, 128))
    b2 = jnp.asarray(bias) if with_bias else jnp.zeros((v,), jnp.float32)
    want_loss, want_lse = jax_fx._forward(
        jnp.asarray(hidden), jnp.asarray(weight), b2,
        jnp.asarray(labels.astype(np.int32)), -100, bn, bv, True)
    loss, lse = fx.fused_xent_fwd_split_plain(
        torch.from_numpy(hidden), torch.from_numpy(weight),
        torch.from_numpy(bias) if with_bias else None,
        torch.from_numpy(labels), splits)
    used = labels != -100
    assert np.max(np.abs(loss.numpy() - np.asarray(want_loss))) <= LOSS_TOL
    assert np.max(np.abs(lse.numpy()[used] - np.asarray(want_lse)[used])) \
        <= LOSS_TOL
    assert np.all(loss.numpy()[~used] == 0.0)  # ignored rows: exactly 0
    # the same function as the materialised plain version
    ploss, plse = fx.fused_linear_xent_plain(
        torch.from_numpy(hidden), torch.from_numpy(weight),
        torch.from_numpy(bias) if with_bias else None,
        torch.from_numpy(labels), return_lse=True)
    assert float((loss - ploss).abs().max()) <= LOSS_TOL
    assert float((lse - plse).abs().max()) <= LOSS_TOL


def test_forward_split_without_a_column_is_neutral():
    # a split past the last vocab tile contributes (-1e30, 0, 0): the
    # result is that of the splits that hold columns
    hidden, weight, bias, labels, _ = _case((6,), 300, 16, seed=11)
    args = [torch.from_numpy(a) for a in (hidden, weight, bias, labels)]
    a = fx.fused_xent_fwd_split_plain(*args, splits=3)
    b = fx.fused_xent_fwd_split_plain(*args, splits=4)
    assert -(-3 // 4) * 3 == 3  # 4 splits of one tile: the last is empty
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# --- a small BERT with the fused head --------------------------------------

SMALL = dict(vocab_size=300, hidden_size=32, num_hidden_layers=1,
             num_attention_heads=2, intermediate_size=64,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             max_position_embeddings=16)


@pytest.fixture
def bert_pair():
    pt.seed(0)
    jm = JaxBert(JaxBertConfig(**SMALL))
    pm = BertForPretraining(BertConfig(**SMALL), device="cpu")
    load_jax_params(pm, {k: np.asarray(v)
                         for k, v in jm.param_dict().items()})
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 300, (2, 16)).astype(np.int32)
    mlm = rng.integers(0, 300, (2, 16)).astype(np.int64)
    mlm[0, :8] = -100
    nsp = rng.integers(0, 2, (2,)).astype(np.int64)
    return jm, pm, (ids, mlm, nsp)


@pytest.mark.parametrize("jax_fused", [True, False])
def test_bert_fused_head_matches_jax(bert_pair, monkeypatch, jax_fused):
    jm, pm, (ids, mlm, nsp) = bert_pair
    if jax_fused:
        monkeypatch.setattr(jax_kernels, "_on_tpu", lambda: True)
        monkeypatch.setattr(
            jax_fx, "fused_linear_softmax_xent",
            functools.partial(jax_fx.fused_linear_softmax_xent,
                              interpret=True))
        pt.set_flags({"fused_softmax_xent": True})

    def jax_loss(params):
        from paddle_tpu.nn.layer import functional_call
        out = functional_call(jm, params, jm.buffer_dict(),
                              jnp.asarray(ids))
        return jax_pretraining_loss(out, jnp.asarray(mlm),
                                    jnp.asarray(nsp))

    try:
        # one XLA program: the same function, compiled once, not op by op
        jl, jgrads = jax.jit(jax.value_and_grad(jax_loss))(jm.param_dict())
    finally:
        pt.set_flags({"fused_softmax_xent": False})
    set_flags({"fused_softmax_xent": True})
    try:
        out = pm(torch.from_numpy(ids).long())
        assert isinstance(out[0], MLMHeadOutput)
        assert out[0].weight is pm.bert.embeddings.word_embeddings.weight
        loss = pretraining_loss(out, torch.from_numpy(mlm),
                                torch.from_numpy(nsp))
        loss.backward()
    finally:
        set_flags({"fused_softmax_xent": False})
    assert abs(float(loss.detach()) - float(jl)) <= BERT_LOSS_TOL
    params = dict(pm.named_parameters())
    for name, g in jgrads.items():
        if params[name].grad is None:  # the token-type embedding
            assert not np.any(np.asarray(g)), name
            continue
        err = np.max(np.abs(params[name].grad.numpy() - np.asarray(g)))
        assert err <= BERT_GRAD_TOL, (name, err)
