"""PyTorch port: ``slim`` (fake quant, QAT, PTQ, int8 deployment) against
the JAX package on the CPU.

- The three fake-quant ops: equal bit for bit to the JAX ops run op by
  op (XLA's jit rewrites ``q * scale / n`` into ``q * scale * (1 / n)``,
  so the jitted ones sit within ``ULP_TOL`` relative), their straight-
  through gradients within ``GRAD_TOL``.
- A 2-layer BERT quantized in both packages: the same 15 wrappers and
  parameter and buffer names; weights and ``act_scale`` buffers carried
  by ``convert.load_jax_params``; one QAT training forward and backward:
  the loss within ``LOSS_TOL``, each gradient within ``GRAD_TOL`` of its
  leaf's largest entry (the key biases at their weight's), every
  ``act_scale`` within ``ULP_TOL``.
- ``convert_to_int8``: JAX's int8 buffers carried by ``convert`` give
  the same ``Int8Linear`` int32 accumulators bit for bit as JAX's
  ``lax.dot_general`` and the outputs within ``LOSS_TOL``; the port's own
  conversion gives JAX's ``w_q`` bit for bit.
- PTQ, the bit widths, the jit.save/Predictor round trip and the
  ``fused_qkv_projection`` behaviour over wrapped projections, as the JAX
  tests of ``tests/test_detection_slim.py``.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as pt  # noqa: E402
from paddle_tpu import slim as js  # noqa: E402
from paddle_tpu.models import BertConfig as JaxBertConfig  # noqa: E402
from paddle_tpu.models import BertForPretraining as JaxBert  # noqa: E402
from paddle_tpu.models import pretraining_loss as jax_loss  # noqa: E402
from paddle_tpu.nn.layer import functional_call  # noqa: E402

from paddle_tpu_torch import jit as pjit  # noqa: E402
from paddle_tpu_torch import nn as pnn  # noqa: E402
from paddle_tpu_torch import set_flags  # noqa: E402
from paddle_tpu_torch import slim as ps  # noqa: E402
from paddle_tpu_torch.convert import load_jax_params  # noqa: E402
from paddle_tpu_torch.inference import Config, create_predictor  # noqa: E402
from paddle_tpu_torch.models import (BertConfig,  # noqa: E402
                                     BertForPretraining, pretraining_loss)

SMALL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=128,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             max_position_embeddings=64)
# one fp32 rounding of a unit-scale value
ULP_TOL = 2.5e-7
# two encoder layers and a 512-way softmax summed in XLA's order and
# torch's (measured ~2e-6)
LOSS_TOL = 2e-5
GRAD_TOL = 5e-5
RNG = np.random.default_rng(0)


def _rel(got, want) -> float:
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


FQ = {
    "abs_max": (js.fake_quantize_abs_max, ps.fake_quantize_abs_max, {}),
    "channel_wise": (js.fake_channel_wise_quantize_abs_max,
                     ps.fake_channel_wise_quantize_abs_max, {"axis": 1}),
    "moving_average": (
        lambda x, **k: js.fake_quantize_moving_average_abs_max(
            x, jnp.float32(1.7), **k),
        lambda x, **k: ps.fake_quantize_moving_average_abs_max(
            x, torch.tensor(1.7), **k), {"momentum": 0.9}),
}


@pytest.mark.parametrize("name", sorted(FQ))
@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quant_ops_match_jax(name, bits):
    jf, pf, kw = FQ[name]
    x = RNG.normal(0, 2, (6, 9)).astype(np.float32)
    x[1, 2] = 0.0
    j_out, j_scale = jf(x, bits=bits, **kw)  # op by op
    p_out, p_scale = pf(torch.from_numpy(x), bits=bits, **kw)
    np.testing.assert_array_equal(p_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(p_scale.numpy(), np.asarray(j_scale))
    jit_out = jax.jit(lambda v: jf(v, bits=bits, **kw)[0])(x)
    assert _rel(p_out, jit_out) <= ULP_TOL
    # the straight-through gradient, scale path included
    jg = jax.jit(jax.grad(lambda v: jnp.sum(jf(v, bits=bits, **kw)[0]
                                            * jnp.asarray(x))))(x)
    t = torch.from_numpy(x).requires_grad_()
    (pf(t, bits=bits, **kw)[0] * torch.from_numpy(x)).sum().backward()
    assert _rel(t.grad, jg) <= GRAD_TOL


def test_ste_round_half_to_even_and_straight_through():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 0.49], requires_grad=True)
    q = ps._ste_round(x)
    np.testing.assert_array_equal(
        q.detach().numpy(), np.round(x.detach().numpy()))
    q.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(6, np.float32))


@pytest.fixture(scope="module")
def qpair():
    pt.seed(0)
    jm = js.quantize_model(JaxBert(JaxBertConfig(**SMALL)))
    pm = ps.quantize_model(BertForPretraining(BertConfig(**SMALL),
                                              device="cpu"))
    load_jax_params(pm, {k: np.asarray(v)
                         for k, v in jm.param_dict().items()},
                    {k: np.asarray(v) for k, v in jm.buffer_dict().items()})
    return jm, pm


def _batch(seed=1, b=2, t=32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (b, t))
    mlm = rng.integers(0, 512, (b, t))
    mlm[:, ::3] = -100
    nsp = rng.integers(0, 2, (b,))
    return ids, mlm, nsp


def test_quantize_model_wraps_like_jax(qpair):
    jm, pm = qpair
    wrapped = [n for n, m in pm.named_modules()
               if isinstance(m, ps.QuantizedLinear)]
    assert len(wrapped) == 2 * 6 + 3 == sum(
        isinstance(m, js.QuantizedLinear) for m in js._walk_layers(jm))
    assert set(jm.param_dict()) == set(dict(pm.named_parameters()))
    assert "bert.encoder.layers.0.linear1.inner.bias" in \
        dict(pm.named_parameters())
    assert set(jm.buffer_dict()) == {n for n, _ in pm.named_buffers()}
    assert all(n.endswith("act_scale") for n, _ in pm.named_buffers())


def test_qat_step_matches_jax(qpair):
    """One training forward and backward: the loss, the straight-through
    gradients and the EMA act_scales the step writes."""
    jm, pm = qpair
    ids, mlm, nsp = _batch()
    before = {n: b.clone() for n, b in pm.named_buffers()}

    def jl(params, buffers):
        out, nb = functional_call(jm, params, buffers, jnp.asarray(ids),
                                  capture_buffers=True)
        return jax_loss(out, jnp.asarray(mlm), jnp.asarray(nsp)), nb

    (jv, jnb), jg = jax.jit(jax.value_and_grad(jl, has_aux=True))(
        jm.param_dict(), jm.buffer_dict())
    pm.train()
    pm.zero_grad(set_to_none=True)
    try:
        loss = pretraining_loss(pm(torch.from_numpy(ids)),
                                torch.from_numpy(mlm),
                                torch.from_numpy(nsp))
        loss.backward()
        assert abs(float(loss.detach()) - float(jv)) <= \
            LOSS_TOL * abs(float(jv))
        for n, p in pm.named_parameters():
            want = np.asarray(jg[n])
            if p.grad is None:  # no token types given: JAX's is zero
                assert not want.any(), n
                continue
            scale_of = n.replace("k_proj.inner.bias", "k_proj.inner.weight")
            scale = max(float(np.abs(np.asarray(jg[scale_of])).max()), 1e-30)
            gap = float(np.abs(p.grad.numpy() - want).max()) / scale
            assert gap <= GRAD_TOL, (n, gap)
        for n, b in pm.named_buffers():
            assert not torch.equal(b, before[n]), n  # the EMA moved
            assert _rel(b, jnb[n]) <= ULP_TOL, n
    finally:
        with torch.no_grad():
            for n, b in pm.named_buffers():
                b.copy_(before[n])


def _jax_int8_acc(layer, x):
    """The int32 accumulator JAX's Int8Linear.forward forms."""
    xf = jnp.asarray(x).reshape(-1, x.shape[-1]).astype(jnp.float32)
    inv = layer.n_act / jnp.maximum(layer.act_scale, 1e-8)
    xq = jnp.clip(jnp.round(xf * inv), -layer.n_act,
                  layer.n_act).astype(jnp.int8)
    return jax.lax.dot_general(xq, layer.w_q, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)


def test_int8_conversion_matches_jax():
    """QAT-calibrated scales, then convert_to_int8 in both packages: the
    port's conversion gives JAX's w_q/w_scale, JAX's int8 buffers carried
    by convert give the same int32 accumulators bit for bit, and the
    outputs agree."""
    pt.seed(3)

    class Net(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = pt.nn.Linear(8, 16)
            self.fc2 = pt.nn.Linear(16, 4)

        def forward(self, x):
            return self.fc2(pt.nn.functional.relu(self.fc1(x)))

    class PNet(pnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = pnn.Linear(8, 16, device="cpu")
            self.fc2 = pnn.Linear(16, 4, device="cpu")

        def forward(self, x):
            return self.fc2(torch.relu(self.fc1(x)))

    jnet, pnet = js.quantize_model(Net()), ps.quantize_model(PNet())
    load_jax_params(pnet, {k: np.asarray(v)
                           for k, v in jnet.param_dict().items()},
                    {k: np.asarray(v)
                     for k, v in jnet.buffer_dict().items()})
    x = RNG.normal(0, 1, (32, 8)).astype(np.float32)
    jnet.train()
    pnet.train()
    with torch.no_grad():
        for _ in range(5):
            jnet(x)
            pnet(torch.from_numpy(x))
    jnet.eval()
    pnet.eval()
    js.convert_to_int8(jnet)
    ps.convert_to_int8(pnet)
    jb = {k: np.asarray(v) for k, v in jnet.buffer_dict().items()}
    own = dict(pnet.named_buffers())
    assert set(jb) == set(own)
    assert own["fc1.w_q"].dtype == torch.int8
    np.testing.assert_array_equal(own["fc1.w_q"].numpy(), jb["fc1.w_q"])
    np.testing.assert_array_equal(own["fc2.w_q"].numpy(), jb["fc2.w_q"])
    for k in ("fc1.w_scale", "fc1.act_scale", "fc2.act_scale"):
        assert _rel(own[k], jb[k]) <= ULP_TOL, k
    # JAX's deployment buffers carried across exactly
    load_jax_params(pnet, {}, jb)
    h = RNG.normal(0, 1, (5, 3, 8)).astype(np.float32)
    acc = pnet.fc1.accumulate(torch.from_numpy(h))
    want = np.asarray(_jax_int8_acc(jnet._sub_layers["fc1"], h))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want)
    with torch.no_grad():
        got = pnet(torch.from_numpy(h))
    assert got.shape == (5, 3, 4)
    assert _rel(got, jax.jit(lambda v: jnet(v))(h)) <= LOSS_TOL


def test_bert_int8_through_convert_matches_jax():
    """A 2-layer BERT quantized, calibrated by one training forward and
    converted to int8 in JAX: its int8 buffers carried by convert into the
    port's converted twin give every Int8Linear's int32 accumulator bit
    for bit and the MLM logits within LOSS_TOL."""
    pt.seed(4)
    jm = js.quantize_model(JaxBert(JaxBertConfig(**SMALL)))
    pm = ps.quantize_model(BertForPretraining(BertConfig(**SMALL),
                                              device="cpu"))
    load_jax_params(pm, {k: np.asarray(v)
                         for k, v in jm.param_dict().items()},
                    {k: np.asarray(v) for k, v in jm.buffer_dict().items()})
    ids = _batch(seed=5)[0]
    jm.train()
    _, moved = jax.jit(lambda p, b, v: functional_call(
        jm, p, b, v, capture_buffers=True))(
        jm.param_dict(), jm.buffer_dict(), jnp.asarray(ids))
    jm.set_state_dict(dict(moved), strict=False)  # the EMA act_scales
    assert all(float(v) != 1.0 for v in jm.buffer_dict().values())
    jm.eval()
    pm.eval()
    js.convert_to_int8(jm)
    ps.convert_to_int8(pm)
    load_jax_params(pm, {k: np.asarray(v)
                         for k, v in jm.param_dict().items()},
                    {k: np.asarray(v) for k, v in jm.buffer_dict().items()})
    inputs = {}
    hooks = [m.register_forward_pre_hook(
        lambda mod, a, n=n: inputs.__setitem__(n, a[0].detach()))
        for n, m in pm.named_modules() if isinstance(m, ps.Int8Linear)]
    with torch.no_grad():
        got = pm(torch.from_numpy(ids))[0]
    for h in hooks:
        h.remove()
    assert len(inputs) == 15
    want = jax.jit(lambda v: jm(v)[0])(jnp.asarray(ids))
    assert _rel(got, want) <= LOSS_TOL
    for name, x in inputs.items():
        jl = jm
        for part in name.split("."):
            jl = jl._sub_layers[part]
        acc = dict(pm.named_modules())[name].accumulate(x)
        np.testing.assert_array_equal(
            acc.numpy(), np.asarray(_jax_int8_acc(jl, x.numpy())),
            err_msg=name)


def test_int8_linear_matches_fake_quant():
    """The JAX test's check on the port: the int8 grid against the
    fake-quant grid of the same calibrated model (mean |gap| < 0.05 x
    mean |output|)."""
    torch.manual_seed(0)
    net = pnn.Sequential(pnn.Linear(8, 16, device="cpu"), pnn.ReLU(),
                         pnn.Linear(16, 4, device="cpu"))
    ps.quantize_model(net)
    x = torch.from_numpy(RNG.normal(0, 1, (32, 8)).astype(np.float32))
    net.train()
    with torch.no_grad():
        for _ in range(5):
            net(x)
        net.eval()
        want = net(x)
        ps.convert_to_int8(net)
        assert isinstance(net[0], ps.Int8Linear)
        got = net(x)
    assert float((got - want).abs().mean()) < \
        0.05 * float(want.abs().mean())


def test_int8_matmul_is_exact_integer_arithmetic():
    a = torch.randint(-127, 128, (3, 3072), dtype=torch.int8)
    b = torch.randint(-127, 128, (3072, 5), dtype=torch.int8)
    a[0] = 127
    b[:, 0] = 127
    got = ps.int8_matmul(a, b)
    assert got.dtype == torch.int32
    assert int(got[0, 0]) == 127 * 127 * 3072  # beyond fp32's 2^24
    np.testing.assert_array_equal(got.numpy(), a.numpy().astype(np.int64)
                                  @ b.numpy().astype(np.int64))


def test_ptq_matches_jax():
    """PostTrainingQuantization: the calibrated output scale and the
    rounded weights equal JAX's on the same Linear and batches."""
    pt.seed(0)
    jlin = pt.nn.Linear(8, 4)
    plin = pnn.Linear(8, 4, device="cpu")
    load_jax_params(plin, {k: np.asarray(v)
                           for k, v in jlin.param_dict().items()})
    batches = [RNG.random((4, 8)).astype(np.float32) for _ in range(3)]
    jptq = js.PostTrainingQuantization(jlin).calibrate(batches)
    pptq = ps.PostTrainingQuantization(plin).calibrate(
        [torch.from_numpy(b) for b in batches])
    assert abs(pptq.act_scales["output"] - jptq.act_scales["output"]) <= \
        1e-6 * jptq.act_scales["output"]
    before = plin.weight.detach().clone()
    jptq.quantize()
    pptq.quantize()
    assert not torch.equal(before, plin.weight)
    np.testing.assert_array_equal(plin.weight.detach().numpy(),
                                  np.asarray(jlin.weight))


def test_ptq_eval_mode_calibrates_act_scales():
    torch.manual_seed(2)
    net = pnn.Sequential(pnn.Linear(4, 8, device="cpu"), pnn.ReLU(),
                         pnn.Linear(8, 2, device="cpu"))
    ps.quantize_model(net)
    net.eval()
    x = torch.from_numpy((10.0 * RNG.normal(0, 1, (16, 4)))
                         .astype(np.float32))
    ps.PostTrainingQuantization(net).calibrate([x, x])
    assert float(net[0].act_scale) > 2.0
    assert not net[0].training  # the mode came back
    with torch.no_grad():
        want = net(x)
        ps.convert_to_int8(net)
        got = net(x)
    assert float((got - want).abs().mean()) < 0.1 * float(want.abs().mean())


def test_int8_conversion_honors_bit_width():
    lin = ps.QuantizedLinear(pnn.Linear(4, 3, device="cpu"), weight_bits=4,
                             activation_bits=6)
    layer = ps.Int8Linear.from_quantized(lin)
    assert layer.n_weight == 7.0 and layer.n_act == 31.0
    assert int(layer.w_q.abs().max()) <= 7
    with pytest.raises(ValueError, match="at most 8 bits"):
        ps.Int8Linear.from_quantized(ps.QuantizedLinear(
            pnn.Linear(4, 3, device="cpu"), weight_bits=16))


def test_int8_model_exports_and_serves(tmp_path):
    """The int8 model through jit.save and the Predictor (its weights as
    int8 buffers in the artifact), as the JAX test takes it through
    serving."""
    torch.manual_seed(1)
    net = pnn.Sequential(pnn.Linear(6, 12, device="cpu"), pnn.ReLU(),
                         pnn.Linear(12, 3, device="cpu"))
    ps.quantize_model(net)
    x = RNG.normal(0, 1, (4, 6)).astype(np.float32)
    net.train()
    with torch.no_grad():
        net(torch.from_numpy(x))
    net.eval()
    ps.convert_to_int8(net)
    with torch.no_grad():
        want = net(torch.from_numpy(x)).numpy()
    d = str(tmp_path / "int8_artifact")
    pjit.save(net, d, input_spec=[pjit.InputSpec([None, 6])])
    got = create_predictor(Config(d, device="cpu")).run([x])[0]
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


def test_fused_qkv_over_wrapped_projections_raises_as_jax(qpair):
    """fused_qkv_projection reads q_proj.in_features, which a
    QuantizedLinear does not have: both packages raise AttributeError."""
    jm, pm = qpair
    ids = _batch()[0]
    set_flags({"fused_qkv_projection": True})
    pt.set_flags({"fused_qkv_projection": True})
    try:
        with pytest.raises(AttributeError, match="in_features"):
            jm(jnp.asarray(ids))
        with pytest.raises(AttributeError, match="in_features"):
            with torch.no_grad():
                pm(torch.from_numpy(ids))
    finally:
        set_flags({"fused_qkv_projection": False})
        pt.set_flags({"fused_qkv_projection": False})
