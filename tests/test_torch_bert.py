"""PyTorch port: BERT pretraining (model, loss, AdamW, TrainStep) against
the JAX package on the CPU.

A small BERT (2 layers, hidden 64, 2 heads, vocab 512, seq 32, dropout
0) is built in the JAX package and its ``param_dict()`` moved into the
port by name; both run in fp32 on the same numpy batch. The JAX model
runs its XLA attention on the CPU; the port runs its plain attention, or
with ``flash_attention_min_seq_train`` at 16 the plain version of its
flash kernels, which must agree too.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as pt  # noqa: E402
from paddle_tpu.models import BertConfig as JaxBertConfig  # noqa: E402
from paddle_tpu.models import BertForPretraining as JaxBert  # noqa: E402
from paddle_tpu.models import pretraining_loss as jax_pretraining_loss  # noqa: E402,E501
from paddle_tpu.ops import loss as jax_L  # noqa: E402
from paddle_tpu.optimizer import Adam as JaxAdam  # noqa: E402
from paddle_tpu.optimizer import AdamW as JaxAdamW  # noqa: E402
from paddle_tpu.static import TrainStep as JaxTrainStep  # noqa: E402

from paddle_tpu_torch import get_flags, set_flags  # noqa: E402
from paddle_tpu_torch.convert import load_jax_params  # noqa: E402
from paddle_tpu_torch.models import (BertConfig,  # noqa: E402
                                     BertForPretraining, pretraining_loss)
from paddle_tpu_torch.nn import Dropout  # noqa: E402
from paddle_tpu_torch.ops import loss as L  # noqa: E402
from paddle_tpu_torch.optimizer import Adam, AdamW  # noqa: E402
from paddle_tpu_torch.static import TrainStep  # noqa: E402

SMALL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=128,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             max_position_embeddings=64)
B, T, P = 2, 32, 6
# fp32 forward through two encoder layers and a 512-way softmax, summed
# in another order than XLA's
LOGIT_TOL = 2e-5
LOSS_TOL = 2e-5
GRAD_TOL = 5e-5


def _no_decay(name: str) -> bool:
    return not (name.endswith(".bias") or "norm" in name)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (B, T)).astype(np.int32)
    types = rng.integers(0, 2, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, 24:] = 0
    pos = np.sort(rng.permuted(np.broadcast_to(np.arange(T), (B, T)),
                               axis=1)[:, :P], axis=1).astype(np.int32)
    mlm = rng.integers(0, 512, (B, P)).astype(np.int64)
    mlm[0, 1] = mlm[1, 4] = -100  # ignored positions
    nsp = rng.integers(0, 2, (B,)).astype(np.int64)
    return ids, types, mask, pos, mlm, nsp


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


@pytest.fixture
def pair():
    pt.seed(0)
    jm = JaxBert(JaxBertConfig(**SMALL))
    pm = BertForPretraining(BertConfig(**SMALL), device="cpu")
    # strict by name and shape: the tied decoder weight appears once (as
    # the word embedding) and cls.decoder_bias on its own
    load_jax_params(pm, {k: np.asarray(v)
                         for k, v in jm.param_dict().items()})
    return jm, pm


def test_param_names_load_by_name(pair):
    jm, pm = pair
    names = set(jm.param_dict())
    assert names == set(dict(pm.named_parameters()))
    assert "cls.decoder_bias" in names
    assert not any("decoder.weight" in n for n in names)


@pytest.mark.parametrize("gate", [512, 16])
def test_logits_loss_and_grads_match_jax(pair, gate):
    jm, pm = pair
    ids, types, mask, pos, mlm, nsp = _batch()

    def jax_loss(params):
        from paddle_tpu.nn.layer import functional_call
        out = functional_call(jm, params, jm.buffer_dict(),
                              jnp.asarray(ids), jnp.asarray(types),
                              jnp.asarray(mask), jnp.asarray(pos))
        return jax_pretraining_loss(out, jnp.asarray(mlm),
                                    jnp.asarray(nsp)), out

    # one XLA program: the same function, compiled once, not op by op
    (jl, jout), jgrads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(jm.param_dict())
    set_flags({"flash_attention_min_seq_train": gate})
    try:
        out = pm(_t(ids), _t(types), _t(mask), _t(pos))
        loss = pretraining_loss(out, _t(mlm), _t(nsp))
        loss.backward()
    finally:
        set_flags({"flash_attention_min_seq_train": 512})
    assert out[0].shape == (B, P, 512) and out[1].shape == (B, 2)
    for a, e in zip(out, jout):
        assert np.max(np.abs(a.detach().numpy() - np.asarray(e))) \
            <= LOGIT_TOL
    assert abs(float(loss.detach()) - float(jl)) <= LOSS_TOL
    params = dict(pm.named_parameters())
    for name, g in jgrads.items():
        err = np.max(np.abs(params[name].grad.numpy() - np.asarray(g)))
        assert err <= GRAD_TOL, (name, err)


def test_ten_step_train_trajectory_matches_jax(pair):
    jm, pm = pair
    kw = dict(learning_rate=1e-3, weight_decay=0.01,
              apply_decay_param_fun=_no_decay)
    jstep = JaxTrainStep(jm, JaxAdamW(**kw), lambda out, m, n:
                         jax_pretraining_loss(out, m, n))
    pstep = TrainStep(pm, AdamW(**kw), pretraining_loss)
    jl, pl = [], []
    for i in range(10):
        ids, types, mask, pos, mlm, nsp = _batch(seed=i)
        jl.append(float(jstep(jnp.asarray(ids), jnp.asarray(types),
                              jnp.asarray(mask), jnp.asarray(pos),
                              labels=(jnp.asarray(mlm),
                                      jnp.asarray(nsp)))["loss"]))
        pl.append(float(pstep(_t(ids), _t(types), _t(mask), _t(pos),
                              labels=(_t(mlm), _t(nsp)))["loss"]))
    # fp32 noise through ten Adam steps: ~2e-6 relative on a loss of ~6
    assert np.max(np.abs(np.array(pl) - np.array(jl))) <= 1e-5, (pl, jl)
    assert pl[-1] < pl[0]
    assert int(pstep.state["step"]) == 10
    jstep.sync_to_model()
    own = dict(pm.named_parameters())
    for name, v in jm.param_dict().items():
        if name.endswith("k_proj.bias"):
            # softmax ignores a per-query constant, so the key bias has an
            # exactly-zero gradient; both sides see only fp32 noise, which
            # Adam's normalisation turns into steps of up to lr
            continue
        assert np.max(np.abs(own[name].detach().numpy()
                             - np.asarray(v))) <= 1e-5, name


def test_skip_step_guard_discards_a_poisoned_update(pair):
    _, pm = pair
    assert get_flags("skip_nonfinite_steps")["skip_nonfinite_steps"]
    step = TrainStep(pm, AdamW(learning_rate=1e-3),
                     lambda out, m, n, s: pretraining_loss(out, m, n) * s)
    ids, types, mask, pos, mlm, nsp = _batch()
    args = (_t(ids), _t(types), _t(mask), _t(pos))
    one = torch.tensor(1.0)
    step(*args, labels=(_t(mlm), _t(nsp), one))
    before = {n: p.detach().clone() for n, p in pm.named_parameters()}
    moments = {n: {k: t.clone() for k, t in s.items()}
               for n, s in step.state["slots"].items()}
    out = step(*args, labels=(_t(mlm), _t(nsp), torch.tensor(np.inf)))
    assert not torch.isfinite(out["loss"])
    for n, p in pm.named_parameters():
        assert torch.equal(p, before[n]), n
        for k, t in step.state["slots"][n].items():
            assert torch.equal(t, moments[n][k]), (n, k)
    assert int(step.state["step"]) == 1
    assert int(step.nonfinite_steps) == 1
    step(*args, labels=(_t(mlm), _t(nsp), one))
    assert int(step.state["step"]) == 2
    assert not torch.equal(pm.cls.decoder_bias, before["cls.decoder_bias"])


# a parameter the loss does not reach without token_type_ids
TOKEN_TYPES = "bert.embeddings.token_type_embeddings.weight"


def test_ten_steps_without_token_types_match_jax(pair):
    # without token_type_ids their embedding gets no gradient; JAX gives
    # it a zero one, so AdamW decays it (and its zero moments stay zero):
    # TrainStep does the same, and every parameter follows JAX
    jm, pm = pair
    kw = dict(learning_rate=1e-3, weight_decay=0.01,
              apply_decay_param_fun=_no_decay)
    jstep = JaxTrainStep(jm, JaxAdamW(**kw), lambda out, m, n:
                         jax_pretraining_loss(out, m, n))
    pstep = TrainStep(pm, AdamW(**kw), pretraining_loss)
    start = dict(pm.named_parameters())[TOKEN_TYPES].detach().clone()
    for i in range(10):
        ids, _, mask, pos, mlm, nsp = _batch(seed=i)
        jstep(jnp.asarray(ids), attention_mask=jnp.asarray(mask),
              masked_positions=jnp.asarray(pos),
              labels=(jnp.asarray(mlm), jnp.asarray(nsp)))
        pstep(_t(ids), attention_mask=_t(mask), masked_positions=_t(pos),
              labels=(_t(mlm), _t(nsp)))
    jstep.sync_to_model()
    own = dict(pm.named_parameters())
    assert not torch.equal(own[TOKEN_TYPES], start)  # decayed
    for name in (TOKEN_TYPES,):
        for k in ("m", "v"):
            assert not pstep.state["slots"][name][k].any()
    for name, v in jm.param_dict().items():
        if name.endswith("k_proj.bias"):
            # an exactly-zero gradient that both sides see as fp32 noise
            # (test_ten_step_train_trajectory_matches_jax)
            continue
        assert np.max(np.abs(own[name].detach().numpy()
                             - np.asarray(v))) <= 1e-5, name


def test_skip_step_guard_keeps_a_parameter_without_gradient(pair):
    _, pm = pair
    step = TrainStep(pm, AdamW(learning_rate=1e-3),
                     lambda out, m, n, s: pretraining_loss(out, m, n) * s)
    ids, _, mask, pos, mlm, nsp = _batch()
    kw = dict(attention_mask=_t(mask), masked_positions=_t(pos))
    one = torch.tensor(1.0)
    step(_t(ids), labels=(_t(mlm), _t(nsp), one), **kw)
    p = dict(pm.named_parameters())[TOKEN_TYPES]
    before = p.detach().clone()
    step(_t(ids), labels=(_t(mlm), _t(nsp), torch.tensor(np.inf)), **kw)
    assert torch.equal(p, before)
    assert int(step.state["step"]) == 1
    assert int(step.nonfinite_steps) == 1
    step(_t(ids), labels=(_t(mlm), _t(nsp), one), **kw)
    assert int(step.state["step"]) == 2
    assert not torch.equal(p, before)  # AdamW decays it again


@pytest.mark.parametrize("cls_pair", ["adam", "adamw"])
def test_optimizer_update_matches_jax(cls_pair):
    rng = np.random.default_rng(2)
    params = {"fc.weight": rng.standard_normal((5, 3), np.float32),
              "fc.bias": rng.standard_normal(3).astype(np.float32)}
    if cls_pair == "adam":
        jopt, popt = (c(learning_rate=0.01, weight_decay=0.1)
                      for c in (JaxAdam, Adam))
    else:
        kw = dict(learning_rate=0.01, weight_decay=0.2,
                  apply_decay_param_fun=_no_decay)
        jopt, popt = JaxAdamW(**kw), AdamW(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    pstate = popt.init(pp)
    for i in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in params.items()}
        jp, jstate = jopt.apply_gradients(
            jp, {k: jnp.asarray(g) for k, g in grads.items()}, jstate)
        popt.apply_gradients(pp, {k: torch.from_numpy(g)
                                  for k, g in grads.items()}, pstate)
    for k in params:
        assert np.max(np.abs(pp[k].numpy() - np.asarray(jp[k]))) <= 1e-6, k


def test_cross_entropy_means_over_every_position():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 5, 7)).astype(np.float32)
    labels = rng.integers(0, 7, (3, 5))
    labels[0, 2] = labels[2, 4] = -100
    for red in ("mean", "sum", "none"):
        want = np.asarray(jax_L.cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels), reduction=red))
        got = L.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels), reduction=red)
        assert np.max(np.abs(got.numpy() - want)) <= 1e-6, red
    per = L.softmax_with_cross_entropy(torch.from_numpy(logits),
                                       torch.from_numpy(labels))
    assert per.shape == (3, 5, 1) and float(per[0, 2, 0]) == 0.0


def test_dropout_layer_follows_training_mode():
    torch.manual_seed(0)
    x = torch.ones(4000)
    layer = Dropout(0.25)
    y = layer(x)
    kept = y[y != 0]
    assert torch.allclose(kept, torch.full_like(kept, 1 / 0.75))
    assert 0.2 < float((y == 0).float().mean()) < 0.3
    layer.eval()
    assert torch.equal(layer(x), x)


@pytest.mark.parametrize("flags", [{"fused_qkv_projection": True}])
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("gate", [512, 16])
def test_attention_flags_compute_the_same_function(pair, flags, training,
                                                   gate):
    # one [d, 3d] projection gives the separate projections' output, on
    # the plain attention and (training, gate 16) the plain flash route
    _, pm = pair
    pm.train(training)
    ids, types, mask, pos, _, _ = _batch()
    args = (_t(ids), _t(types), _t(mask), _t(pos))
    set_flags({"flash_attention_min_seq_train": gate})
    try:
        want = pm(*args)[0]
        set_flags(flags)
        got = pm(*args)[0]
    finally:
        set_flags({"flash_attention_min_seq_train": 512,
                   "fused_qkv_projection": False})
    assert float((got - want).detach().abs().max()) <= 1e-5


def test_models_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        BertForPretraining(BertConfig(**SMALL))
