"""PyTorch port: bf16 BERT pretraining through TrainStep against the JAX
package on the CPU, as the JAX bench builds it (the model cast to bf16,
AdamW(weight_decay=0.01), fp32 masters and moments).

A small BERT (2 layers, hidden 64, 2 heads, vocab 512, seq 32, dropout
0) is built in the JAX package, cast to bf16 there, and its bf16
``param_dict()`` carried into the port's bf16 model bit for bit
(``convert``). Both train 10 steps on the same numpy batches: under the
default flags and under ``fused_softmax_xent`` + ``fused_adam`` (the JAX
kernels in interpret mode, the port's plain versions), each with
``fused_state`` off and on.

The two packages round bf16 in different places (XLA fuses elementwise
chains, torch rounds after each op; the matmuls accumulate in another
order), so a bf16 step is compared at bf16's precision, not fp32's:

- ``LOSS_RTOL``: the loss at every step within 2e-2 relative (3.3e-3
  measured);
- ``MASTER_TOL``: an fp32 master's entry after 10 steps is within 5% of
  the largest entry of its own 10-step change (the change is ~10 lr). A
  bf16 run cannot hold that for every entry, in either package: Adam
  moves an entry by ~lr whatever its gradient's size, so where bf16
  rounding flips the sign of a near-zero gradient the entry moves the
  other way. The JAX package's own bf16 run differs from its fp32 run
  from the same start by 20-50% of the change at its worst entry of most
  leaves, as much as the port differs from it (measured). So the check
  is on the share of entries: at most ``OUTLIER_SHARE`` (2%) of all
  master entries beyond ``MASTER_TOL`` (1.0% measured), and the median
  entry of every leaf within it (a fault confined to one leaf, such as a
  wrong gradient or a lost master update, moves most of its entries;
  the noise moves only the few whose gradient is near zero).

The key-projection bias is left out of the master check: softmax ignores
a per-query constant, so its exact gradient is 0 and both packages see
only bf16 rounding noise there, which Adam turns into steps of ~lr.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import functools
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as pt  # noqa: E402
from paddle_tpu import kernels as jax_kernels  # noqa: E402
from paddle_tpu.kernels import fused_adam as jax_fa  # noqa: E402
from paddle_tpu.kernels import fused_softmax_xent as jax_fx  # noqa: E402
from paddle_tpu.models import BertConfig as JaxBertConfig  # noqa: E402
from paddle_tpu.models import BertForPretraining as JaxBert  # noqa: E402
from paddle_tpu.models import pretraining_loss as jax_pretraining_loss  # noqa: E402,E501
from paddle_tpu.optimizer import AdamW as JaxAdamW  # noqa: E402
from paddle_tpu.optimizer import lr as jax_lr  # noqa: E402
from paddle_tpu.static import EvalStep as JaxEvalStep  # noqa: E402
from paddle_tpu.static import TrainStep as JaxTrainStep  # noqa: E402

from paddle_tpu_torch import amp, clip, set_flags  # noqa: E402
from paddle_tpu_torch.convert import (load_jax_params,  # noqa: E402
                                      params_from_jax)
from paddle_tpu_torch.models import (BertConfig,  # noqa: E402
                                     BertForPretraining, MLMHeadOutput,
                                     pretraining_loss)
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402
from paddle_tpu_torch.optimizer import lr as port_lr  # noqa: E402
from paddle_tpu_torch.static import EvalStep, TrainStep  # noqa: E402

jax_clip = importlib.import_module("paddle_tpu.clip")

SMALL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=128,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             max_position_embeddings=64)
B, T, P = 2, 32, 8
STEPS = 10
LOSS_RTOL = 2e-2
MASTER_TOL = 0.05
OUTLIER_SHARE = 0.02
FUSED = {"fused_softmax_xent": True, "fused_adam": True}


def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (B, T)).astype(np.int32)
    types = rng.integers(0, 2, (B, T)).astype(np.int32)
    pos = np.sort(rng.permuted(np.broadcast_to(np.arange(T), (B, T)),
                               axis=1)[:, :P], axis=1).astype(np.int32)
    mlm = rng.integers(0, 512, (B, P)).astype(np.int64)
    mlm[0, 1] = -100
    nsp = rng.integers(0, 2, (B,)).astype(np.int64)
    return ids, types, pos, mlm, nsp


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _jax_args(batch):
    ids, types, pos, mlm, nsp = batch
    return ((jnp.asarray(ids), jnp.asarray(types)),
            dict(masked_positions=jnp.asarray(pos)),
            (jnp.asarray(mlm), jnp.asarray(nsp)))


def _port_args(batch):
    ids, types, pos, mlm, nsp = batch
    return (_t(ids), _t(types)), dict(masked_positions=_t(pos)), \
        (_t(mlm), _t(nsp))


@pytest.fixture
def pair():
    pt.seed(0)
    jm = JaxBert(JaxBertConfig(**SMALL))
    jm.to(dtype="bfloat16")
    pm = amp.cast_model_to_low_precision(
        BertForPretraining(BertConfig(**SMALL), device="cpu"), "bfloat16")
    jparams = {k: np.asarray(v) for k, v in jm.param_dict().items()}
    assert all(v.dtype.name == "bfloat16" for v in jparams.values())
    # C3: a bf16 param_dict() crosses bit for bit
    carried = params_from_jax(jparams)
    load_jax_params(pm, carried)
    for n, p in pm.named_parameters():
        assert p.dtype == torch.bfloat16, n
        assert np.array_equal(p.view(torch.uint16).numpy(),
                              jparams[n].view(np.uint16)), n
    return jm, pm


@pytest.fixture
def jax_fused_routes(monkeypatch):
    """The JAX package's fused routes on the CPU, their Pallas kernels in
    interpret mode (as its own tests run them)."""
    monkeypatch.setattr(jax_kernels, "_on_tpu", lambda: True)
    monkeypatch.setattr(jax_fx, "fused_linear_softmax_xent",
                        functools.partial(jax_fx.fused_linear_softmax_xent,
                                          interpret=True))
    leaf = jax_fa.fused_adam_leaf
    monkeypatch.setattr(jax_fa, "fused_adam_leaf", lambda *a, **k: leaf(
        *a, **dict(k, interpret=True)))


def _flags(flags):
    pt.set_flags(flags)
    set_flags(flags)


def _unflag(flags):
    off = {k: False for k in flags}
    pt.set_flags(off)
    set_flags(off)


def _masters(step_state, params):
    """Each parameter's fp32 master (its slice of the flat one under
    fused_state), by name, as numpy, from either package's state."""
    if "fused" in step_state:
        flat = np.asarray(step_state["fused"]["master"], np.float32)
        out, off = {}, 0
        for n in sorted(params):
            k = int(np.prod(params[n].shape))
            out[n] = flat[off:off + k].reshape(params[n].shape)
            off += k
        return out
    return {n: np.asarray(s["master"], np.float32)
            for n, s in step_state["slots"].items()}


def _train_both(jm, pm, flags, fused_state, jax_kw=None, port_kw=None):
    jax_kw = jax_kw or dict(learning_rate=1e-3, weight_decay=0.01)
    port_kw = port_kw or jax_kw
    start = {n: p.detach().float().numpy().copy()
             for n, p in pm.named_parameters()}
    _flags(flags)
    try:
        jstep = JaxTrainStep(jm, JaxAdamW(fused_state=fused_state,
                                          **jax_kw),
                             lambda out, m, n: jax_pretraining_loss(out, m,
                                                                    n))
        pstep = TrainStep(pm, AdamW(fused_state=fused_state, **port_kw),
                          pretraining_loss)
        jl, pl = [], []
        for i in range(STEPS):
            batch = _batch(seed=i % 3)
            args, kw, labels = _jax_args(batch)
            jl.append(float(jstep(*args, labels=labels, **kw)["loss"]))
            args, kw, labels = _port_args(batch)
            pl.append(float(pstep(*args, labels=labels, **kw)["loss"]))
    finally:
        _unflag(flags)
    return jstep, pstep, np.array(jl), np.array(pl), start


def _check_trajectory(jstep, pstep, jl, pl, start):
    assert np.all(np.isfinite(pl))
    rel = np.abs(pl - jl) / np.abs(jl)
    assert rel.max() <= LOSS_RTOL, (pl, jl)
    assert pl[-1] < pl[0] and jl[-1] < jl[0]
    assert int(pstep.state["step"]) == STEPS
    pm = pstep.model
    jm_ = _masters(jstep.state["opt"], start)
    pm_ = _masters(pstep.state, start)
    assert set(jm_) == set(pm_) == set(start)
    outliers = total = 0
    for name in start:
        p = dict(pm.named_parameters())[name]
        assert p.dtype == torch.bfloat16, name
        assert pm_[name].dtype == np.float32
        if name.endswith("k_proj.bias"):
            continue
        change = np.max(np.abs(jm_[name] - start[name]))
        gap = np.abs(pm_[name] - jm_[name]) / change
        assert np.median(gap) <= MASTER_TOL, (name, np.median(gap))
        outliers += int(np.sum(gap > MASTER_TOL))
        total += gap.size
    assert outliers <= OUTLIER_SHARE * total, (outliers, total)


@pytest.mark.parametrize("fused_state", [False, True])
def test_ten_bf16_steps_match_jax_default_flags(pair, fused_state):
    _check_trajectory(*_train_both(*pair, {}, fused_state))


@pytest.mark.parametrize("fused_state", [False, True])
def test_ten_bf16_steps_match_jax_fused_flags(pair, jax_fused_routes,
                                              fused_state):
    _check_trajectory(*_train_both(*pair, FUSED, fused_state))


def test_schedule_and_clip_inside_the_step_match_jax(pair):
    def kw(lr_mod, clip_mod):
        return dict(learning_rate=lr_mod.LinearWarmup(
            lr_mod.CosineAnnealingDecay(2e-3, T_max=8), 3, 0.0, 2e-3),
            weight_decay=0.01,
            grad_clip=clip_mod.ClipGradByGlobalNorm(0.5))
    _check_trajectory(*_train_both(*pair, {}, False,
                                   jax_kw=kw(jax_lr, jax_clip),
                                   port_kw=kw(port_lr, clip)))


def test_run_steps_equals_separate_calls(pair):
    _, pm = pair
    twin = amp.cast_model_to_low_precision(
        BertForPretraining(BertConfig(**SMALL), device="cpu"), "bfloat16")
    twin.load_state_dict(pm.state_dict())
    metric = {"nsp_logit_mean": lambda out, mlm, nsp: out[1].float().mean()}
    calls = TrainStep(pm, AdamW(1e-3), pretraining_loss,
                      extra_metrics=metric)
    multi = TrainStep(twin, AdamW(1e-3), pretraining_loss,
                      extra_metrics=metric)
    batches = [_port_args(_batch(seed=i)) for i in range(3)]
    want = [calls(*a, labels=lab, **kw) for a, kw, lab in batches]
    stacked = [torch.stack(parts) for parts in zip(
        *[a + lab + (kw["masked_positions"],) for a, kw, lab in batches])]
    got = multi.run_steps(*stacked[:2], labels=tuple(stacked[2:4]),
                          masked_positions=stacked[4])
    assert set(got) == {"loss", "nsp_logit_mean"}
    for k in got:
        assert got[k].shape == (3,)
        assert torch.equal(got[k], torch.stack([w[k] for w in want])), k
    for (n, a), b in zip(pm.named_parameters(), twin.parameters()):
        assert torch.equal(a, b), n
    assert int(multi.state["step"]) == 3 and multi.calls == 3


def test_run_steps_holds_a_host_lr_for_its_steps(pair):
    _, pm = pair
    sched = port_lr.ReduceOnPlateau(1e-3)
    step = TrainStep(pm, AdamW(sched), pretraining_loss)
    seen = []
    real = step.optimizer.apply_gradients

    def spy(*a, lr_override=None):
        # the host rate reaches the update as the step's fp32 device
        # tensor host_lr, rewritten before each step: read it now
        seen.append(None if lr_override is None else float(lr_override))
        return real(*a, lr_override=lr_override)
    step.optimizer.apply_gradients = spy
    a, kw, lab = _port_args(_batch(0))
    stacked = [torch.stack([t, t]) for t in a + lab]
    step.run_steps(*stacked[:2], labels=tuple(stacked[2:]),
                   masked_positions=torch.stack([kw["masked_positions"]] * 2))
    sched.current_lr = 5e-4
    step(*a, labels=lab, **kw)
    # fp32, as the JAX step takes a host rate (jnp.float32)
    assert seen == [float(np.float32(r)) for r in (1e-3, 1e-3, 5e-4)]


def test_eval_step_matches_jax(pair):
    jm, pm = pair
    batch = _batch(seed=7)
    ids, types, pos, mlm, nsp = batch
    metric = {"nsp": lambda out, n: out[1].argmax(-1)}
    jout, jmet = JaxEvalStep(jm, metric)(
        jm.param_dict(), jm.buffer_dict(), jnp.asarray(ids),
        jnp.asarray(types), labels=(jnp.asarray(nsp),))
    pm.train()
    pout, pmet = EvalStep(pm, {"nsp": lambda out, n: out[1].argmax(-1)})(
        None, None, _t(ids), _t(types), labels=(_t(nsp),))
    assert pm.training  # restored
    assert pout[0].dtype == torch.bfloat16 and not pout[0].requires_grad
    for a, e in zip(pout, jout):
        e = np.asarray(e, np.float32)
        err = np.max(np.abs(a.float().numpy() - e)) / np.max(np.abs(e))
        # bf16 logits through two layers: a few bf16 steps
        assert err <= 2 ** -5, err
    # explicit parameters replace the model's own for the call
    zeroed = {n: torch.zeros_like(p) for n, p in pm.named_parameters()}
    zout, _ = EvalStep(pm)(zeroed, None, _t(ids))
    assert not zout[0].any()
    assert pm.bert.pooler.weight.any()


def test_padded_batch_masks_keys_in_both_packages(pair):
    # the additive mask (1 - m) * finfo(float32).min: the port forms it in
    # the embeddings' dtype, where it rounds to -inf in bf16; the JAX
    # package multiplies by a numpy float32 scalar, which promotes it to
    # fp32 (-3.4e38). Either way a padded key gets exactly zero weight
    jm, pm = pair
    ids, types, pos, mlm, nsp = _batch(seed=5)
    mask = np.ones((B, T), np.int32)
    mask[1, 20:] = 0
    m = torch.from_numpy(mask)
    bias = (1.0 - m[:, None, None, :].to(torch.bfloat16)) \
        * torch.finfo(torch.float32).min
    assert bias.dtype == torch.bfloat16
    assert torch.isinf(bias[1, 0, 0, 20:]).all() and not bias[0].any()
    jbias = (1.0 - jnp.asarray(mask)[:, None, None, :].astype(
        jnp.bfloat16)) * jnp.finfo(jnp.float32).min
    assert jbias.dtype == jnp.float32
    # a padded key changes nothing: perturbing its token leaves every
    # other output as it was
    ids2 = ids.copy()
    ids2[1, 25] = (ids2[1, 25] + 1) % 512
    pm.eval()
    with torch.no_grad():
        a = pm(_t(ids), _t(types), m)
        b = pm(_t(ids2), _t(types), m)
    assert torch.equal(a[1], b[1])
    assert torch.equal(a[0][:, :20], b[0][:, :20])
    # and through one training step the padded run follows JAX
    jstep = JaxTrainStep(jm, JaxAdamW(1e-3, weight_decay=0.01),
                         lambda out, mm, n: jax_pretraining_loss(out, mm, n))
    pstep = TrainStep(pm, AdamW(1e-3, weight_decay=0.01), pretraining_loss)
    jl = float(jstep(jnp.asarray(ids), jnp.asarray(types),
                     jnp.asarray(mask), jnp.asarray(pos),
                     labels=(jnp.asarray(mlm), jnp.asarray(nsp)))["loss"])
    pl = float(pstep(_t(ids), _t(types), m, _t(pos),
                     labels=(_t(mlm), _t(nsp)))["loss"])
    assert abs(pl - jl) / abs(jl) <= LOSS_RTOL, (pl, jl)


def test_mlm_bias_is_cast_with_the_model(pair):
    jm, pm = pair
    assert pm.cls.decoder_bias.dtype == torch.bfloat16
    assert jm.param_dict()["cls.decoder_bias"].dtype == jnp.bfloat16
    set_flags({"fused_softmax_xent": True})
    try:
        out = pm(_t(_batch(0)[0]))
    finally:
        set_flags({"fused_softmax_xent": False})
    assert isinstance(out[0], MLMHeadOutput)
    assert out[0].bias.dtype == out[0].hidden.dtype == torch.bfloat16
