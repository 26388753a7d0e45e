"""PyTorch port: the Adam kernel's plain versions and the fused optimizer
routes against the JAX package on the CPU.

The CUDA kernel runs only on a GPU (``python3 chip_smoke.py`` holds it
bitwise against its plain version there). Here both plain variants are
held against the Pallas kernels in interpret mode (``fused_adam_leaf``,
``fused_adam_flat``) within an fp32 tolerance: the Pallas kernel in
interpret mode is not bitwise even against the JAX package's own unfused
update on this CPU. On the CPU the ``fused_adam`` route runs the plain
leaf variant, so it must equal the unfused update bit for bit; the
``use_pallas_adam`` route takes only leaves of >= 1024 elements; a
10-step BERT ``TrainStep`` with ``fused_adam`` on follows the JAX
``TrainStep`` with ``fused_adam`` on; and the skip-step guard discards a
poisoned step on both fused routes.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as pt  # noqa: E402
from paddle_tpu import kernels as jax_kernels  # noqa: E402
from paddle_tpu.kernels import fused_adam as jax_fa  # noqa: E402
from paddle_tpu.models import BertConfig as JaxBertConfig  # noqa: E402
from paddle_tpu.models import BertForPretraining as JaxBert  # noqa: E402
from paddle_tpu.models import pretraining_loss as jax_pretraining_loss  # noqa: E402,E501
from paddle_tpu.optimizer import AdamW as JaxAdamW  # noqa: E402
from paddle_tpu.static import TrainStep as JaxTrainStep  # noqa: E402

from paddle_tpu_torch import kernels, set_flags  # noqa: E402
from paddle_tpu_torch.convert import load_jax_params  # noqa: E402
from paddle_tpu_torch.kernels import fused_adam as fa  # noqa: E402
from paddle_tpu_torch.models import (BertConfig,  # noqa: E402
                                     BertForPretraining, pretraining_loss)
from paddle_tpu_torch.optimizer import Adam, AdamW  # noqa: E402
from paddle_tpu_torch.static import TrainStep  # noqa: E402

B1, B2, EPS = 0.9, 0.999, 1e-8
LR_C = np.float32(2.34e-3)
# fp32 against the interpret-mode Pallas kernels: m and v are a product
# and a sum apart (an ulp of ~0.1); p moves by ~lr_c and may differ by an
# ulp of itself (~1e-7 at unit scale)
MV_TOL = 1e-7
P_TOL = 1e-6


def _leaf(shape, seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    m = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    v = (np.abs(rng.standard_normal(shape)) * 0.1).astype(np.float32)
    return p, g, m, v


@pytest.mark.parametrize("variant,shape,wd", [
    ("leaf", (33, 130), 0.0), ("leaf", (3, 5, 257), 0.0),
    ("leaf", (1024,), 0.0), ("leaf", (64, 96), 0.0),
    ("flat", (33 * 130,), 0.0), ("flat", (1024,), 0.0),
    ("flat", (64 * 96,), 0.01)])
def test_plain_variants_match_jax_kernels(variant, shape, wd):
    arrays = _leaf(shape, seed=sum(shape))
    if variant == "leaf":
        want = jax_fa.fused_adam_leaf(*map(jnp.asarray, arrays), LR_C, B1,
                                      B2, EPS, interpret=True)
        got = fa.adam_leaf_plain(*map(torch.from_numpy, arrays),
                                 torch.tensor(LR_C), B1, B2, EPS)
    else:
        want = jax_fa.fused_adam_flat(*map(jnp.asarray, arrays), LR_C, B1,
                                      B2, EPS, weight_decay=wd,
                                      interpret=True)
        got = fa.adam_flat_plain(*map(torch.from_numpy, arrays),
                                 torch.tensor(LR_C), B1, B2, EPS,
                                 weight_decay=wd)
    for name, a, e, tol in zip("pmv", got, want, (P_TOL, MV_TOL, MV_TOL)):
        assert a.shape == shape
        err = np.max(np.abs(a.numpy() - np.asarray(e)))
        assert err <= tol, (name, err)


def _params(seed=1):
    rng = np.random.default_rng(seed)
    shapes = {"fc.weight": (40, 32), "fc.bias": (32,),
              "norm.weight": (32,), "emb.weight": (300, 8),
              "head.weight": (3, 5)}
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def _no_decay(name: str) -> bool:
    return not (name.endswith(".bias") or "norm" in name)


def _run(opt, params, steps, flags, ok_seq=None):
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = opt.init(pp)
    rng = np.random.default_rng(7)
    set_flags(flags)
    try:
        for i in range(steps):
            grads = {k: torch.from_numpy(rng.standard_normal(
                v.shape).astype(np.float32)) for k, v in params.items()}
            ok = None if ok_seq is None else torch.tensor(ok_seq[i])
            opt.apply_gradients(pp, grads, state, ok)
    finally:
        set_flags({"fused_adam": False, "use_pallas_adam": False})
    return pp, state


@pytest.mark.parametrize("opt_name", ["adamw", "adam_l2"])
@pytest.mark.parametrize("ok_seq", [None, [True, False, True]])
def test_fused_adam_equals_unfused_bitwise_on_cpu(opt_name, ok_seq):
    def make():
        if opt_name == "adamw":
            return AdamW(1e-3, weight_decay=0.05,
                         apply_decay_param_fun=_no_decay)
        return Adam(1e-3, weight_decay=0.1)
    params = _params()
    kernels.reset_launch_counts()
    base = _run(make(), params, 3, {}, ok_seq)
    fused = _run(make(), params, 3, {"fused_adam": True}, ok_seq)
    assert not any(kernels.launch_counts().values())
    for k in params:
        assert torch.equal(base[0][k], fused[0][k]), k
        for s in ("m", "v"):
            assert torch.equal(base[1]["slots"][k][s],
                               fused[1]["slots"][k][s]), (k, s)
    assert int(base[1]["step"]) == int(fused[1]["step"]) \
        == (3 if ok_seq is None else 2)


@pytest.mark.parametrize("flags,routes", [
    ({"fused_adam": True}, {"leaf": 5}),
    ({"use_pallas_adam": True}, {"flat": 2}),
    ({"fused_adam": True, "use_pallas_adam": True}, {"leaf": 5})])
def test_routes_take_the_leaves_the_jax_conditions_give(monkeypatch, flags,
                                                        routes):
    seen = {}
    real = kernels.maybe_fused_adam

    def spy(params, *args):
        seen[args[-1]] = [p.numel() for p in params]
        return real(params, *args)
    monkeypatch.setattr(kernels, "maybe_fused_adam", spy)
    params = _params()
    got = _run(AdamW(1e-3), params, 1, flags)[0]
    base = _run(AdamW(1e-3), params, 1, {})[0]
    assert {k: len(v) for k, v in seen.items()} == routes
    if "flat" in seen:
        # fc.weight (1280) and emb.weight (2400): the small leaves stay
        # unfused, bitwise
        assert sorted(seen["flat"]) == [1280, 2400]
        for k in ("fc.bias", "norm.weight", "head.weight"):
            assert torch.equal(got[k], base[k]), k
    for k in params:  # the reciprocal form may round p by an ulp
        assert float((got[k] - base[k]).abs().max()) <= 1e-6, k


def test_adam_multi_refuses_cpu_tensors():
    p = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        fa.adam_multi([p], [p], [p], [p], [False], torch.zeros(1), B1, B2,
                      EPS, 0.0)


# --- a small BERT through TrainStep ----------------------------------------

SMALL = dict(vocab_size=256, hidden_size=32, num_hidden_layers=1,
             num_attention_heads=2, intermediate_size=64,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             max_position_embeddings=32)
B, T = 2, 16


def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (B, T)).astype(np.int32)
    types = rng.integers(0, 2, (B, T)).astype(np.int32)
    mlm = rng.integers(0, 256, (B, T)).astype(np.int64)
    mlm[:, ::3] = -100
    nsp = rng.integers(0, 2, (B,)).astype(np.int64)
    return ids, types, mlm, nsp


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


@pytest.fixture
def pair():
    pt.seed(0)
    jm = JaxBert(JaxBertConfig(**SMALL))
    pm = BertForPretraining(BertConfig(**SMALL), device="cpu")
    load_jax_params(pm, {k: np.asarray(v)
                         for k, v in jm.param_dict().items()})
    return jm, pm


def test_ten_step_trainstep_with_fused_adam_matches_jax(pair, monkeypatch):
    jm, pm = pair
    # the JAX package's fused_adam route, its kernel in interpret mode
    # (as tests/test_kernels.py runs it)
    monkeypatch.setattr(jax_kernels, "_on_tpu", lambda: True)
    leaf = jax_fa.fused_adam_leaf
    monkeypatch.setattr(jax_fa, "fused_adam_leaf", lambda *a, **k: leaf(
        *a, **dict(k, interpret=True)))
    kw = dict(learning_rate=1e-3, weight_decay=0.01,
              apply_decay_param_fun=_no_decay)
    pt.set_flags({"fused_adam": True})
    set_flags({"fused_adam": True})
    try:
        jstep = JaxTrainStep(jm, JaxAdamW(**kw), lambda out, m, n:
                             jax_pretraining_loss(out, m, n))
        pstep = TrainStep(pm, AdamW(**kw), pretraining_loss)
        jl, pl = [], []
        for i in range(10):  # two batches in turn: the loss must fall
            ids, types, mlm, nsp = _batch(seed=i % 2)
            jl.append(float(jstep(jnp.asarray(ids), jnp.asarray(types),
                                  labels=(jnp.asarray(mlm),
                                          jnp.asarray(nsp)))["loss"]))
            pl.append(float(pstep(_t(ids), _t(types),
                                  labels=(_t(mlm), _t(nsp)))["loss"]))
        jstep.sync_to_model()
    finally:
        pt.set_flags({"fused_adam": False})
        set_flags({"fused_adam": False})
    # the existing 10-step trajectory's tolerance (tests/test_torch_bert.py)
    assert np.max(np.abs(np.array(pl) - np.array(jl))) <= 1e-5, (pl, jl)
    assert pl[-1] < pl[0]
    assert int(pstep.state["step"]) == 10
    own = dict(pm.named_parameters())
    for name, v in jm.param_dict().items():
        if name.endswith("k_proj.bias"):
            continue  # an exactly-zero gradient: see tests/test_torch_bert
        assert np.max(np.abs(own[name].detach().numpy()
                             - np.asarray(v))) <= 1e-5, name


@pytest.mark.parametrize("flags", [{"fused_adam": True},
                                   {"use_pallas_adam": True}])
def test_skip_step_guard_discards_a_poisoned_update_on_the_fused_route(
        pair, flags):
    _, pm = pair
    set_flags(flags)
    try:
        step = TrainStep(pm, AdamW(learning_rate=1e-3),
                         lambda out, m, n, s: pretraining_loss(out, m, n)
                         * s)
        ids, types, mlm, nsp = _batch(0)
        args, one = (_t(ids), _t(types)), torch.tensor(1.0)
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
        assert not torch.equal(pm.cls.decoder_bias,
                               before["cls.decoder_bias"])
    finally:
        set_flags({"fused_adam": False, "use_pallas_adam": False})
