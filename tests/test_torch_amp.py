"""PyTorch port: ``amp`` (auto_cast, the whole-model cast, all_finite,
select_update, GradScaler) against the JAX package on the CPU.

The scaler's state is compared exactly (the same fp32 and int32 values)
over a scripted run of finite and non-finite steps; ``auto_cast`` must
leave what a model computes bitwise unchanged, as the JAX package's
does (it only records thread-local state).
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from paddle_tpu import amp as jax_amp  # noqa: E402

from paddle_tpu_torch import amp  # noqa: E402
from paddle_tpu_torch.convert import tensor_from_numpy  # noqa: E402
from paddle_tpu_torch.models import (BertConfig,  # noqa: E402
                                     BertForPretraining, pretraining_loss)
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402
from paddle_tpu_torch.static import TrainStep  # noqa: E402

SMALL = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=128,
             hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
             max_position_embeddings=64)
# finite (False) and non-finite (True) steps: a run of clean steps that
# grows the scale twice, bad steps in pairs and alone, a bad step
# breaking a clean run
SCRIPT = [False] * 7 + [True, True, False, True, False, False, False,
                        True, True, True, True, False, False, False]


@pytest.mark.parametrize("kw", [
    dict(init_loss_scaling=2.0 ** 4, incr_every_n_steps=3,
         decr_every_n_nan_or_inf=2),
    dict(init_loss_scaling=2.0, incr_every_n_steps=2,
         decr_every_n_nan_or_inf=1, incr_ratio=4.0, decr_ratio=0.25)])
def test_grad_scaler_state_follows_jax_exactly(kw):
    js, ps = jax_amp.GradScaler(**kw), amp.GradScaler(**kw)
    jstate, pstate = js.init(), ps.init()
    for found in SCRIPT:
        jstate = js.update(jstate, jnp.asarray(found))
        pstate = ps.update(pstate, torch.tensor(found))
        for k in ("scale", "good_steps", "bad_steps"):
            want = np.asarray(jstate[k])
            got = pstate[k].numpy()
            assert got.dtype == want.dtype and np.array_equal(got, want), (
                k, got, want)
    # the floor: the scale never falls below 1
    assert float(pstate["scale"]) >= 1.0


def test_scale_and_unscale_match_jax_bitwise():
    rng = np.random.default_rng(0)
    js, ps = jax_amp.GradScaler(), amp.GradScaler()
    jstate, pstate = js.init(), ps.init()
    loss = np.float32(3.7)
    assert float(ps.scale(torch.tensor(loss), pstate)) == \
        float(js.scale(jnp.asarray(loss), jstate))
    grads = {"a": rng.standard_normal((4, 5)).astype(np.float16),
             "b": rng.standard_normal(7).astype(np.float32),
             "step": np.array(3, np.int32)}
    for poison in (False, True):
        g = dict(grads)
        if poison:
            g["a"] = g["a"].copy()
            g["a"][1, 2] = np.inf
        jg, jinf = js.unscale({k: jnp.asarray(v) for k, v in g.items()},
                              jstate)
        pg, pinf = ps.unscale({k: tensor_from_numpy(v) for k, v in
                               g.items()}, pstate)
        assert bool(pinf) == bool(jinf) == poison
        assert pinf.dtype == torch.bool and pinf.ndim == 0
        for k in g:
            assert pg[k].dtype == tensor_from_numpy(g[k]).dtype, k
            assert np.array_equal(pg[k].numpy(), np.asarray(jg[k]),
                                  equal_nan=True), k
    off = amp.GradScaler(enable=False)
    g = {"a": torch.ones(2)}
    assert off.unscale(g, ps.init())[0] is g
    assert off.scale(torch.tensor(2.0), None) == 2.0


def test_all_finite_and_select_update():
    tree = {"a": torch.ones(3), "b": [torch.zeros(2, dtype=torch.bfloat16),
                                      torch.tensor(7)]}
    assert bool(amp.all_finite(tree))
    tree["b"][0][1] = float("nan")
    assert not bool(amp.all_finite(tree))
    # integer leaves are not checked, and a tree without floats is finite
    assert bool(amp.all_finite({"step": torch.tensor(3)}))
    new = {"p": torch.full((2,), 5.0), "s": (torch.tensor(1),)}
    old = {"p": torch.zeros(2), "s": (torch.tensor(0),)}
    kept = amp.select_update(torch.tensor(True), new, old)
    taken = amp.select_update(torch.tensor(False), new, old)
    assert torch.equal(kept["p"], old["p"]) and int(kept["s"][0]) == 0
    assert torch.equal(taken["p"], new["p"]) and int(taken["s"][0]) == 1
    want = jax_amp.select_update(jnp.asarray(True), {"p": jnp.ones(2)},
                                 {"p": jnp.zeros(2)})
    assert np.array_equal(
        amp.select_update(torch.tensor(True), {"p": torch.ones(2)},
                          {"p": torch.zeros(2)})["p"].numpy(),
        np.asarray(want["p"]))


def test_auto_cast_nests_and_restores_like_jax():
    for mod, dt in ((amp, torch), (jax_amp, jnp)):
        assert not mod.amp_enabled()
        with mod.auto_cast(dtype="float16"):
            assert mod.amp_enabled() and mod.amp_dtype() == dt.float16
            with mod.amp_guard(enable=False, dtype="bfloat16"):
                assert not mod.amp_enabled()
                assert mod.amp_dtype() == dt.bfloat16
            assert mod.amp_enabled() and mod.amp_dtype() == dt.float16
        assert not mod.amp_enabled()
        assert mod.amp_dtype() == dt.bfloat16
    x = torch.ones(3)
    assert amp.low_precision_policy(x) is x
    with amp.auto_cast(dtype="bfloat16"):
        assert amp.low_precision_policy(x, "matmul").dtype == torch.bfloat16
        xb = x.to(torch.bfloat16)
        assert amp.low_precision_policy(xb, "softmax").dtype == \
            torch.float32
        ids = torch.arange(3)
        assert amp.low_precision_policy(ids, "matmul") is ids
    assert amp.WHITE_LIST == jax_amp.WHITE_LIST
    assert amp.BLACK_LIST == jax_amp.BLACK_LIST


def _batch(seed=0, b=2, t=32):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, 128, (b, t)))
    mlm = torch.from_numpy(rng.integers(0, 128, (b, t)))
    nsp = torch.from_numpy(rng.integers(0, 2, (b,)))
    return ids, mlm, nsp


class _WithBuffer(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(3, 3)
        self.register_buffer("stat", torch.ones(3))
        self.register_buffer("count", torch.zeros((), dtype=torch.int64))


def test_cast_model_casts_parameters_only():
    m = _WithBuffer()
    weight = m.fc.weight
    assert amp.cast_model_to_low_precision(m, "bfloat16") is m
    assert m.fc.weight is weight  # the same Parameter, now bf16
    assert weight.dtype == m.fc.bias.dtype == torch.bfloat16
    assert m.stat.dtype == torch.float32 and m.count.dtype == torch.int64
    opt = AdamW(1e-3)
    assert amp.decorate(opt)[0] is opt
    assert isinstance(amp.decorate(opt)[1], amp.GradScaler)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_auto_cast_leaves_forward_and_step_bitwise_unchanged(dtype):
    cfg = BertConfig(**SMALL)
    models = [amp.cast_model_to_low_precision(
        BertForPretraining(cfg, device="cpu", seed=3), dtype)
        for _ in range(2)]
    ids, mlm, nsp = _batch()
    models[0].eval()
    with torch.no_grad():
        plain = models[0](ids)
        with amp.auto_cast(dtype=dtype):
            cast = models[0](ids)
    for a, b in zip(plain, cast):
        # the model's own dtype, not autocast's choice
        assert a.dtype == b.dtype == getattr(torch, dtype)
        assert torch.equal(a, b)
    models[0].train()
    steps = [TrainStep(models[0], AdamW(1e-3), pretraining_loss, seed=5),
             TrainStep(models[1], AdamW(1e-3), pretraining_loss, seed=5,
                       amp_dtype=dtype)]
    losses = [float(s(ids, labels=(mlm, nsp))["loss"]) for s in steps]
    assert losses[0] == losses[1]
    for (n, a), b in zip(models[0].named_parameters(),
                         models[1].parameters()):
        assert torch.equal(a, b), n
