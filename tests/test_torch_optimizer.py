"""PyTorch port: the optimizer (fp32 masters, moments, fused state, clips,
regularizers, schedulers) against the JAX package on the CPU.

Both packages get the same numpy parameters and gradients (bf16 and fp16
ones carried bit for bit) and run their own update. The update math is
fp32 on both sides, so every fp32 quantity (masters, moments, fp32
parameters) must agree within ``TOL`` of its largest entry; a bf16/fp16
parameter is its master cast down on each side, so it agrees to one step
of its dtype (a master within TOL of JAX's may round the other way at a
rounding boundary).
"""

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

# paddle_tpu's own namespace has a clip op shadowing the module
jax_clip = importlib.import_module("paddle_tpu.clip")
from paddle_tpu import regularizer as jax_reg  # noqa: E402
from paddle_tpu.flags import GLOBAL_FLAGS as JAX_FLAGS  # noqa: E402
from paddle_tpu.optimizer import Adam as JaxAdam  # noqa: E402
from paddle_tpu.optimizer import AdamW as JaxAdamW  # noqa: E402
from paddle_tpu.optimizer import lr as jax_lr  # noqa: E402

from paddle_tpu_torch import clip, regularizer, set_flags  # noqa: E402
from paddle_tpu_torch.convert import (opt_state_from_jax,  # noqa: E402
                                      tensor_from_numpy)
from paddle_tpu_torch.core.dtype import convert_dtype  # noqa: E402
from paddle_tpu_torch.kernels import fused_adam as fa  # noqa: E402
from paddle_tpu_torch.optimizer import Adam, AdamW  # noqa: E402
from paddle_tpu_torch.optimizer import lr as port_lr  # noqa: E402

# fp32 update math on both sides, in the same order: an ulp or two of the
# largest entry
TOL = 1e-6
# the norm clips scale every gradient by a sum of up to 2400 squares, which
# torch adds in another order than XLA: the scales differ by up to ~3 fp32
# ulps (3.5e-7 measured on m after one step), which v doubles and three
# steps accumulate
CLIP_TOL = 4e-6
DTYPES = {"float32": (jnp.float32, 0.0), "bfloat16": (jnp.bfloat16, 2.0 ** -7),
          "float16": (jnp.float16, 2.0 ** -10)}
SHAPES = {"fc.weight": (40, 32), "fc.bias": (32,), "norm.weight": (32,),
          "emb.weight": (300, 8), "head.weight": (3, 5)}


def _no_decay(name: str) -> bool:
    return not (name.endswith(".bias") or "norm" in name)


def _numpy_params(seed=1):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(rng, dtype, scale=1.0):
    return {k: jnp.asarray(rng.standard_normal(s) * scale, jnp.float32)
            .astype(dtype) for k, s in SHAPES.items()}


def _port(tree):
    """A JAX dict of arrays (None kept) as port tensors, bits kept."""
    return {k: None if v is None else tensor_from_numpy(np.asarray(v))
            for k, v in tree.items()}


def _close(got: torch.Tensor, want, tol=TOL, what=""):
    g = got.detach().float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape, what
    scale = max(float(np.max(np.abs(w))), 1e-30)
    err = float(np.max(np.abs(g - w))) / scale
    assert err <= tol, (what, err)


def _run_both(make_jax, make_port, dtype, steps=3, grad_dtype=None,
              none=(), jax_meta=None, port_meta=None, seed=3):
    jdt, _ = DTYPES[dtype]
    params = _numpy_params()
    jopt, popt = make_jax(), make_port()
    if jax_meta:
        jopt.set_param_meta(jax_meta)
        popt.set_param_meta(port_meta)
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    pp = _port(jp)
    jstate, pstate = jopt.init(jp), popt.init(pp)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        g = _grads(rng, grad_dtype or jdt)
        g = {k: None if k in none else v for k, v in g.items()}
        jp, jstate = jopt.apply_gradients(jp, g, jstate)
        popt.apply_gradients(pp, _port(g), pstate)
    return jp, jstate, pp, pstate


def _compare(jp, jstate, pp, pstate, dtype, tol=TOL):
    _, ulp = DTYPES[dtype]
    assert int(pstate["step"]) == int(jstate["step"])
    for k in SHAPES:
        assert pp[k].dtype == convert_dtype(dtype), k
        _close(pp[k], jp[k], tol if dtype == "float32" else ulp, k)
    if "fused" in jstate:
        for s in ("m", "v", "master"):
            _close(pstate["fused"][s], jstate["fused"][s], tol, s)
        return
    for k in SHAPES:
        assert set(pstate["slots"][k]) == set(jstate["slots"][k]), k
        for s, t in pstate["slots"][k].items():
            assert t.dtype == convert_dtype(jstate["slots"][k][s].dtype)
            _close(t, jstate["slots"][k][s], tol, (k, s))
        if "master" in pstate["slots"][k]:
            # the parameter is its master cast down, exactly
            assert torch.equal(pp[k], pstate["slots"][k]["master"].to(
                pp[k].dtype)), k


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["adam", "adam_l2", "adamw",
                                  "adamw_filtered"])
def test_adam_and_adamw_match_jax_in_every_dtype(kind, dtype):
    kw = {"adam": dict(learning_rate=1e-2),
          "adam_l2": dict(learning_rate=1e-2, weight_decay=0.1),
          "adamw": dict(learning_rate=1e-2, weight_decay=0.2),
          "adamw_filtered": dict(learning_rate=1e-2, weight_decay=0.2,
                                 apply_decay_param_fun=_no_decay)}[kind]
    jc, pc = (JaxAdam, Adam) if kind.startswith("adam_") or kind == "adam" \
        else (JaxAdamW, AdamW)
    out = _run_both(lambda: jc(**kw), lambda: pc(**kw), dtype)
    _compare(*out, dtype)
    pstate = out[3]
    low = dtype != "float32"
    for k in SHAPES:
        slots = pstate["slots"][k]
        assert slots["m"].dtype == slots["v"].dtype == torch.float32
        assert ("master" in slots) == low


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_moment_storage_matches_jax(dtype):
    JAX_FLAGS.set("optimizer_moment_dtype", "bfloat16")
    set_flags({"optimizer_moment_dtype": "bfloat16"})
    try:
        kw = dict(learning_rate=1e-3, weight_decay=0.01)
        out = _run_both(lambda: JaxAdamW(**kw), lambda: AdamW(**kw), dtype)
    finally:
        JAX_FLAGS.set("optimizer_moment_dtype", "float32")
        set_flags({"optimizer_moment_dtype": "float32"})
    _compare(*out, dtype)
    for k in SHAPES:
        assert out[3]["slots"][k]["m"].dtype == torch.bfloat16


def test_moment_dtype_flag_refuses_a_typo():
    set_flags({"optimizer_moment_dtype": "bf16"})
    try:
        with pytest.raises(ValueError, match="optimizer_moment_dtype"):
            AdamW(1e-3).init({"w": torch.zeros(3)})
    finally:
        set_flags({"optimizer_moment_dtype": "float32"})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["adamw", "adam_l2"])
def test_fused_state_matches_per_leaf_and_jax_with_a_frozen_leaf(kind,
                                                                 dtype):
    def make(cls, fused):
        if kind == "adamw":
            return lambda: cls[1](1e-2, weight_decay=0.2, fused_state=fused)
        return lambda: cls[0](1e-2, weight_decay=0.1, fused_state=fused)
    none = ("norm.weight",)
    fused = _run_both(make((JaxAdam, JaxAdamW), True),
                      make((Adam, AdamW), True), dtype, none=none)
    _compare(*fused, dtype)
    _, _, leaf_p, leaf_state = _run_both(
        make((JaxAdam, JaxAdamW), False), make((Adam, AdamW), False),
        dtype, none=none)
    pp, pstate = fused[2], fused[3]
    assert all(s == {} for s in pstate["slots"].values())
    # the same elementwise update on a flat vector: bit for bit
    for k in SHAPES:
        assert torch.equal(pp[k], leaf_p[k]), k
    # the frozen leaf: parameter, master and moments untouched
    start = _port({k: jnp.asarray(v).astype(DTYPES[dtype][0])
                   for k, v in _numpy_params().items()})
    assert torch.equal(pp["norm.weight"], start["norm.weight"])
    off = sum(int(np.prod(SHAPES[n])) for n in sorted(SHAPES)
              if n < "norm.weight")
    n = int(np.prod(SHAPES["norm.weight"]))
    for s in ("m", "v"):
        assert not pstate["fused"][s][off:off + n].any()
    assert not leaf_state["slots"]["norm.weight"]["m"].any()


def test_fused_state_raises_where_jax_raises():
    p = {"w": torch.zeros(4), "b": torch.zeros(2)}
    opt = AdamW(1e-3, fused_state=True, apply_decay_param_fun=_no_decay)
    with pytest.raises(ValueError, match="apply_decay_param_fun"):
        opt.apply_gradients(p, dict(p), opt.init(p))
    opt = Adam(1e-3, fused_state=True)
    opt.set_param_meta({"w": (True, regularizer.L2Decay(0.1))})
    with pytest.raises(ValueError, match="regularizers"):
        opt.apply_gradients(p, dict(p), opt.init(p))
    set_flags({"optimizer_fused_state": True})
    try:
        assert "fused" in Adam(1e-3).init(p)
        assert "fused" not in Adam(1e-3, fused_state=False).init(p)
    finally:
        set_flags({"optimizer_fused_state": False})


CLIPS = {"value": (lambda m: m.ClipGradByValue(0.5)),
         "value_min": (lambda m: m.ClipGradByValue(0.5, min=-0.2)),
         "norm": (lambda m: m.ClipGradByNorm(1.5)),
         "global_norm": (lambda m: m.ClipGradByGlobalNorm(2.0))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("need_clip", [True, False])
@pytest.mark.parametrize("name", list(CLIPS))
def test_grad_clip_matches_jax(name, need_clip, dtype):
    meta = None if need_clip else {"fc.weight": (False, None)}
    out = _run_both(
        lambda: JaxAdamW(1e-2, grad_clip=CLIPS[name](jax_clip)),
        lambda: AdamW(1e-2, grad_clip=CLIPS[name](clip)), dtype,
        jax_meta=meta, port_meta=meta)
    _compare(*out, dtype, TOL if name.startswith("value") else CLIP_TOL)


def test_clip_functions_match_jax_and_stay_on_the_device():
    rng = np.random.default_rng(5)
    g = {k: rng.standard_normal(s).astype(np.float32) * 3
         for k, s in SHAPES.items()}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    pg = {k: torch.from_numpy(v) for k, v in g.items()}
    for jf, pf, tol in ((jax_clip.clip_grad_value_(jg, 0.7),
                         clip.clip_grad_value_(pg, 0.7), TOL),
                        (jax_clip.clip_grad_norm_(jg, 1.0),
                         clip.clip_grad_norm_(pg, 1.0), CLIP_TOL)):
        for k in SHAPES:
            assert isinstance(pf[k], torch.Tensor)
            _close(pf[k], jf[k], tol, k)
    # the inputs are left as they were
    for k in SHAPES:
        assert np.array_equal(pg[k].numpy(), g[k])


REGS = {"l1": lambda m: m.L1Decay(0.05), "l2": lambda m: m.L2Decay(0.05)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("where", ["optimizer", "param"])
@pytest.mark.parametrize("reg", list(REGS))
def test_regularizers_match_jax(reg, where, dtype):
    if where == "optimizer":
        out = _run_both(lambda: JaxAdam(1e-2, weight_decay=REGS[reg](
                            jax_reg)),
                        lambda: Adam(1e-2, weight_decay=REGS[reg](
                            regularizer)), dtype)
    else:
        # a per-parameter regularizer replaces the optimizer's decay
        out = _run_both(lambda: JaxAdam(1e-2, weight_decay=0.3),
                        lambda: Adam(1e-2, weight_decay=0.3), dtype,
                        jax_meta={"emb.weight": (True, REGS[reg](jax_reg))},
                        port_meta={"emb.weight": (True,
                                                  REGS[reg](regularizer))})
    _compare(*out, dtype)


# (JAX scheduler, port scheduler) built from the same arguments
def _schedulers(m):
    return {
        "noam": m.NoamDecay(d_model=64, warmup_steps=10),
        "piecewise": m.PiecewiseDecay([5, 20, 30], [0.1, 0.05, 0.01,
                                                    0.001]),
        "natural_exp": m.NaturalExpDecay(0.1, gamma=0.05),
        "exponential": m.ExponentialDecay(0.1, gamma=0.93),
        "inverse_time": m.InverseTimeDecay(0.1, gamma=0.2),
        "polynomial": m.PolynomialDecay(0.1, decay_steps=30, power=2.0),
        "polynomial_cycle": m.PolynomialDecay(0.1, decay_steps=12,
                                              cycle=True),
        "cosine": m.CosineAnnealingDecay(0.1, T_max=40, eta_min=0.001),
        "warmup_float": m.LinearWarmup(0.1, warmup_steps=8, start_lr=0.0,
                                       end_lr=0.1),
        "warmup_sched": m.LinearWarmup(
            m.StepDecay(0.1, step_size=7, gamma=0.5), warmup_steps=8,
            start_lr=0.01, end_lr=0.1),
        "step": m.StepDecay(0.1, step_size=7, gamma=0.5),
        "multistep": m.MultiStepDecay(0.1, milestones=[10, 25, 40],
                                      gamma=0.3),
        "lambda": m.LambdaDecay(0.1, lambda s: 0.95 ** s),
        "one_cycle": m.OneCycleLR(0.1, total_steps=45),
        "plateau": m.ReduceOnPlateau(0.1),
    }


@pytest.mark.parametrize("name", list(_schedulers(jax_lr)))
def test_every_scheduler_matches_jax_over_fifty_steps(name):
    js, ps = _schedulers(jax_lr)[name], _schedulers(port_lr)[name]
    steps = np.arange(51)
    want = np.array([float(js.lr_at(jnp.asarray(s, jnp.int32)))
                     for s in steps])
    # on a step counter tensor (the optimizer's), and all at once
    got = np.array([float(ps.lr_at(torch.tensor(s, dtype=torch.int32)))
                    for s in steps])
    assert np.max(np.abs(got - want)) <= TOL * np.max(np.abs(want)), (
        got, want)
    assert ps.host_driven == js.host_driven
    assert ps.get_lr() == pytest.approx(js.get_lr(), rel=TOL)


def test_reduce_on_plateau_follows_the_same_metrics():
    js, ps = jax_lr.ReduceOnPlateau(0.1, patience=2, cooldown=1), \
        port_lr.ReduceOnPlateau(0.1, patience=2, cooldown=1)
    for metric in [5, 4, 4, 4, 4, 4, 3.9, 3.9, 3.9, 3.9, 3.9, 3.9]:
        js.step(metric)
        ps.step(metric)
        assert ps.get_lr() == js.get_lr()
    assert ps.get_lr() < 0.1


def test_scheduled_lr_and_clip_in_the_optimizer_match_jax():
    for dtype in ("float32", "bfloat16"):
        out = _run_both(
            lambda: JaxAdamW(jax_lr.LinearWarmup(
                jax_lr.CosineAnnealingDecay(0.05, T_max=5), 2, 0.0, 0.05),
                weight_decay=0.1,
                grad_clip=jax_clip.ClipGradByGlobalNorm(1.0)),
            lambda: AdamW(port_lr.LinearWarmup(
                port_lr.CosineAnnealingDecay(0.05, T_max=5), 2, 0.0, 0.05),
                weight_decay=0.1, grad_clip=clip.ClipGradByGlobalNorm(1.0)),
            dtype, steps=5)
        _compare(*out, dtype, CLIP_TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_opt_state_from_jax_carries_adam_state(fused):
    rng = np.random.default_rng(8)
    params = _numpy_params()
    jopt = JaxAdamW(1e-2, weight_decay=0.1, fused_state=fused)
    popt = AdamW(1e-2, weight_decay=0.1, fused_state=fused)
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in params.items()}
    jstate = jopt.init(jp)
    for _ in range(2):
        jp, jstate = jopt.apply_gradients(jp, _grads(rng, jnp.bfloat16),
                                          jstate)
    pp = _port(jp)
    pstate = opt_state_from_jax(
        jax.tree.map(np.asarray, jstate), pp)
    assert int(pstate["step"]) == 2 and pstate["step"].dtype == torch.int32
    g = _grads(rng, jnp.bfloat16)
    jp, jstate = jopt.apply_gradients(jp, g, jstate)
    popt.apply_gradients(pp, _port(g), pstate)
    _compare(jp, jstate, pp, pstate, "bfloat16")
    with pytest.raises(ValueError, match="names"):
        opt_state_from_jax(jax.tree.map(np.asarray, jstate),
                           {"other": torch.zeros(1)})


def _old_update(p, g, m, v, lr, step, b1=0.9, b2=0.999, eps=1e-8):
    """The port's update before fp32 masters: moments made with
    ``zeros_like(p)`` (bf16 for a bf16 parameter) and the whole update
    in the parameter's dtype, in place."""
    t = torch.tensor(float(step))
    lr_c = lr * torch.sqrt(1.0 - torch.pow(b2, t)) / (1.0 - torch.pow(b1, t))
    new = fa.adam_leaf_plain(p, g, m, v, lr_c, b1, b2, eps)
    for dst, val in zip((p, m, v), new):
        dst.copy_(val)


def test_sub_ulp_updates_move_a_bf16_parameter_as_in_jax():
    # an Adam step moves a weight by ~lr; at 1.0 a bf16 ulp is 2^-7, so
    # lr = 1e-3 is below half an ulp: without a master every step rounds
    # back to the old value
    lr, steps = 1e-3, 100
    p0 = np.linspace(0.5, 1.5, 64).astype(np.float32)
    g = np.where(np.arange(64) % 2, 1.0, -1.0).astype(np.float32) * 0.3
    jp = {"w": jnp.asarray(p0).astype(jnp.bfloat16)}
    jg = {"w": jnp.asarray(g).astype(jnp.bfloat16)}
    jopt = JaxAdam(lr)
    jstate = jopt.init(jp)
    apply = jax.jit(jopt.apply_gradients)
    pp, pg = _port(jp), _port(jg)
    popt = Adam(lr)
    pstate = popt.init(pp)
    old_p = pp["w"].clone()
    old_m, old_v = torch.zeros_like(old_p), torch.zeros_like(old_p)
    for i in range(steps):
        jp, jstate = apply(jp, jg, jstate)
        popt.apply_gradients(pp, pg, pstate)
        _old_update(old_p, pg["w"], old_m, old_v, lr, i + 1)
    start = _port({"w": jnp.asarray(p0).astype(jnp.bfloat16)})["w"]
    # the old update: bitwise frozen
    assert old_p.dtype == torch.bfloat16 and torch.equal(old_p, start)
    # both packages: the master moved by ~steps * lr, and so did the
    # parameter, by several ulps
    moved = (pstate["slots"]["w"]["master"] - start.float()).abs()
    assert float(moved.min()) > 0.5 * steps * lr
    assert not torch.equal(pp["w"], start)
    _close(pstate["slots"]["w"]["master"], jstate["slots"]["w"]["master"])
    assert np.array_equal(pp["w"].float().numpy(),
                          np.asarray(jp["w"], np.float32))


def test_dtype_names_map_to_torch():
    assert convert_dtype("bfloat16") is torch.bfloat16
    assert convert_dtype("fp16") is torch.float16
    assert convert_dtype(np.float32) is torch.float32
    assert convert_dtype(np.dtype("int64")) is torch.int64
    assert convert_dtype(jnp.bfloat16) is torch.bfloat16
    assert convert_dtype(torch.float16) is torch.float16
    with pytest.raises(ValueError, match="unknown dtype"):
        convert_dtype("float8")
    from paddle_tpu_torch.core.dtype import is_floating
    assert is_floating("bf16") and not is_floating("int32")


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused_state", [False, True])
def test_fused_adam_route_updates_the_fp32_masters(monkeypatch, fused_state,
                                                   moments):
    # fused_adam on bf16 parameters: one kernel call a step over the fp32
    # masters (one flat master under fused_state), with a scheduled rate
    # (lr * wd then a device tensor); bf16 moments stay unfused. On the
    # CPU the route runs the leaf variant's plain version, which is the
    # unfused update bit for bit
    from paddle_tpu_torch import kernels
    seen = []
    real = kernels.maybe_fused_adam

    def spy(params, *args):
        seen.append((args[-1], {p.dtype for p in params}, len(params),
                     isinstance(args[8], torch.Tensor)))
        return real(params, *args)
    monkeypatch.setattr(kernels, "maybe_fused_adam", spy)

    def run(flags):
        params = {k: tensor_from_numpy(v).to(torch.bfloat16)
                  for k, v in _numpy_params().items()}
        opt = AdamW(port_lr.CosineAnnealingDecay(1e-2, T_max=4),
                    weight_decay=0.1, fused_state=fused_state)
        set_flags(dict(flags, optimizer_moment_dtype=moments))
        try:
            state = opt.init(params)
            rng = np.random.default_rng(4)
            for _ in range(3):
                opt.apply_gradients(params, _port(_grads(rng, jnp.bfloat16)),
                                    state)
        finally:
            set_flags({"fused_adam": False,
                       "optimizer_moment_dtype": "float32"})
        return params, state

    base = run({})
    assert seen == []
    fused = run({"fused_adam": True})
    if moments == "bfloat16":
        assert seen == []
    else:
        assert seen == [("leaf", {torch.float32},
                         1 if fused_state else len(SHAPES), True)] * 3
    for k in SHAPES:
        assert torch.equal(base[0][k], fused[0][k]), k
    masters = [base[1]["fused"]["master"]] if fused_state else \
        [base[1]["slots"][k]["master"] for k in SHAPES]
    assert all(m.dtype == torch.float32 for m in masters)
