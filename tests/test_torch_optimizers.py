"""PyTorch port: the rest of the optimizer family and the wrappers of
``optimizer.extras`` against the JAX package on the CPU.

Both packages get the same numpy parameters and, each step, the same
gradients (bf16 ones carried bit for bit) and run their own update for
``STEPS`` steps. The update math is fp32 on both sides (on the fp32
masters of bf16 parameters), so every fp32 quantity must agree within
the case's tolerance of its largest entry; a bf16 parameter agrees to one
step of bf16. Dpsgd's noise is torch's, not threefry's: it is held
against JAX with ``sigma=0`` and by its moments otherwise.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from paddle_tpu import optimizer as jopt  # noqa: E402

from paddle_tpu_torch import optimizer as popt  # noqa: E402
from paddle_tpu_torch.convert import (opt_state_from_jax,  # noqa: E402
                                      tensor_from_numpy)
from paddle_tpu_torch.core import random as prandom  # noqa: E402

STEPS = 10
# fp32 update math in the same order on both sides: a few ulps of the
# largest entry after 10 steps
TOL = 2e-6
# a norm per leaf (LARS, Lamb, Dpsgd's clip) sums its squares in another
# order than XLA, and the scale it gives multiplies the whole leaf
NORM_TOL = 1e-5
BF16_ULP = 2.0 ** -7
SHAPES = {"fc.weight": (24, 16), "fc.bias": (16,), "norm.weight": (16,),
          "emb.weight": (50, 8), "head.weight": (3, 5)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _exclude_norm(name: str) -> bool:
    return "norm" in name


# name -> (kwargs, tolerance, elementwise)
OPTIMIZERS = {
    "LarsMomentum": (dict(learning_rate=0.1, momentum=0.9,
                          lars_coeff=0.001, lars_weight_decay=5e-4),
                     NORM_TOL, False),
    "Adamax": (dict(learning_rate=1e-2), TOL, True),
    "Adagrad": (dict(learning_rate=1e-2, initial_accumulator_value=0.1),
                TOL, True),
    "Adadelta": (dict(learning_rate=1.0, rho=0.9), TOL, True),
    "RMSProp": (dict(learning_rate=1e-2, momentum=0.5), TOL, True),
    "RMSProp_centered": (dict(learning_rate=1e-2, momentum=0.5,
                              centered=True), TOL, True),
    "Lamb": (dict(learning_rate=1e-2, lamb_weight_decay=0.01,
                  exclude_from_weight_decay_fn=_exclude_norm),
             NORM_TOL, False),
    "Ftrl": (dict(learning_rate=0.1, l1=0.01, l2=0.01), TOL, False),
    "Dpsgd": (dict(learning_rate=1e-2, clip=1.0, batch_size=4.0,
                   sigma=0.0), NORM_TOL, False),
    "DecayedAdagrad": (dict(learning_rate=1e-2), TOL, False),
    "ProximalGD": (dict(learning_rate=1e-2, l1=0.01, l2=0.01), TOL, False),
    "ProximalAdagrad": (dict(learning_rate=1e-2, l1=0.01, l2=0.01), TOL,
                        False),
}


def _make(pkg, name: str, fused=None):
    kw, _, _ = OPTIMIZERS[name]
    cls = getattr(pkg, name.split("_")[0])
    return cls(fused_state=fused, **kw)


def _numpy_params(seed=1):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _port(tree):
    return {k: tensor_from_numpy(np.asarray(v)) for k, v in tree.items()}


def _close(got, want, tol, what=""):
    g = got.detach().float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape, what
    scale = max(float(np.max(np.abs(w))), 1e-30)
    err = float(np.max(np.abs(g - w))) / scale
    assert err <= tol, (what, err)


def _run_both(jo, po, dtype, steps=STEPS, seed=3, jstate=None, pstate=None,
              jp=None, pp=None):
    jdt = DTYPES[dtype][0]
    if jp is None:
        jp = {k: jnp.asarray(v).astype(jdt)
              for k, v in _numpy_params().items()}
        pp = _port(jp)
    if jstate is None:
        jstate, pstate = jo.init(jp), po.init(pp)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        g = {k: jnp.asarray(rng.standard_normal(s), jnp.float32).astype(jdt)
             for k, s in SHAPES.items()}
        jp, jstate = jo.apply_gradients(jp, g, jstate)
        po.apply_gradients(pp, _port(g), pstate)
    return jp, jstate, pp, pstate


def _compare_tree(got, want, tol, what):
    if isinstance(want, dict):
        assert set(got) == set(want), (what, set(got) ^ set(want))
        for k in want:
            _compare_tree(got[k], want[k], tol, f"{what}/{k}")
        return
    if got.dtype in (torch.int32, torch.int64):
        assert int(got) == int(want), what
        return
    want_dtype = str(jnp.asarray(want).dtype)
    if want_dtype in DTYPES:
        assert got.dtype == DTYPES[want_dtype][1], what
    _close(got, want, tol, what)


def _compare(jp, jstate, pp, pstate, dtype, tol):
    assert int(pstate["step"]) == int(jstate["step"])
    for k in SHAPES:
        assert pp[k].dtype == DTYPES[dtype][1], k
        _close(pp[k], jp[k], tol if dtype == "float32" else BF16_ULP, k)
    _compare_tree(pstate["slots"], jstate["slots"], tol, "slots")
    if "fused" in jstate:
        _compare_tree(pstate["fused"], jstate["fused"], tol, "fused")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_jax_ten_steps(name, dtype):
    out = _run_both(_make(jopt, name), _make(popt, name), dtype)
    _compare(*out, dtype, OPTIMIZERS[name][1])
    pstate = out[3]
    for k in SHAPES:
        assert ("master" in pstate["slots"][k]) == (dtype != "float32")
        for s, t in pstate["slots"][k].items():
            assert t.dtype == torch.float32, (k, s)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_fused_state_as_jax_decides_it(name):
    # elementwise updates pack the flat fused state, as in JAX; the rest
    # run per leaf under fused_state without raising, as JAX's _use_fused
    elementwise = OPTIMIZERS[name][2]
    po = _make(popt, name, fused=True)
    assert po._elementwise_update is elementwise
    assert _make(jopt, name)._elementwise_update is elementwise
    out = _run_both(_make(jopt, name, fused=True), po, "bfloat16", steps=4)
    assert ("fused" in out[3]) is elementwise
    _compare(*out, "bfloat16", OPTIMIZERS[name][1])
    if elementwise:
        # the same elementwise update on the flat master: bit for bit the
        # per-leaf one
        leaf = _run_both(_make(jopt, name), _make(popt, name), "bfloat16",
                         steps=4)
        for k in SHAPES:
            assert torch.equal(out[2][k], leaf[2][k]), k


def test_aliases_name_the_classes():
    for alias, cls in (("LarsMomentumOptimizer", "LarsMomentum"),
                       ("AdamaxOptimizer", "Adamax"),
                       ("AdagradOptimizer", "Adagrad"),
                       ("AdadeltaOptimizer", "Adadelta"),
                       ("RMSPropOptimizer", "RMSProp"),
                       ("LambOptimizer", "Lamb"), ("FtrlOptimizer", "Ftrl")):
        assert getattr(popt, alias) is getattr(popt, cls)
        assert hasattr(jopt, alias)


def test_zero_norm_branches_match_jax():
    # a zero parameter takes LARS's plain rate and Lamb's unit trust
    # ratio; a zero gradient Dpsgd's floor of the norm
    zeros = {"w": np.zeros((4, 3), np.float32), "b": np.ones(3, np.float32)}
    for name in ("LarsMomentum", "Lamb", "Dpsgd"):
        jo, po = _make(jopt, name), _make(popt, name)
        jp = {k: jnp.asarray(v) for k, v in zeros.items()}
        pp = _port(jp)
        js, ps = jo.init(jp), po.init(pp)
        for g in ({"w": np.ones((4, 3), np.float32),
                   "b": np.zeros(3, np.float32)},) * 2:
            jp, js = jo.apply_gradients(jp, {k: jnp.asarray(v)
                                             for k, v in g.items()}, js)
            po.apply_gradients(pp, _port(g), ps)
        for k in zeros:
            _close(pp[k], jp[k], NORM_TOL, (name, k))
            assert torch.isfinite(pp[k]).all(), (name, k)


def test_dpsgd_noise_moments_and_generator():
    n = 200_000
    opt = popt.Dpsgd(learning_rate=1.0, clip=1.0, batch_size=1.0,
                     sigma=1.0, seed=7)
    p = {"w": torch.zeros(n)}
    state = opt.init(p)
    opt.apply_gradients(p, {"w": torch.zeros(n)}, state)
    noise = -p["w"]
    assert abs(float(noise.mean())) < 5.0 / n ** 0.5
    assert abs(float(noise.std()) - 1.0) < 0.01
    # its own generator is seeded with `seed`; inside rng_scope it draws
    # from the bound one (a TrainStep's)
    want = torch.randn(n, generator=torch.Generator().manual_seed(7))
    assert torch.equal(noise, want)
    gen = torch.Generator().manual_seed(11)
    p2 = {"w": torch.zeros(n)}
    with prandom.rng_scope(default=gen):
        opt.apply_gradients(p2, {"w": torch.zeros(n)}, opt.init(p2))
    assert torch.equal(-p2["w"], torch.randn(
        n, generator=torch.Generator().manual_seed(11)))


# wrapper -> (JAX and port constructors over an inner, tolerance)
def _inner(pkg, kind="momentum"):
    if kind == "sgd":
        return pkg.SGD(learning_rate=0.05)
    return pkg.Momentum(learning_rate=0.05, momentum=0.9)


WRAPPERS = {
    "ema": lambda pkg: pkg.ExponentialMovingAverage(_inner(pkg), 0.9),
    "ema_fixed": lambda pkg: pkg.ExponentialMovingAverage(
        _inner(pkg), 0.8, thres_steps=False),
    "model_average": lambda pkg: pkg.ModelAverage(
        _inner(pkg), max_average_window=3),
    "lookahead": lambda pkg: pkg.Lookahead(_inner(pkg), alpha=0.5, k=3),
    "gradient_merge": lambda pkg: pkg.GradientMerge(_inner(pkg), k_steps=2),
    "gradient_merge_sum": lambda pkg: pkg.GradientMerge(
        _inner(pkg, "sgd"), k_steps=4, avg=False),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_matches_jax_ten_steps(name, dtype):
    jo, po = WRAPPERS[name](jopt), WRAPPERS[name](popt)
    jp, jstate, pp, pstate = _run_both(jo, po, dtype)
    # a bf16 tree: JAX rounds each of its bf16 ops (EMA's d * e and
    # (1 - d) * p apart), the port its fp32 result once
    tol = TOL if dtype == "float32" else 2 * BF16_ULP
    _compare(jp, jstate, pp, pstate, dtype, TOL)
    _compare_tree(pstate["wrap"], jstate["wrap"], tol, "wrap")
    for k, v in pstate["wrap"].items():
        if isinstance(v, dict):
            # each parameter-keyed tree in its parameter's dtype
            assert all(t.dtype == DTYPES[dtype][1] for t in v.values()), k


def test_wrapper_apply_swaps_in_place_and_back():
    for name in ("ema", "model_average"):
        po = WRAPPERS[name](popt)
        params = _port({k: jnp.asarray(v) for k, v in
                        _numpy_params().items()})
        holder = type("Step", (), {})()
        holder.params, holder.state = params, po.init(params)
        rng = np.random.default_rng(5)
        for _ in range(4):
            po.apply_gradients(params, {k: torch.from_numpy(
                rng.standard_normal(s).astype(np.float32))
                for k, s in SHAPES.items()}, holder.state)
        trained = {k: v.clone() for k, v in params.items()}
        ptrs = {k: v.data_ptr() for k, v in params.items()}
        shadow = po.shadow_params(holder.state) if name == "ema" \
            else po.averaged_params(holder.state)
        with po.apply(holder):
            for k, v in params.items():
                assert torch.equal(v, shadow[k].to(v.dtype)), k
                assert v.data_ptr() == ptrs[k]
        for k, v in params.items():
            assert torch.equal(v, trained[k]), k


@pytest.mark.parametrize("name", list(OPTIMIZERS) + list(WRAPPERS))
def test_skipped_update_changes_nothing(name):
    po = WRAPPERS[name](popt) if name in WRAPPERS else _make(popt, name)
    params = _port({k: jnp.asarray(v).astype(jnp.bfloat16)
                    for k, v in _numpy_params().items()})
    state = po.init(params)
    rng = np.random.default_rng(4)

    def grads():
        return {k: torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(torch.bfloat16) for k, s in SHAPES.items()}

    po.apply_gradients(params, grads(), state)
    before = ({k: v.clone() for k, v in params.items()},
              _flat(state))
    po.apply_gradients(params, grads(), state, torch.tensor(False))
    for k, v in params.items():
        assert torch.equal(v, before[0][k]), k
    for k, v in _flat(state).items():
        assert torch.equal(v, before[1][k]), k


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.clone()
    return out


@pytest.mark.parametrize("name", ["LarsMomentum", "RMSProp_centered",
                                  "ema", "gradient_merge"])
def test_state_crosses_from_jax_and_training_continues(name):
    make = WRAPPERS.get(name) or (lambda pkg: _make(pkg, name))
    jo, po = make(jopt), make(popt)
    jp, jstate, _, _ = _run_both(jo, po, "float32", steps=3)
    pp = _port(jp)
    pstate = opt_state_from_jax(
        jax.tree.map(np.asarray, jstate), pp)
    out = _run_both(jo, po, "float32", steps=3, seed=9, jstate=jstate,
                    pstate=pstate, jp=jp, pp=pp)
    tol = OPTIMIZERS[name][1] if name in OPTIMIZERS else TOL
    _compare(*out, "float32", tol)
    if "wrap" in jstate:
        _compare_tree(out[3]["wrap"], out[1]["wrap"], TOL, "wrap")
