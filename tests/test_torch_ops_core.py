"""PyTorch port: the core op library (``ops.math``, ``activation``,
``reduction``, ``manipulation``, ``search``, ``random_ops``,
``control_flow``, ``tensor_array``) against the JAX package's twins on
the CPU.

Each deterministic function runs on the same numpy inputs through both
packages; outputs agree within ``RTOL``/``ATOL`` (fp32; a few ulps of
the transcendental functions) and integer/bool outputs exactly (values:
the port gives int64 where JAX with x64 off gives int32). Ties and
``-0.0`` cases pin ``topk``, ``argsort``, ``sort``, ``median`` and
``mode`` to the JAX orders. Random ops cannot match threefry's bits:
they are checked by shape and dtype against the JAX op, by distribution
(scipy at a fixed seed), and by reproducibility from a key. A
coverage test requires every public function of the eight modules to
have a case here.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from scipy import stats  # noqa: E402

import paddle_tpu as pt  # noqa: E402
from paddle_tpu.ops import activation as j_act  # noqa: E402
from paddle_tpu.ops import control_flow as j_cf  # noqa: E402
from paddle_tpu.ops import manipulation as j_man  # noqa: E402
from paddle_tpu.ops import math as j_math  # noqa: E402
from paddle_tpu.ops import random_ops as j_rand  # noqa: E402
from paddle_tpu.ops import reduction as j_red  # noqa: E402
from paddle_tpu.ops import search as j_search  # noqa: E402
from paddle_tpu.ops import tensor_array as j_ta  # noqa: E402

import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu_torch import set_flags  # noqa: E402
from paddle_tpu_torch.ops import activation as t_act  # noqa: E402
from paddle_tpu_torch.ops import control_flow as t_cf  # noqa: E402
from paddle_tpu_torch.ops import manipulation as t_man  # noqa: E402
from paddle_tpu_torch.ops import math as t_math  # noqa: E402
from paddle_tpu_torch.ops import random_ops as t_rand  # noqa: E402
from paddle_tpu_torch.ops import reduction as t_red  # noqa: E402
from paddle_tpu_torch.ops import search as t_search  # noqa: E402
from paddle_tpu_torch.ops import tensor_array as t_ta  # noqa: E402
from paddle_tpu_torch.testing import op_cases as C  # noqa: E402

RTOL, ATOL = 2e-5, 1e-6
MODS = {"math": (j_math, t_math), "activation": (j_act, t_act),
        "reduction": (j_red, t_red), "manipulation": (j_man, t_man),
        "search": (j_search, t_search), "random_ops": (j_rand, t_rand),
        "control_flow": (j_cf, t_cf), "tensor_array": (j_ta, t_ta)}

X, A = C.X, C.A
CASES = C.CASES
ARRAYS = set(t_ta.__all__)


def _j(v):
    if isinstance(v, np.ndarray):
        return jnp.asarray(v)
    if isinstance(v, list) and v and isinstance(v[0], np.ndarray):
        return [jnp.asarray(a) for a in v]
    return v


def _t(v):
    if isinstance(v, np.ndarray):
        return torch.from_numpy(v.copy())
    if isinstance(v, list) and v and isinstance(v[0], np.ndarray):
        return [torch.from_numpy(a.copy()) for a in v]
    return v


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _flat(o)]
    if isinstance(out, torch.Tensor):
        return [out.numpy()]
    return [np.asarray(out)]


def _agree(got, want, what):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert g.shape == w.shape, (what, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       equal_nan=True, err_msg=what)
            # the sign of a zero and the place of a NaN agree too
            np.testing.assert_array_equal(np.signbit(g[g == 0]),
                                          np.signbit(w[w == 0]),
                                          err_msg=what)
        else:
            np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("mod,name,args,kw", CASES,
                         ids=[f"{c[0]}.{c[1]}-{i}"
                              for i, c in enumerate(CASES)])
def test_op_matches_jax(mod, name, args, kw):
    jmod, tmod = MODS[mod]
    want = getattr(jmod, name)(*(_j(a) for a in args), **kw)
    got = getattr(tmod, name)(*(_t(a) for a in args), **kw)
    _agree(got, want, f"{mod}.{name}")


def test_every_public_function_has_a_case():
    covered = {c[1] for c in CASES} | C.RANDOM | C.CREATION | C.CONTROL \
        | ARRAYS
    assert set(MODS) == set(C.MODULES)
    for mod in C.MODULES:
        missing = set(MODS[mod][1].__all__) - covered
        assert not missing, (mod, sorted(missing))
    # and the root and ops namespaces export them as the JAX root does
    for name in ("matmul", "topk", "where", "cond", "TensorArray", "randn",
                 "median", "relu", "concat", "to_tensor", "grad",
                 "no_grad", "value_and_grad", "seed", "float32", "int64",
                 "CPUPlace", "CUDAPlace"):
        assert hasattr(ptt, name) and hasattr(pt, name), name


@pytest.mark.parametrize("name,args,kw", [
    ("fill_constant", ([2, 3], "int32", 7), {}),
    ("full", ([2, 3], 1.5), {}), ("full", ([2], 4), {}),
    ("full", ([2], True), {}), ("full", ([2, 2], 3, "float32"), {}),
    ("zeros", ([2, 3],), {}), ("ones", ([3],), {"dtype": "int64"}),
    ("arange", (5,), {}), ("arange", (1, 7, 2), {"dtype": "float32"}),
    ("linspace", (0.0, 1.0, 5), {}), ("eye", (3,), {}),
    ("eye", (2, 4), {"dtype": "int32"})])
def test_creation_ops_on_a_device(name, args, kw):
    want = getattr(j_man, name)(*args, **kw)
    got = getattr(t_man, name)(*args, **kw, device="cpu")
    assert got.device.type == "cpu"
    _agree(got, want, name)
    # a Python float fills float32 and an int int64 (JAX: int32)
    if name == "full" and not kw and len(args) == 2:
        assert got.dtype == {float: torch.float32, int: torch.int64,
                             bool: torch.bool}[type(args[1])]
    assert t_man.is_empty(torch.zeros(0, 3)) is True
    assert t_man.is_empty(got) is j_man.is_empty(want)


def test_creation_defaults_to_the_card():
    if torch.cuda.is_available():
        assert t_man.zeros([2]).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_man.zeros([2])


# ---------------------------------------------------------------------------
# matmul_precision
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value,tf32", [("float32", False),
                                        ("highest", False),
                                        ("tensorfloat32", True),
                                        ("default", None)])
def test_matmul_precision_reader(monkeypatch, value, tf32):
    """Each reader sets TF32 around its own call and restores it; the nn
    layers do not read the flag."""
    seen = []
    real = torch.matmul

    def spy(*a, **k):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(*a, **k)

    before = torch.backends.cuda.matmul.allow_tf32
    set_flags({"matmul_precision": value})
    try:
        monkeypatch.setattr(torch, "matmul", spy)
        x = torch.ones(2, 3)
        t_math.matmul(x, x.T)
        t_math.bmm(x[None], x.T[None])
        t_math.mul(x, x.T)
        t_math.addmm(torch.zeros(2, 2), x, x.T)
        from paddle_tpu_torch.nn import Linear
        Linear(3, 3, device="cpu")(x)  # reads nothing
        n_readers = 4
        want = [before if tf32 is None else tf32] * n_readers
        assert seen[:n_readers] == want
        assert seen[n_readers:] == [before]
        assert torch.backends.cuda.matmul.allow_tf32 == before
    finally:
        set_flags({"matmul_precision": "default"})
        torch.backends.cuda.matmul.allow_tf32 = before


def test_matmul_precision_values_and_parity():
    set_flags({"matmul_precision": "float32"})
    pt.set_flags({"matmul_precision": "float32"})
    try:
        _agree(t_math.einsum("ij,jk->ik", _t(X), _t(A)),
               j_math.einsum("ij,jk->ik", _j(X), _j(A)), "einsum")
        set_flags({"matmul_precision": "bogus"})
        with pytest.raises(ValueError, match="matmul_precision"):
            t_math.matmul(_t(X), _t(A))
    finally:
        set_flags({"matmul_precision": "default"})
        pt.set_flags({"matmul_precision": "default"})


# ---------------------------------------------------------------------------
# random ops: shapes and dtypes as JAX's, distributions, reproducibility
# ---------------------------------------------------------------------------

N = 20000
KS_P = 1e-3  # a correct sampler fails this at a fixed seed 1 time in 1000


def _draw(name, *args, key=7, **kw):
    return getattr(t_rand, name)(*args, key=key, device="cpu", **kw)


@pytest.mark.parametrize("name,args,kw,dist", [
    ("uniform", ([N],), {"min": -2.0, "max": 3.0},
     stats.uniform(-2.0, 5.0)),
    ("uniform_random", ([N],), {}, stats.uniform(-1.0, 2.0)),
    ("gaussian", ([N],), {"mean": 1.0, "std": 2.0}, stats.norm(1.0, 2.0)),
    ("gaussian_random", ([N],), {}, stats.norm()),
    ("standard_normal", ([N],), {}, stats.norm()),
    ("randn", ([N],), {}, stats.norm()),
    ("rand", ([N],), {}, stats.uniform()),
    ("truncated_gaussian_random", ([N],), {"mean": 0.5, "std": 2.0},
     stats.truncnorm(-2.0, 2.0, loc=0.5, scale=2.0)),
    ("truncated_normal", ([N],), {"a": -1.0, "b": 0.5},
     stats.truncnorm(-1.0, 0.5)),
    ("exponential", ([N],), {"rate": 2.0}, stats.expon(scale=0.5))])
def test_continuous_random_ops(name, args, kw, dist):
    out = _draw(name, *args, **kw)
    jkw = {k: v for k, v in kw.items()}
    want = getattr(j_rand, name)(*args, key=jax.random.key(0), **jkw)
    assert tuple(out.shape) == tuple(want.shape)
    assert out.dtype == torch.float32 and want.dtype == jnp.float32
    assert stats.kstest(out.numpy(), dist.cdf).pvalue > KS_P
    assert stats.kstest(np.asarray(want), dist.cdf).pvalue > KS_P
    # the same key draws the same bits, another key others
    assert torch.equal(out, _draw(name, *args, **kw))
    assert not torch.equal(out, _draw(name, *args, key=8, **kw))
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    assert torch.equal(getattr(t_rand, name)(*args, key=g1, device="cpu",
                                             **kw),
                       getattr(t_rand, name)(*args, key=g2, device="cpu",
                                             **kw))


def test_normal_broadcasts_tensor_moments():
    mean = torch.tensor([0.0, 10.0])
    out = t_rand.normal(mean, 2.0, shape=[N, 2], key=1)
    want = j_rand.normal(jnp.asarray([0.0, 10.0]), 2.0, shape=[N, 2],
                         key=jax.random.key(0))
    assert out.shape == want.shape
    for col in range(2):
        assert stats.kstest(out[:, col].numpy(), stats.norm(
            float(mean[col]), 2.0).cdf).pvalue > KS_P


def test_discrete_random_ops():
    ints = _draw("randint", 3, 9, shape=[N])
    want = j_rand.randint(3, 9, shape=[N], key=jax.random.key(0))
    assert ints.shape == want.shape and ints.dtype == torch.int64
    counts = np.bincount(ints.numpy() - 3, minlength=6)
    assert ints.min() >= 3 and ints.max() <= 8
    assert stats.chisquare(counts).pvalue > KS_P
    perm = _draw("randperm", 50)
    assert sorted(perm.tolist()) == list(range(50))
    assert perm.dtype == torch.int64
    p = torch.full((N,), 0.3)
    b = t_rand.bernoulli(p, key=2)
    assert b.dtype == torch.float32 and b.shape == (N,)
    assert stats.binomtest(int(b.sum()), N, 0.3).pvalue > KS_P
    lam = torch.full((N,), 4.0)
    po = t_rand.poisson(lam, key=2)
    assert po.dtype == torch.float32
    obs = np.bincount(po.numpy().astype(int), minlength=30)[:12]
    exp = stats.poisson(4.0).pmf(np.arange(12)) * N
    assert stats.chisquare(obs, exp * obs.sum() / exp.sum()).pvalue > KS_P
    probs = torch.tensor([[0.1, 0.2, 0.7], [0.5, 0.5, 0.0]])
    m = t_rand.multinomial(probs, 2000, replacement=True, key=3)
    jm = j_rand.multinomial(jnp.asarray(probs.numpy()), 2000,
                            replacement=True, key=jax.random.key(0))
    assert tuple(m.shape) == tuple(jm.shape) == (2, 2000)
    for row in range(2):
        freq = np.bincount(m[row].numpy(), minlength=3) / 2000
        np.testing.assert_allclose(freq, probs[row].numpy(), atol=0.04)
    m2 = t_rand.multinomial(probs, 2, key=3)
    assert m2.shape == (2, 2) and bool((m2[1] != 2).all())
    assert m2[0, 0] != m2[0, 1] and m2[1, 0] != m2[1, 1]


def test_shuffles_and_sample_logits():
    x = torch.arange(40.0).reshape(10, 4)
    s = t_rand.shuffle(x, key=1)
    assert sorted(s[:, 0].tolist()) == x[:, 0].tolist()
    assert torch.equal(s[:, 1] - s[:, 0], torch.ones(10))
    assert torch.equal(t_rand.shuffle_batch(x, key=1), s)
    s1 = t_rand.shuffle(x, axis=1, key=1)
    assert sorted(s1[0].tolist()) == x[0].tolist()
    logits = torch.from_numpy(X)
    lab = torch.tensor([1, 3, 0])
    sl, sla = t_rand.sample_logits(logits, lab, 5, key=4)
    jl, jla = j_rand.sample_logits(jnp.asarray(X), jnp.asarray([1, 3, 0]),
                                   5, key=jax.random.key(0))
    assert sl.shape == jl.shape and sla.shape == jla.shape
    np.testing.assert_array_equal(sl[:, 0].numpy(), np.asarray(jl)[:, 0])
    assert int(sla.abs().sum()) == 0


def test_random_ops_draw_from_the_seeded_stream():
    ptt.seed(11)
    a = t_rand.uniform([64], device="cpu")
    ptt.seed(11)
    b = t_rand.uniform([64], device="cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, t_rand.uniform([64], device="cpu"))
    x = torch.from_numpy(X)
    r = t_act.rrelu(x, training=True, key=5)
    slope = (r / x)[x < 0]
    assert bool(((slope >= 0.125) & (slope <= 0.333)).all())
    assert torch.equal(r, t_act.rrelu(x, training=True, key=5))
    u = t_math.uniform_random_batch_size_like(x, [1, 6], min=0.0, max=1.0,
                                              key=2)
    g = t_math.gaussian_random_batch_size_like(x, [1, 6], key=2)
    ju = j_math.uniform_random_batch_size_like(jnp.asarray(X), [1, 6],
                                               key=jax.random.key(0))
    assert u.shape == g.shape == ju.shape == (3, 6)
    assert bool(((u >= 0) & (u < 1)).all())


# ---------------------------------------------------------------------------
# control flow (operator-only bodies run on both packages' arrays)
# ---------------------------------------------------------------------------

def _both_cf(run):
    want = run(j_cf, jnp.asarray(X))
    got = run(t_cf, torch.from_numpy(X.copy()))
    _agree(got, want, run.__name__)


def test_control_flow_ops_match_jax():
    for run in C.control_flow_runs():
        _both_cf(run)


def test_py_func_and_print(capsys):
    spec = jax.ShapeDtypeStruct((3, 4), jnp.float32)
    want = j_cf.py_func(lambda a: np.sin(a), jnp.asarray(X), spec)
    got = t_cf.py_func(lambda a: np.sin(a), torch.from_numpy(X), spec)
    _agree(got, want, "py_func")
    x = torch.from_numpy(X.copy()).requires_grad_(True)
    y = t_cf.py_func(lambda a: a ** 2, x, spec,
                     grad_func=lambda dy, a: 2 * a * dy)
    y.sum().backward()
    jg = jax.grad(lambda a: j_cf.py_func(
        lambda v: v ** 2, a, spec,
        grad_func=lambda dy, v: 2 * v * dy).sum())(jnp.asarray(X))
    _agree(x.grad, jg, "py_func grad")
    out = t_cf.print_op(torch.ones(2), message="v=")
    assert torch.equal(out, torch.ones(2))
    assert "v=" in capsys.readouterr().out


def test_tensor_cond_refuses_effects_and_mismatch():
    from paddle_tpu_torch.dy2static import BranchEffectError
    x = torch.from_numpy(X.copy())
    with pytest.raises(BranchEffectError, match="rand"):
        t_cf.cond(x.sum() > 0, lambda: x + torch.rand(3, 4), lambda: x)
    buf = torch.zeros(1)
    with pytest.raises(BranchEffectError, match="in place"):
        t_cf.cond(x.sum() > 0, lambda: buf.add_(1), lambda: buf)
    with pytest.raises(ValueError, match="matching branch outputs"):
        t_cf.cond(x.sum() > 0, lambda: x, lambda: x[0])


def test_while_loop_on_a_tensor_is_noted_eager():
    from paddle_tpu_torch.dy2static import convert_ops as cf
    x = torch.tensor(0.0)
    with cf.static_scope() as frame:
        out = t_cf.while_loop(lambda v: v < 3, lambda v: v + 1, x)
    assert float(out) == 3.0
    assert frame.eager_reasons and "while_loop" in frame.eager_reasons[0]


# ---------------------------------------------------------------------------
# TensorArray
# ---------------------------------------------------------------------------

def test_tensor_array_matches_jax():
    want = C.tensor_array_run(j_ta, jnp.asarray(X))
    got = C.tensor_array_run(t_ta, torch.from_numpy(X.copy()), device="cpu")
    _agree(got, want, "tensor_array")
    assert got[3].dtype == torch.int32
