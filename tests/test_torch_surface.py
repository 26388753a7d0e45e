"""PyTorch port: the root and subpackage surface, ``nn.functional``'s
re-exports (C7) and ``ops.attention``'s ``attention_bthd``/
``multihead_matmul`` against the JAX package on the CPU.

- Name parity: every public name of the JAX ``paddle_tpu``,
  ``nn.functional``, ``layers``, ``slim``, ``nn``, ``models``, ``data``,
  ``serving_llm``, ``native`` and ``core`` (the dtype defaults) resolves
  in the port's namesake, minus the TPU-only names (``TPUPlace``,
  ``is_compiled_with_tpu``) and ``core``'s JAX key streams.
- ``import paddle_tpu_torch`` reaches every subpackage the JAX root
  imports without importing JAX, lazily.
- ``nn.functional`` names the port's own ops (``F.cross_entropy`` is
  ``ops.loss.cross_entropy`` ...), and a sample of them equals the JAX
  ``nn.functional``'s within ``TOL``.
- ``attention_bthd`` and ``multihead_matmul`` within ``TOL`` of JAX's,
  ``multihead_matmul`` with the flash gate admitting the call in both
  packages: the Pallas kernel in interpret mode against the port's plain
  version of its CUDA kernel.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import importlib
import inspect
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as pt  # noqa: E402
import paddle_tpu.kernels as jkernels  # noqa: E402
from paddle_tpu.kernels import flash_attention as jax_fa  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu.ops import attention as jattn  # noqa: E402

import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu_torch import get_flags, set_flags  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.ops import attention as pattn  # noqa: E402

TOL = 2e-5
TPU_ONLY = {"TPUPlace", "is_compiled_with_tpu"}
# the JAX core's PRNG-key streams (Generator, next_key, rng_scope ...)
# are the port's core.random, under torch's generators
KEY_STREAMS = {"Generator", "as_label_tuple", "default_generator",
               "next_key", "rng_scope", "seed"}
ROOT = Path(__file__).resolve().parent.parent
RNG = np.random.default_rng(0)


def _public(mod) -> set:
    names = getattr(mod, "__all__", None)
    if names is not None:
        return set(names)
    out = set()
    for n in dir(mod):
        if n.startswith("_"):
            continue
        v = getattr(mod, n)
        if isinstance(v, types.ModuleType):
            if v.__name__.startswith("paddle_tpu"):
                out.add(n)
        elif (inspect.isclass(v) or callable(v)) and (
                getattr(v, "__module__", "") or "").startswith("paddle_tpu"):
            out.add(n)
    return out


@pytest.mark.parametrize("sub", ["", "nn.functional", "layers", "slim", "nn",
                                 "models", "data", "serving_llm", "native",
                                 "core", "incubate", "sysconfig"])
def test_names_match_jax(sub):
    suffix = "." + sub if sub else ""
    jmod = importlib.import_module("paddle_tpu" + suffix)
    pmod = importlib.import_module("paddle_tpu_torch" + suffix)
    skip = TPU_ONLY | (KEY_STREAMS if sub == "core" else set())
    missing = sorted(n for n in _public(jmod) - skip
                     if not hasattr(pmod, n))
    assert not missing, (sub, missing)


def test_root_reaches_subpackages_without_jax():
    code = (
        "import sys, paddle_tpu_torch as pt\n"
        "lazy = ('fluid', 'slim', 'incubate', 'sysconfig')\n"
        "assert not any('paddle_tpu_torch.' + n in sys.modules "
        "for n in lazy)\n"
        "for n in ('amp', 'data', 'datasets', 'distribution', 'hapi', "
        "'inference', 'io', 'nn', 'optimizer', 'parallel', 'static', "
        "'fleet', 'distributed', 'incubate', 'slim', 'fluid', 'sysconfig', "
        "'version', 'layers', 'jit', 'models'):\n"
        "    assert getattr(pt, n).__name__.startswith('paddle_tpu_torch'),"
        " n\n"
        "assert pt.fleet is pt.distributed.fleet\n"
        "assert pt.nn.Parameter is __import__('torch').nn.Parameter\n"
        "assert pt.batch is pt.reader.batch\n"
        "assert pt.ParamAttr is pt.param_attr.ParamAttr\n"
        "assert 'fluid' in dir(pt)\n"
        "assert 'jax' not in sys.modules\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_root_values_match_jax():
    assert ptt.__version__ == pt.__version__
    assert ptt.version.full_version == pt.version.full_version
    assert ptt.get_default_dtype() == torch.float32
    try:
        ptt.set_default_dtype("float64")
        assert ptt.core.get_default_dtype() == torch.float64
        with pytest.raises(ValueError, match="floating"):
            ptt.set_default_dtype("int32")
    finally:
        ptt.set_default_dtype("float32")
    with pytest.raises(AttributeError):
        ptt.definitely_not_a_name
    jcfg, pcfg = pt.models.bert_large_config(), \
        ptt.models.bert_large_config()
    for k in ("hidden_size", "num_hidden_layers", "num_attention_heads",
              "intermediate_size", "vocab_size"):
        assert getattr(pcfg, k) == getattr(jcfg, k), k
    assert ptt.models.bert_base_config() == ptt.models.BertConfig()
    snap = ptt.serving_llm.health_snapshot()
    assert snap["ok"] in (True, False) and isinstance(snap["engines"], list)
    assert isinstance(ptt.native.available(), bool)
    assert ptt.data.data_generator.MultiSlotDataGenerator is not None


def test_functional_names_the_port_ops():
    from paddle_tpu_torch.ops import activation, loss, nn_functional, \
        sequence
    assert F.cross_entropy is loss.cross_entropy
    assert F.softmax is activation.softmax
    assert F.gelu is activation.gelu
    assert F.linear is nn_functional.linear
    assert F.sequence_pool is sequence.sequence_pool
    assert F.multihead_matmul is pattn.multihead_matmul
    assert "gelu" in F.__all__ and "multihead_matmul" in F.__all__


X = RNG.normal(size=(4, 6)).astype(np.float32)
LABEL = RNG.integers(0, 6, (4,))


@pytest.mark.parametrize("name,args,kw", [
    ("softmax", (X,), {}), ("log_softmax", (X,), {"axis": 0}),
    ("gelu", (X,), {}), ("gelu", (X,), {"approximate": True}),
    ("relu", (X,), {}), ("silu", (X,), {}), ("leaky_relu", (X,), {}),
    ("cross_entropy", (X, LABEL), {}), ("mse_loss", (X, X[::-1].copy()), {}),
    ("smooth_l1_loss", (X, X[::-1].copy()), {}),
    ("sequence_mask", (np.array([1, 3]),), {"maxlen": 4}),
])
def test_functional_sample_matches_jax(name, args, kw):
    want = np.asarray(jax.jit(lambda *a: getattr(JF, name)(*a, **kw))(
        *args))
    got = getattr(F, name)(*[torch.from_numpy(np.asarray(a))
                             for a in args], **kw)
    got = got.detach().numpy()
    assert got.shape == want.shape
    if want.dtype == np.bool_:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= TOL * max(np.abs(want).max(), 1)


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (False, True)])
def test_attention_bthd_matches_jax(causal, masked):
    q, k, v = (RNG.normal(size=(2, 5, 3, 8)).astype(np.float32)
               for _ in range(3))
    mask = None
    if masked:
        mask = np.zeros((2, 1, 1, 5), np.float32)
        mask[1, ..., 3:] = -1e9
    want = jax.jit(lambda q_, k_, v_, m_: jattn.attention_bthd(
        q_, k_, v_, mask=m_, causal=causal))(q, k, v, mask)
    got = pattn.attention_bthd(
        *(torch.from_numpy(a) for a in (q, k, v)),
        mask=None if mask is None else torch.from_numpy(mask),
        causal=causal)
    assert got.shape == (2, 5, 3, 8)
    assert float((got - torch.tensor(np.asarray(want))).abs().max()) \
        <= TOL
    # the same math as the BHTD path
    ref = pattn.scaled_dot_product_attention(
        *(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)),
        mask=None if mask is None else torch.from_numpy(mask),
        causal=causal).transpose(1, 2)
    assert float((got - ref).abs().max()) <= TOL


@pytest.fixture
def flash_gate(monkeypatch):
    """Both packages' flash gates admit a [2, 64, 256] eval call at 2
    heads of 128: JAX's runs its Pallas kernel in interpret mode (small
    tiles), the port's the plain version of its CUDA kernel."""
    monkeypatch.setattr(jkernels, "pallas_enabled", lambda: True)
    monkeypatch.setattr(jax_fa, "BLOCK_Q", 32)
    monkeypatch.setattr(jax_fa, "BLOCK_K", 32)
    real = jax_fa.flash_attention
    calls = []

    def interpreted(*a, **kw):
        calls.append(1)
        return real(*a, **dict(kw, interpret=True))

    monkeypatch.setattr(jax_fa, "flash_attention", interpreted)
    names = ["flash_attention_min_seq"]
    old_j, old_p = pt.get_flags(names), get_flags(names)
    pt.set_flags({"flash_attention_min_seq": 64})
    set_flags({"flash_attention_min_seq": 64})
    try:
        yield calls
    finally:
        pt.set_flags(old_j)
        set_flags(old_p)


def _mhm_inputs(b=2, t=64, c=256):
    x = RNG.normal(size=(b, t, c)).astype(np.float32)
    w = (RNG.normal(size=(c, 3 * c)) / np.sqrt(c)).astype(np.float32)
    bias = (0.1 * RNG.normal(size=(3 * c,))).astype(np.float32)
    return x, w, bias


def test_multihead_matmul_through_flash_matches_jax(flash_gate):
    x, w, bias = _mhm_inputs()
    mask = np.zeros((2, 1, 1, 64), np.float32)
    mask[1, ..., 50:] = -1e9
    for m in (None, mask):
        want = jax.jit(lambda x_, m_: JF.multihead_matmul(
            x_, w, bias, 2, mask=m_))(x, m)
        got = F.multihead_matmul(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
            2, mask=None if m is None else torch.from_numpy(m))
        assert got.shape == (2, 64, 256)
        err = float((got - torch.tensor(np.asarray(want))).abs().max())
        assert err <= TOL, err
    assert flash_gate  # the Pallas kernel ran


def test_multihead_matmul_plain_route_matches_jax():
    """Head dim 64 at 64 keys in eval: both gates take the plain
    composition."""
    x, w, bias = _mhm_inputs(c=128)
    want = jax.jit(lambda x_: JF.multihead_matmul(x_, w, bias, 2))(x)
    got = F.multihead_matmul(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(bias), 2)
    assert float((got - torch.tensor(np.asarray(want))).abs().max()) \
        <= TOL
