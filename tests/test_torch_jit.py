"""PyTorch port: the inference export (``jit.save``/``load``,
``TranslatedLayer``, ``TracedLayer``, ``io.save_inference_model`` /
``load_inference_model``) and the kernels' operators, against the JAX
package on the CPU.

A small BERT encoder (2 layers, hidden 64, 2 heads, vocab 512, seq 32,
dropout 0) and the JAX inference tests' MLP are built in the JAX package
and their weights moved into the port by name; both packages export and
run them on the same numpy inputs. The JAX program runs XLA's attention;
the port's runs its plain composition (and, at head dim 128 with
``flash_attention_min_seq`` lowered, the plain version of its flash
forward through the ``paddle_tpu_torch::flash_attention`` operator).
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as pt  # noqa: E402
from paddle_tpu import io as jax_io  # noqa: E402
from paddle_tpu import jit as jax_jit  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.models import BertConfig as JaxBertConfig  # noqa: E402
from paddle_tpu.models import BertModel as JaxBertModel  # noqa: E402

import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu_torch import io as pio, jit, kernels  # noqa: E402
from paddle_tpu_torch.convert import load_jax_params  # noqa: E402
from paddle_tpu_torch.kernels import custom_ops  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.kernels import layer_norm as ln  # noqa: E402
from paddle_tpu_torch.models import BertConfig, BertModel  # noqa: E402
from paddle_tpu_torch.nn import Linear, functional as F  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=128,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             max_position_embeddings=64)
T = 32
# tests/test_torch_bert.py's: an fp32 forward through two encoder layers
# summed in another order than XLA's
LOGIT_TOL = 2e-5
BERT_INPUTS = ("input_ids", "token_type_ids", "attention_mask")


class _JaxNet(jnn.Layer):
    """tests/test_inference.py's MLP."""

    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(8, 16)
        self.fc2 = jnn.Linear(16, 3)

    def forward(self, x):
        return self.fc2(jnn.functional.relu(self.fc1(x)))


class _Net(torch.nn.Module):
    """The same MLP in the port (Linear weights [in, out], as JAX's)."""

    def __init__(self):
        super().__init__()
        self.fc1 = Linear(8, 16, device="cpu")
        self.fc2 = Linear(16, 3, device="cpu")

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _jax_params(layer):
    return {k: np.asarray(v) for k, v in layer.param_dict().items()}


@pytest.fixture(scope="module")
def mlp():
    pt.seed(7)
    jm = _JaxNet()
    return jm, load_jax_params(_Net(), _jax_params(jm))


@pytest.fixture(scope="module")
def bert():
    pt.seed(0)
    jm = JaxBertModel(JaxBertConfig(**SMALL))
    pm = load_jax_params(BertModel(BertConfig(**SMALL), device="cpu"),
                         _jax_params(jm))
    return jm, pm.eval()


def bert_inputs(batch, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, SMALL["vocab_size"], (batch, T)).astype(np.int64)
    types = rng.integers(0, 2, (batch, T)).astype(np.int64)
    mask = np.ones((batch, T), np.int64)
    mask[-1, T // 2:] = 0
    return [ids, types, mask]


def bert_specs(mod, dtype="int64"):
    return [mod.InputSpec([None, T], dtype, name=n) for n in BERT_INPUTS]


@pytest.fixture(scope="module")
def bert_exports(bert, tmp_path_factory):
    """(port artifact, JAX artifact, port artifact of ``input_ids``
    alone) of the same small BERT. The JAX export takes ``input_ids``
    alone: its ``jit.save`` gives each polymorphic spec a symbolic scope
    of its own, and ``jax.export`` refuses to mix them."""
    jm, pm = bert
    root = tmp_path_factory.mktemp("bert")
    jit.save(pm, str(root / "port"), input_spec=bert_specs(jit))
    jax_jit.save(jm, str(root / "jax"),
                 input_spec=bert_specs(jax_jit, "int32")[:1])
    jit.save(pm, str(root / "port_ids"), input_spec=bert_specs(jit)[:1])
    return str(root / "port"), str(root / "jax"), str(root / "port_ids")


def _eager(model, arrs):
    with torch.no_grad():
        return model(*(torch.from_numpy(a) for a in arrs))


@pytest.mark.parametrize("batches", [[5], [1, 3, 8]],
                         ids=["fixed", "polymorphic"])
def test_save_load_round_trip(mlp, tmp_path, batches):
    _, net = mlp
    shape = [batches[0], 8] if len(batches) == 1 else [None, 8]
    jit.save(net, str(tmp_path), input_spec=[jit.InputSpec(shape,
                                                           name="feats")])
    assert sorted(os.listdir(tmp_path)) == ["meta.json", "module.pt2",
                                            "params"]
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta["format"] == jit.FORMAT and meta["platforms"] == ["cpu"]
    assert meta["input_spec"] == [{"shape": shape, "dtype": "float32",
                                   "name": "feats"}]
    tl = jit.load(str(tmp_path), device="cpu")
    for b in batches:
        x = np.random.default_rng(b).normal(size=(b, 8)).astype(np.float32)
        got = tl(x)
        assert torch.equal(got, _eager(net, [x]))
    if len(batches) == 1:
        with pytest.raises(Exception):
            tl(np.zeros((batches[0] + 1, 8), np.float32))


def test_translated_layer_matches_jax(bert, bert_exports):
    jm, _ = bert
    port_dir, jax_dir, port_ids = bert_exports
    jtl = jax_jit.load(jax_dir)
    tl_ids = jit.load(port_ids, device="cpu")
    tl = jit.load(port_dir, device="cpu")
    assert [s.name for s in tl.input_spec] == list(BERT_INPUTS)
    for b in (1, 3, 8):
        arrs = bert_inputs(b, seed=b)
        pairs = [(tl_ids(arrs[0]), jtl(arrs[0].astype(np.int32))),
                 (tl(*arrs), jm(*(jnp.asarray(a.astype(np.int32))
                                  for a in arrs)))]
        for got, want in pairs:
            assert len(got) == len(want) == 2
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_program_holds_the_layer_norm_operator(bert_exports):
    tl = jit.load(bert_exports[0], device="cpu")
    targets = [str(n.target) for n in tl._module.graph.nodes]
    # the embeddings' LayerNorm and two in each of the two layers
    assert targets.count("paddle_tpu_torch.layer_norm.default") == 5
    assert not any("flash_attention" in t for t in targets)
    # the weights are the program's inputs, not constants in it
    assert not list(tl._module.parameters())
    assert not list(tl._module.buffers())


def test_port_params_read_by_jax_io_load(bert, bert_exports):
    jm, _ = bert
    flat = jax_io.load(os.path.join(bert_exports[0], "params"))
    want = _jax_params(jm)
    got = {k.split("/", 1)[1]: np.asarray(v) for k, v in flat.items()
           if k.startswith("params/")}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_each_loader_refuses_the_other_package(bert_exports):
    port_dir, jax_dir, _ = bert_exports
    with pytest.raises(ValueError, match="JAX package artifact.*"
                                         "paddle_tpu_jit"):
        jit.load(jax_dir, device="cpu")
    with pytest.raises(ValueError, match="not a paddle_tpu jit artifact"):
        jax_jit.load(port_dir)
    with pytest.raises(ValueError, match="not a paddle_tpu_torch export"):
        jit.load(os.path.join(port_dir, "params"), device="cpu")


@pytest.mark.parametrize("which", ["port", "jax"])
def test_load_inference_model_fills_a_port_model(bert, bert_exports,
                                                   which):
    _, pm = bert
    d = bert_exports[0] if which == "port" else bert_exports[1]
    fresh = BertModel(BertConfig(**SMALL), device="cpu").eval()
    arrs = bert_inputs(3)
    assert not torch.equal(_eager(fresh, arrs)[0], _eager(pm, arrs)[0])
    assert pio.load_inference_model(d, model=fresh) is fresh
    for g, w in zip(_eager(fresh, arrs), _eager(pm, arrs)):
        assert torch.equal(g, w)


def test_load_inference_model_without_a_model(bert_exports):
    tl = pio.load_inference_model(bert_exports[0], device="cpu")
    assert isinstance(tl, jit.TranslatedLayer)
    with pytest.raises(ValueError, match="JAX package artifact"):
        pio.load_inference_model(bert_exports[1], device="cpu")


def test_save_inference_model_layer_and_params_only(mlp, tmp_path):
    jm, net = mlp
    x = np.random.default_rng(1).normal(size=(4, 8)).astype(np.float32)
    pio.save_inference_model(str(tmp_path / "layer"), net, [x])
    tl = jit.load(str(tmp_path / "layer"), device="cpu")
    assert tl.input_spec[0].shape == (4, 8)
    assert torch.equal(tl(x), _eager(net, [x]))
    # a non-Layer: its params alone, readable by both packages
    params = {k: v.detach() for k, v in net.state_dict().items()}
    pio.save_inference_model(str(tmp_path / "raw"), object(), [x],
                             params=params)
    assert json.loads((tmp_path / "raw" / "inference.json").read_text())[
        "format"] == "paddle_tpu_inference"
    got = pio.load_inference_model(str(tmp_path / "raw"))
    from paddle_tpu.io import load_inference_model as jax_lim
    jflat = jax_lim(str(tmp_path / "raw"))
    for k, v in params.items():
        assert torch.equal(got[k], v)
        np.testing.assert_array_equal(np.asarray(jflat[k]), v.numpy())
    fresh = _Net()
    pio.load_inference_model(str(tmp_path / "raw"), model=fresh)
    assert torch.equal(_eager(fresh, [x]), _eager(net, [x]))


def test_head_dim_128_exports_the_flash_operator(tmp_path):
    cfg = dict(SMALL, hidden_size=256, num_attention_heads=2,
               intermediate_size=256)
    pt.seed(3)
    jm = JaxBertModel(JaxBertConfig(**cfg))
    pm = load_jax_params(BertModel(BertConfig(**cfg), device="cpu"),
                         _jax_params(jm)).eval()
    old = ptt.get_flags(["flash_attention_min_seq"])
    ptt.set_flags({"flash_attention_min_seq": 16})
    try:
        jit.save(pm, str(tmp_path), input_spec=bert_specs(jit))
    finally:
        ptt.set_flags(old)
    tl = jit.load(str(tmp_path), device="cpu")
    targets = [str(n.target) for n in tl._module.graph.nodes]
    assert targets.count("paddle_tpu_torch.flash_attention.default") == 2
    arrs = bert_inputs(3, seed=5)
    got = tl(*arrs)
    want = jm(*(jnp.asarray(a.astype(np.int32)) for a in arrs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_jit_load_in_a_fresh_process(bert, bert_exports, tmp_path):
    """The operators are defined by importing the package, so a process
    that only loads the artifact runs it."""
    _, pm = bert
    arrs = bert_inputs(2, seed=9)
    np.savez(tmp_path / "in.npz", *arrs)
    code = (
        "import sys, numpy as np\n"
        "from paddle_tpu_torch import jit\n"
        "a = np.load(sys.argv[2])\n"
        "out = jit.load(sys.argv[1], device='cpu')("
        "*[a[f'arr_{i}'] for i in range(3)])\n"
        "np.save(sys.argv[3], out[0].numpy())\n"
        "assert 'jax' not in sys.modules and 'paddle_tpu' not in "
        "sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code, bert_exports[0],
                    str(tmp_path / "in.npz"), str(tmp_path / "out.npy")],
                   check=True, env=env, cwd=str(tmp_path), timeout=300)
    got = np.load(tmp_path / "out.npy")
    np.testing.assert_array_equal(got, _eager(pm, arrs)[0].numpy())


def test_traced_layer(mlp, tmp_path):
    jm, net = mlp
    x = np.random.default_rng(2).normal(size=(3, 8)).astype(np.float32)
    out, traced = jit.TracedLayer.trace(net, [x])
    want = _eager(net, [x])
    assert torch.equal(out, want)
    jout, _ = jax_jit.TracedLayer.trace(jm, [x])
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    # the weights are frozen at the trace
    twin = load_jax_params(_Net(), _jax_params(jm))
    with torch.no_grad():
        twin.fc2.bias.add_(1.0)
    traced_twin = jit.TracedLayer.trace(twin, [x])[1]
    with torch.no_grad():
        twin.fc2.bias.sub_(1.0)
    assert torch.equal(traced_twin(torch.from_numpy(x)), want + 1.0)
    traced.save_inference_model(str(tmp_path))
    assert torch.equal(jit.load(str(tmp_path), device="cpu")(x), want)


def test_save_needs_a_layer_and_input_spec(mlp, tmp_path):
    with pytest.raises(ValueError, match="requires input_spec"):
        jit.save(mlp[1], str(tmp_path))
    with pytest.raises(ValueError, match="needs a Layer"):
        jit.save(lambda x: x, str(tmp_path), input_spec=[([2, 8],)])


def test_save_restores_training_mode(mlp, tmp_path):
    net = mlp[1]
    net.train()
    jit.save(net, str(tmp_path), input_spec=[jit.InputSpec([None, 8])])
    assert net.training
    net.eval()


def test_program_moves_to_another_device(bert_exports, monkeypatch):
    """A CPU program is moved whole to the device it is loaded on (here
    the meta device, which the CPU has); without the pass it is refused
    naming its platform."""
    exported = torch.export.load(os.path.join(bert_exports[0],
                                              "module.pt2"))
    assert jit._foreign_devices(exported.module(), torch.device("meta")) \
        == ["cpu"]
    module = jit._on_device(exported, "cpu", torch.device("meta"))
    assert jit._foreign_devices(module, torch.device("meta")) == []
    import torch.export.passes as passes
    monkeypatch.delattr(passes, "move_to_device_pass")
    with pytest.raises(ValueError, match="exported on 'cpu'"):
        jit._on_device(exported, "cpu", torch.device("meta"))


# ---------------------------------------------------------------------------
# the kernels' operators
# ---------------------------------------------------------------------------

def test_layer_norm_operator_is_the_cpu_route():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(3, 5, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=8).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=8).astype(np.float32))
    want = F.layer_norm(x, w, b, 1e-5, 2)
    assert torch.equal(custom_ops.layer_norm(x, w, b, 1e-5, 2), want)
    with torch.no_grad():
        assert torch.equal(kernels.maybe_layer_norm(x, w, b, 1e-5, 2),
                           want)
    # bf16 x with fp32 weights: x's dtype, as the kernel and the fake say
    xb = x.to(torch.bfloat16)
    got = custom_ops.layer_norm(xb, w, b, 1e-5, 2)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, F.layer_norm(xb, w, b, 1e-5, 2).to(xb.dtype))
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode() as mode:
        fake = custom_ops.layer_norm(mode.from_tensor(xb),
                                     mode.from_tensor(w),
                                     mode.from_tensor(b), 1e-5, 2)
    assert fake.dtype == got.dtype and fake.shape == got.shape
    # two normalised dims
    w2 = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))
    b2 = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))
    assert torch.equal(custom_ops.layer_norm(x, w2, b2, 1e-5, 1),
                       F.layer_norm(x, w2, b2, 1e-5, 1))


def test_routers_keep_autograd_where_a_gradient_is_wanted():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    w = torch.ones(8, requires_grad=True)
    b = torch.zeros(8, requires_grad=True)
    assert custom_ops.wants_grad(x, w, b)
    kernels.maybe_layer_norm(x, w, b, 1e-5, 1).sum().backward()
    assert w.grad is not None and b.grad is not None
    with torch.no_grad():
        assert not custom_ops.wants_grad(x, w, b)


@pytest.mark.parametrize("bthd", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_operator_is_the_plain_forward(bthd, causal):
    rng = np.random.default_rng(2)
    shape = (2, 16, 2, 128) if bthd else (2, 2, 16, 128)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for _ in range(3))
    bias = torch.zeros(2, 16)
    bias[1, 12:] = fa.NEG_INF
    want = fa.flash_attention_plain(q, k, v, causal=causal, kv_bias=bias,
                                    bthd=bthd)
    got = custom_ops.flash_attention(q, k, v, bias, causal, None, bthd)
    assert torch.equal(got, want) and got.is_contiguous()
    mask = torch.ones(2, 1, 1, 16, dtype=torch.bool)
    mask[1, ..., 12:] = False
    old = ptt.get_flags(["flash_attention_min_seq"])
    ptt.set_flags({"flash_attention_min_seq": 16})
    try:
        with torch.no_grad():
            routed = kernels.maybe_flash_attention(
                q, k, v, mask=mask, causal=causal,
                layout="bthd" if bthd else "bhtd")
    finally:
        ptt.set_flags(old)
    assert torch.equal(routed, want)


def test_inference_entries_run_the_cast_path_with_plain_kernels(
        monkeypatch):
    """The operators' CUDA bodies (the kernels' wrappers: casts, row
    merging, head-dim padding) with the plain versions in the kernels'
    place: bit for bit the plain versions, and in the dtype of the
    operators' CPU bodies (x's, q's) on the same inputs."""
    monkeypatch.setattr(ln, "layer_norm", functools.partial(
        ln.layer_norm, forward=ln.layer_norm_plain))
    monkeypatch.setattr(fa, "flash_attention", functools.partial(
        fa.flash_attention, kernels=fa.PLAIN_KERNELS))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(3, 2, 40)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=40).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=40).astype(np.float32))
    for xdt, wdt in ((torch.float32,) * 2, (torch.bfloat16,) * 2,
                     (torch.bfloat16, torch.float32)):
        args = (x.to(xdt), w.to(wdt), b.to(wdt), 1e-5, 2)
        got = custom_ops._layer_norm_cuda(*args)
        assert torch.equal(got, ln.layer_norm_plain(*args[:4]))
        cpu = custom_ops.layer_norm(*args)
        assert got.dtype == cpu.dtype == xdt
        # the CPU body computes in x's dtype, the kernel in fp32: a few
        # bf16 roundings (2^-8 each) apart
        scale = float(cpu.float().abs().max())
        torch.testing.assert_close(got.float(), cpu.float(), rtol=0,
                                   atol=2.0 ** -6 * scale)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 24, 2, 40)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    bias = torch.zeros(1, 24)
    bias[0, 20:] = fa.NEG_INF
    got = custom_ops._flash_cuda(q, k, v, bias, True, None, True)
    want = custom_ops.flash_attention(q, k, v, bias, True, None, True)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.is_contiguous() and torch.equal(got, want)


def test_kernels_count_no_launch_on_the_cpu_route():
    kernels.reset_launch_counts()
    with torch.no_grad():
        kernels.maybe_layer_norm(torch.ones(2, 4), torch.ones(4),
                                 torch.zeros(4), 1e-5, 1)
    assert not any(kernels.launch_counts().values())
