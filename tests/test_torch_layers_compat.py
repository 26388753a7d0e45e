"""PyTorch port: the fluid ``layers`` shim against the JAX package's on
the CPU.

Every name of the reference's aggregated ``fluid.layers.__all__`` (the
list ``tests/test_layers_compat.py`` sweeps) resolves in the port, the
two graph-recording names raise naming the working equivalent, and the
names the shim defines give the JAX shim's values on the same seeded
numpy inputs: elementwise (fluid's axis), reductions (``dim``/
``keep_dim``), the resizes, the lr decays step by step, ``fc``, the
fluid-signature wrappers (``argmax`` ... ``pad``), ``auc``, the
selected-rows helpers, the ``rnn`` driver and ``multi_box_head``; floats
within ``TOL`` of the reference's largest entry, integers exactly.
``Print``/``Assert`` keep the port's policy for a host read in a static
body: the signature runs eagerly with the reason recorded.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as pt  # noqa: E402
import paddle_tpu.layers as JL  # noqa: E402
from test_layers_compat import _reference_layers_all  # noqa: E402
from test_torch_compiled_step import EagerGraphs  # noqa: E402

import paddle_tpu_torch as ptt  # noqa: E402
import paddle_tpu_torch.layers as L  # noqa: E402
from paddle_tpu_torch import jit as pjit  # noqa: E402
from paddle_tpu_torch.convert import load_jax_params  # noqa: E402

TOL = 1e-5
RNG = np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _on_cpu():
    from paddle_tpu_torch.core import place
    saved = place._current_place
    place.set_device("cpu")
    try:
        yield
    finally:
        place._current_place = saved


def _close(got, want, what="", tol=TOL):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}[{i}]", tol)
        return
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if not np.issubdtype(w.dtype, np.floating):
        np.testing.assert_array_equal(g, w, err_msg=what)
        return
    scale = max(float(np.max(np.abs(w), initial=0.0)), 1e-30)
    assert float(np.max(np.abs(g - w), initial=0.0)) / scale <= tol, what


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_every_reference_layers_name_resolves():
    names = _reference_layers_all()
    assert len(names) >= 300
    missing, redirected = [], []
    for name in names:
        try:
            obj = getattr(L, name)
        except NotImplementedError:
            redirected.append(name)
        except AttributeError:
            missing.append(name)
        else:
            if obj is None:
                missing.append(name)
    assert not missing, missing
    assert set(redirected) == {"DynamicRNN", "StaticRNN"}
    with pytest.raises(NotImplementedError, match="static_rnn"):
        L.StaticRNN
    with pytest.raises(NotImplementedError, match="nn.RNN"):
        L.DynamicRNN
    with pytest.raises(AttributeError):
        L.definitely_not_an_op


X3 = RNG.normal(size=(2, 3, 4)).astype(np.float32)
Y3 = RNG.normal(size=(3,)).astype(np.float32)
POS = (np.abs(X3) + 0.5).astype(np.float32)

CASES = [
    ("elementwise_add", (X3, Y3), {"axis": 1}),
    ("elementwise_mul", (X3, Y3), {"axis": 1, "act": "relu"}),
    ("elementwise_sub", (X3, X3[0]), {}),
    ("elementwise_div", (X3, POS), {}),
    ("elementwise_max", (X3, X3[::-1].copy()), {}),
    ("elementwise_min", (X3, X3[::-1].copy()), {}),
    ("elementwise_pow", (POS, X3), {}),
    ("elementwise_mod", (POS * 7, POS), {}),
    ("elementwise_floordiv", (POS * 7, POS), {}),
    ("reduce_sum", (X3,), {"dim": 1, "keep_dim": True}),
    ("reduce_sum", (X3,), {}),
    ("reduce_mean", (X3,), {"dim": [0, 2]}),
    ("reduce_max", (X3,), {"dim": -1}),
    ("reduce_min", (X3,), {"keep_dim": True}),
    ("reduce_prod", (POS,), {"dim": [0, 2]}),
    ("reduce_all", (X3 > 0,), {"dim": 1}),
    ("reduce_any", (X3 > 0,), {"dim": [1, 2], "keep_dim": True}),
    ("argmax", (X3,), {}),
    ("argmin", (X3,), {"axis": 2}),
    ("expand", (X3[:1],), {"expand_times": [2, 1, 3]}),
    ("flatten", (X3,), {"axis": 2}),
    ("flatten", (X3,), {"axis": 0}),
    ("split", (X3, 2), {}),
    ("pad", (X3,), {"paddings": [0, 1, 2, 0, 1, 1], "pad_value": 7.0}),
    ("sum", ([X3, X3, POS],), {}),
    ("cross_entropy", (np.abs(X3[0]) / np.abs(X3[0]).sum(-1, keepdims=True),
                       np.array([[0], [3], [1]])), {}),
    ("cross_entropy", (np.abs(X3[0]) / np.abs(X3[0]).sum(-1, keepdims=True),
                       np.array([[0], [-100], [1]])), {"ignore_index": -100}),
    ("cross_entropy", (np.abs(X3[0]) + 0.1, np.abs(X3[1]) + 0.1),
     {"soft_label": True}),
    ("dropout", (X3, 0.25), {"is_test": True}),
    ("image_resize", (RNG.normal(size=(1, 2, 5, 6)).astype(np.float32),),
     {"out_shape": (9, 4)}),
    ("resize_nearest", (RNG.normal(size=(1, 2, 5, 6)).astype(np.float32),),
     {"out_shape": (10, 12)}),
    ("resize_bilinear", (RNG.normal(size=(1, 2, 4, 4)).astype(np.float32),),
     {"scale": 2.0}),
    ("image_resize_short",
     (RNG.normal(size=(1, 3, 20, 40)).astype(np.float32), 10), {}),
    ("adaptive_pool2d", (RNG.normal(size=(1, 2, 6, 6)).astype(np.float32),
                         3), {"pool_type": "max"}),
    ("adaptive_pool2d", (RNG.normal(size=(1, 2, 6, 6)).astype(np.float32),
                         2), {}),
    ("fc", (X3,), {"size": 5, "num_flatten_dims": 2,
                   "weight": RNG.normal(size=(4, 5)).astype(np.float32),
                   "bias": RNG.normal(size=(5,)).astype(np.float32),
                   "act": "tanh"}),
    ("embedding", (np.array([[1, 3], [0, 2]]), [4, 3]),
     {"weight": RNG.normal(size=(4, 3)).astype(np.float32)}),
    ("auc", (np.stack([1 - np.linspace(0.05, 0.95, 16),
                       np.linspace(0.05, 0.95, 16)], 1).astype(np.float32),
             (np.arange(16) % 3 == 0).astype(np.int64)),
     {"num_thresholds": 64}),
]


def _arg(a):
    if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
        return [_t(v) for v in a]
    return _t(a) if isinstance(a, np.ndarray) else a


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_shim_function_matches_jax(i):
    name, args, kw = CASES[i]
    want = getattr(JL, name)(*args, **kw)
    pkw = {k: _arg(v) for k, v in kw.items()}
    got = getattr(L, name)(*[_arg(a) for a in args], **pkw)
    _close(got, jax.tree.map(np.asarray, want), name)


def test_unique_first_occurrence_order():
    xs = np.asarray([2, 3, 3, 1, 5, 3], np.int32)
    out, index = L.unique(_t(xs))
    j_out, j_index = JL.unique(xs)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(index.numpy(), np.asarray(j_index))
    assert index.dtype == torch.int32


def test_expand_and_pad_validate_like_jax():
    with pytest.raises(ValueError, match="one per dim"):
        L.expand(torch.ones(2, 3), [4, 2, 3])
    with pytest.raises(ValueError, match="multiple"):
        L.expand_as(torch.ones(1, 3), torch.zeros(2, 5))
    assert L.expand_as(torch.ones(1, 3), torch.zeros(2, 6)).shape == (2, 6)
    with pytest.raises(ValueError, match="padding entries"):
        L.pad(torch.zeros(2, 2), [1, 1])
    with pytest.raises(ValueError, match="dropout_implementation"):
        L.dropout(torch.ones(2), 0.5, dropout_implementation="bogus")
    with pytest.raises(ValueError, match="nn.Embedding"):
        L.embedding(torch.tensor([0]), [4, 3])
    with pytest.raises(ValueError, match="nn.Linear"):
        L.fc(torch.ones(2, 3), 4)
    tr = L.dropout(torch.ones(4, 4), 0.5, seed=3)  # train: mask, no upscale
    assert set(torch.unique(tr).tolist()) <= {0.0, 1.0}
    assert torch.equal(tr, L.dropout(torch.ones(4, 4), 0.5, seed=3))


LR = [("noam_decay", (64, 4), {}),
      ("exponential_decay", (0.1, 3, 0.5), {}),
      ("exponential_decay", (0.1, 3, 0.5), {"staircase": True}),
      ("natural_exp_decay", (0.1, 2, 0.3), {"staircase": True}),
      ("inverse_time_decay", (0.1, 2, 0.3), {}),
      ("polynomial_decay", (0.1, 8), {"power": 2.0}),
      ("piecewise_decay", ([3, 6], [0.1, 0.05, 0.01]), {}),
      ("cosine_decay", (0.1, 3, 3), {}),
      ("linear_lr_warmup", (0.1, 4, 0.0, 0.1), {})]


@pytest.mark.parametrize("i", range(len(LR)), ids=[c[0] for c in LR])
def test_lr_decays_match_jax(i):
    """Each schedule at steps 0..11 from the device step counter (an
    int32 tensor, as the optimizer's), against the JAX one traced."""
    name, args, kw = LR[i]
    js, ps = getattr(JL, name)(*args, **kw), getattr(L, name)(*args, **kw)
    want = jax.jit(jax.vmap(js.lr_at))(jnp.arange(12, dtype=jnp.int32))
    got = torch.stack([ps.lr_at(torch.tensor(s, dtype=torch.int32))
                       for s in range(12)])
    _close(got.to(torch.float32), np.asarray(want, np.float32), name, 1e-6)


def test_decay_feeds_a_port_optimizer():
    from paddle_tpu_torch.optimizer import SGD
    opt = SGD(learning_rate=L.cosine_decay(0.1, 10, 2))
    params = {"w": torch.ones(3)}
    state = opt.init(params)
    opt.apply_gradients(params, {"w": torch.ones(3)}, state)  # in place
    assert not torch.allclose(params["w"], torch.ones(3))


def test_constructors_and_counters():
    p = L.create_parameter([4, 3], "float32", name="w0")
    assert isinstance(p, torch.nn.Parameter) and p.shape == (4, 3)
    assert p.param_name == "w0" and p.device.type == "cpu"
    b = L.create_parameter([3], "float32", is_bias=True)
    assert float(b.detach().abs().sum()) == 0.0
    g = L.create_global_var([2, 2], 7.0, "float32")
    assert float(g[0, 0]) == 7.0
    assert L.create_tensor("float32").shape == ()
    f = L.fill_constant([2], "int32", 3, force_cpu=True)
    assert f.dtype == torch.int32 and f.tolist() == [3, 3]
    ctr = L.autoincreased_step_counter(begin=5, step=2)
    assert (ctr(), ctr(), ctr()) == (5, 7, 9)
    assert int(L.size(torch.ones(2, 3))) == 6


def test_py_reader_epoch_protocol():
    r = L.py_reader(capacity=4, shapes=[[2]], dtypes=["float32"])
    with pytest.raises(ValueError, match="decorate"):
        r.start()
    r.decorate_paddle_reader(lambda: iter([1, 2, 3]))
    with pytest.raises(ValueError, match="start"):
        iter(r)
    r.start()
    assert list(r) == [1, 2, 3]
    r.reset()
    r.start()
    assert list(L.double_buffer(r)) == [1, 2, 3]
    r.start()
    assert L.read_file(r) == 1


def test_selected_rows_helpers():
    from paddle_tpu_torch.ops.sparse import RowSlices
    s = RowSlices(torch.tensor([1, 1, 3]),
                  torch.tensor([[1.0], [2.0], [5.0]]), dense_rows=5)
    dense = L.get_tensor_from_selected_rows(L.merge_selected_rows(s))
    assert dense.shape == (5, 1)
    assert dense[:, 0].tolist() == [0.0, 3.0, 0.0, 5.0, 0.0]


def test_multi_box_head_matches_jax():
    f1 = RNG.normal(0, 1, (2, 4, 8, 8)).astype(np.float32)
    f2 = RNG.normal(0, 1, (2, 4, 4, 4)).astype(np.float32)
    loc_w = [RNG.normal(0, 0.1, (16, 4, 3, 3)).astype(np.float32)
             for _ in range(2)]
    conf_w = [RNG.normal(0, 0.1, (12, 4, 3, 3)).astype(np.float32)
              for _ in range(2)]
    args = ((64, 64), 3, [16.0, 32.0], [32.0, 48.0], [[2.0], [2.0]])
    want = JL.multi_box_head([f1, f2], *args, loc_w, conf_w)
    got = L.multi_box_head([_t(f1), _t(f2)], *args,
                           [_t(w) for w in loc_w], [_t(w) for w in conf_w])
    _close(got, [np.asarray(w) for w in want], "multi_box_head")
    with pytest.raises(ValueError, match="output channels"):
        L.multi_box_head([_t(f1)], (64, 64), 3, [16.0], [32.0], [[2.0]],
                         [_t(loc_w[0][:8])], [_t(conf_w[0])])


def test_rnn_driver_matches_jax():
    import paddle_tpu.nn as jnn
    from paddle_tpu_torch import nn as pnn
    pt.seed(0)
    jcell = jnn.GRUCell(4, 5)
    pcell = pnn.GRUCell(4, 5, device="cpu")
    load_jax_params(pcell, {k: np.asarray(v)
                            for k, v in jcell.param_dict().items()})
    x = RNG.normal(0, 0.5, (2, 6, 4)).astype(np.float32)
    lens = np.array([6, 3])
    for kw in ({}, {"is_reverse": True}):
        jo, jf = JL.rnn(jcell, x, sequence_length=lens, **kw)
        po, pf = L.rnn(pcell, _t(x), sequence_length=_t(lens), **kw)
        _close(po, np.asarray(jo), f"rnn {kw}")
        _close(pf, np.asarray(jf), f"rnn final {kw}")


def test_load_into_parameter(tmp_path):
    w = RNG.normal(0, 1, (3, 3)).astype(np.float32)
    path = str(tmp_path / "w_ckpt")
    ptt.io.save({"w": _t(w)}, path)
    p = torch.nn.Parameter(torch.zeros(3, 3))
    assert L.load(p, path) is p
    np.testing.assert_array_equal(p.detach().numpy(), w)
    half = L.load(file_path=path, load_as_fp16=True)
    assert half.dtype == torch.float16
    with pytest.raises(TypeError, match="Parameter"):
        L.load([1], path)


def test_sampling_id_draws_rows():
    probs = torch.tensor([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]])
    got = L.sampling_id(probs, key=7)
    assert got.tolist() == [1, 0]
    x = torch.softmax(torch.randn(64, 5), -1)
    assert torch.equal(L.sampling_id(x, key=3), L.sampling_id(x, key=3))


def test_assert_and_print_eager(capsys):
    L.Assert(True)
    L.Assert(torch.tensor(True))
    with pytest.raises(AssertionError, match="msg"):
        L.Assert(False, data="msg")
    with pytest.raises(AssertionError):
        L.Assert(torch.tensor(False))
    out = L.Print(torch.arange(3), message="dbg")
    assert out.tolist() == [0, 1, 2]
    assert "dbg" in capsys.readouterr().out


def test_print_in_a_static_body_runs_the_signature_eagerly(capsys):
    """A host read in a to_static body keeps that signature eager, its
    reason recorded (the port's policy for a tensor while, note_eager)."""
    def body(x):
        y = x * 2
        L.Print(y, message="in body")
        L.Assert(y.sum() > -1e9)
        return y + 1

    sf = pjit.to_static(body)
    sf.compiled, sf._backend = True, EagerGraphs()  # the capture route
    x = torch.arange(4.0)
    with pytest.warns(RuntimeWarning, match="layers.Print"):
        out = sf(x)
    assert out.tolist() == [1.0, 3.0, 5.0, 7.0]
    assert sf.eager_signatures == 1 and "layers.Print" in sf.reason
    assert not sf.captured
    assert "in body" in capsys.readouterr().out
    # inside a capture the read raises instead
    from paddle_tpu_torch.dy2static import convert_ops
    with convert_ops.static_scope(convert_ops.StaticFrame(capturing=True)):
        with pytest.raises(RuntimeError, match="CUDA graph capture"):
            L.Print(x)


def test_control_flow_aliases():
    assert L.While is L.while_loop is ptt.ops.control_flow.while_loop
    assert L.IfElse is L.cond
    assert L.Switch is L.switch_case
    got = L.cond(torch.tensor(True), lambda: torch.tensor(1.0),
                 lambda: torch.tensor(2.0))
    assert float(got) == 1.0
