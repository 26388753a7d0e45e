"""PyTorch port: ``dy2static`` and ``jit.to_static`` against the JAX
package.

Every converted function of ``tests/test_dy2static.py`` goes through
both packages' converters: the JAX one eagerly and under ``jax.jit``,
the port's eagerly and in a static scope (a tensor ``if`` as a select, a
tensor loop eager), and all four agree within ``TOL``. The functions use
only arithmetic and methods both array types have, so one definition
serves both. Then the port's own rules: the undefined-carry and
mismatch errors, the refusal of a branch that draws or writes in place,
the eager signature of a tensor loop with its counter and reason, the
captured path through a stand-in for the CUDA graph backend (as
``test_torch_compiled_step.py`` runs it), nesting, the export of a
converted layer, and ``not_to_static``/``rollback``.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import contextlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as pt  # noqa: E402
from paddle_tpu.dy2static import convert_control_flow as j_convert  # noqa
from paddle_tpu.jit import to_static as j_to_static  # noqa: E402

from paddle_tpu_torch import jit, kernels  # noqa: E402
from paddle_tpu_torch.convert import load_jax_params  # noqa: E402
from paddle_tpu_torch.dy2static import BranchEffectError  # noqa: E402
from paddle_tpu_torch.dy2static import convert_control_flow  # noqa: E402
from paddle_tpu_torch.dy2static import static_scope  # noqa: E402
from paddle_tpu_torch.jit import to_static  # noqa: E402
from paddle_tpu_torch.nn import Linear  # noqa: E402
from paddle_tpu_torch.static import Executor, Program, Scope  # noqa: E402

TOL = 1e-6


class _Replayer:
    def __init__(self, body) -> None:
        self.body = body

    def replay(self) -> None:
        self.body()


class EagerGraphs:
    """Stands in for the CUDA graph backend on the CPU: the warm-up runs
    the call, the capture keeps the body without running it, a replay
    runs it on the graph's static inputs."""

    def __init__(self) -> None:
        self.graphs = []

    def warm_up(self, fn):
        return fn()

    def capture(self, fn, generator=None, table_rows=0):
        self.graphs.append(_Replayer(fn))
        return self.graphs[-1], []

    def host_sync_check(self, what):
        return contextlib.nullcontext()


def _captured(sf):
    sf.compiled = True
    sf._backend = EagerGraphs()
    return sf


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().numpy()
    return np.asarray(v)


def _four(fn, *args):
    """The function through both converters, eager and static; returns
    the port's static result after holding all four together."""
    jconv, jnote = j_convert(fn)
    conv, note = convert_control_flow(fn)
    assert jnote is None and note is None, (jnote, note)
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
             for a in args]
    targs = [torch.from_numpy(a.copy()) if isinstance(a, np.ndarray)
             else a for a in args]
    want = _np(jconv(*jargs))
    for got in (jax.jit(jconv)(*jargs), conv(*targs)):
        np.testing.assert_allclose(_np(got), want, rtol=TOL, atol=TOL)
    with static_scope() as frame:
        got = conv(*targs)
    np.testing.assert_allclose(_np(got), want, rtol=TOL, atol=TOL)
    return got, frame


def _a(*v):
    return np.asarray(v, np.float32)


# the functions of tests/test_dy2static.py, written once for both arrays

def if_on_tensor_value(x):
    if x.sum() > 0:
        y = x * 2.0
    else:
        y = x - 1.0
    return y


def if_with_early_return(x):
    if x.sum() > 0:
        return x * 10.0
    return x * -1.0


def nested_if(x):
    if x.sum() > 0:
        if x.sum() > 10:
            r = x * 100.0
        else:
            r = x * 10.0
    else:
        r = x
    return r


def while_on_tensor(x):
    s = x * 0.0
    while s.sum() < 10.0:
        s = s + x
    return s


def bool_ops_on_tensors(x):
    if (x.sum() > 0) and (x.max() < 100.0):
        return x + 1.0
    return x - 1.0


def or_on_tensors(x):
    if (x.sum() > 100) or (x.max() < 0.0):
        return x + 1.0
    return x - 1.0


def not_on_tensor(x):
    if not (x.sum() > 0):
        return -x
    return x


def mixed_partial_returns(x):
    if x.sum() > 0:
        if x.max() > 5:
            return x
    return -x


def while_accumulator_multiple_carries(x):
    i = x.sum() * 0
    total = x * 0.0
    while i < 5:
        total = total + x
        i = i + 1
    return total


SCALE = 7.0


def closure_and_globals(x):
    if x.sum() > 0:
        return x * SCALE
    return x


def relu_cap(x):
    if x.sum() > 10.0:
        return x * 0.0 + 10.0
    return (x + abs(x)) * 0.5


@pytest.mark.parametrize("fn,inputs,loops", [
    (if_on_tensor_value, [_a(1.0, 2.0), _a(-1.0, -2.0)], False),
    (if_with_early_return, [_a(3.0), _a(-3.0)], False),
    (nested_if, [_a(20.0), _a(2.0), _a(-2.0)], False),
    (while_on_tensor, [_a(3.0)], True),
    (bool_ops_on_tensors, [_a(5.0), _a(500.0), _a(-5.0)], False),
    (or_on_tensors, [_a(500.0), _a(-5.0), _a(5.0)], False),
    (not_on_tensor, [_a(-2.0), _a(2.0)], False),
    (mixed_partial_returns, [_a(9.0), _a(2.0), _a(-1.0)], False),
    (while_accumulator_multiple_carries, [_a(2.0)], True),
    (closure_and_globals, [_a(2.0), _a(-2.0)], False),
    (relu_cap, [_a(20.0), _a(-3.0), _a(3.0)], False)])
def test_converted_function_matches_jax(fn, inputs, loops):
    for x in inputs:
        _, frame = _four(fn, x)
        assert bool(frame.eager_reasons) is loops, frame.eager_reasons


def for_range_traced_bound(x, n):
    acc = x * 0.0
    for i in range(n):
        acc = acc + x * (i + 1)
    return acc


def test_for_range_over_a_tensor_bound():
    jconv, _ = j_convert(for_range_traced_bound)
    want = jax.jit(jconv)(jnp.asarray([1.0]), jnp.asarray(4))
    conv, note = convert_control_flow(for_range_traced_bound)
    assert note is None
    with static_scope() as frame:
        got = conv(torch.tensor([1.0]), torch.tensor(4))
    np.testing.assert_allclose(_np(got), _np(want))
    assert "`for` over a tensor range" in frame.eager_reasons[0]
    # Python ints stay a Python loop, with no note
    with static_scope() as frame:
        got = conv(torch.tensor([1.0]), 4)
    np.testing.assert_allclose(_np(got), [10.0])
    assert frame.eager_reasons == []


def plain_python_control_flow(x, flag):
    if flag:
        for i in range(3):
            x = x + 1.0
    return x


def while_with_break(x):
    s = 0.0
    k = 0
    while k < 10:
        if k >= 3:
            break
        s = s + float(x)
        k += 1
    return s


def test_python_values_keep_python_control_flow():
    for conv_fn in (j_convert, convert_control_flow):
        conv, note = conv_fn(plain_python_control_flow)
        assert note is None
        np.testing.assert_allclose(_np(conv(np.zeros(1), True)), [3.0])
        np.testing.assert_allclose(_np(conv(np.zeros(1), False)), [0.0])
        conv, _ = conv_fn(while_with_break)
        assert conv(2.0) == 6.0
    with static_scope():
        assert convert_control_flow(while_with_break)[0](2.0) == 6.0


def test_closure_cells_stay_live():
    scale = 2.0

    def bump():
        nonlocal scale
        scale = 100.0

    def f(x):
        if x.sum() > 0:
            return x * scale
        return x

    conv, note = convert_control_flow(f)
    assert note is None
    with static_scope():
        np.testing.assert_allclose(_np(conv(torch.tensor([1.0]))), [2.0])
        bump()
        np.testing.assert_allclose(_np(conv(torch.tensor([1.0]))), [100.0])


def test_side_effecting_condition_is_evaluated_once_per_turn():
    def f(it):
        n = 0
        while next(it, -1) >= 0:
            n += 1
        return n

    conv, _ = convert_control_flow(f)
    assert conv(iter([0, 1, 2])) == 3
    with static_scope():
        assert conv(iter([0, 1, 2])) == 3


def undefined_carry(x):
    if x.sum() > 0:
        y = x * 2.0
    return y


def shape_mismatch(x):
    if x.sum() > 0:
        y = x * 2.0
    else:
        y = x[:1]
    return y


def draws_in_branch(x):
    if x.sum() > 0:
        x = x + torch.rand(x.shape)
    return x


def writes_in_branch(x, buf):
    if x.sum() > 0:
        buf.add_(1.0)
    return x


def test_errors_of_a_tensor_if():
    jconv, _ = j_convert(undefined_carry)
    with pytest.raises((ValueError, NameError)):
        jax.jit(jconv)(jnp.asarray([1.0]))
    conv, _ = convert_control_flow(undefined_carry)
    with static_scope(), pytest.raises(ValueError,
                                       match="assign it on both paths"):
        conv(torch.tensor([1.0]))
    jconv, _ = j_convert(shape_mismatch)
    with pytest.raises(ValueError, match="assign it on both paths"):
        jax.jit(jconv)(jnp.asarray([1.0, 2.0]))
    conv, _ = convert_control_flow(shape_mismatch)
    with static_scope(), pytest.raises(ValueError,
                                       match="assign it on both paths"):
        conv(torch.tensor([1.0, 2.0]))


def test_a_branch_that_would_act_twice_is_refused_by_name():
    """Both branches of a tensor ``if`` run: a random draw or an in-place
    write there is refused, naming the op; outside a static scope (one
    branch runs) the same code runs."""
    conv, _ = convert_control_flow(draws_in_branch)
    with static_scope(), pytest.raises(BranchEffectError, match="`rand`"):
        conv(torch.tensor([1.0]))
    assert conv(torch.tensor([1.0])).shape == (1,)
    conv, _ = convert_control_flow(writes_in_branch)
    buf = torch.zeros(1)
    with static_scope(), pytest.raises(BranchEffectError,
                                       match="`add_` writes in place"):
        conv(torch.tensor([1.0]), buf)
    assert float(buf) == 0.0
    conv(torch.tensor([1.0]), buf)
    assert float(buf) == 1.0


def test_to_static_decorator_end_to_end():
    jf = j_to_static(relu_cap)
    tf = to_static(relu_cap)
    assert tf.conversion_note is None
    for v in (20.0, -3.0, 3.0):
        np.testing.assert_allclose(_np(tf(torch.tensor([v]))),
                                   _np(jf(jnp.asarray([v]))))
    assert tf.captured is False and "eagerly on cpu" in tf.reason


def test_captured_path_replays_the_converted_body():
    sf = _captured(to_static(if_with_early_return))
    kernels.reset_launch_counts()
    outs = [sf(torch.tensor([v])) for v in (3.0, -3.0, 5.0)]
    assert [float(o) for o in outs] == [30.0, 3.0, 50.0]
    assert sf.captures == 1 and sf.captured and sf.reason is None
    assert len(sf._backend.graphs) == 1
    sf(torch.tensor([1.0, 2.0]))  # a new shape: a new signature
    assert sf.captures == 2 and sf.eager_signatures == 0


def test_tensor_while_signature_runs_eagerly_with_counter_and_reason():
    sf = _captured(to_static(while_on_tensor))
    with pytest.warns(RuntimeWarning, match="runs eagerly"):
        out = sf(torch.tensor([3.0]))
    assert float(out) == 12.0
    assert sf.captured is False and sf.captures == 0
    assert sf.eager_signatures == 1
    assert "tensor `while`" in sf.reason and "line" in sf.reason
    assert float(sf(torch.tensor([4.0]))) == 12.0  # eager again, no warning
    assert sf.eager_signatures == 1 and sf.captures == 0


def test_outputs_that_need_grad_are_not_captured():
    lin = Linear(3, 3, device="cpu")
    sf = _captured(to_static(lin))
    x = torch.ones(2, 3)
    with pytest.warns(RuntimeWarning, match="require grad"):
        out = sf(x)
    assert out.requires_grad and not sf.captured
    with torch.no_grad():
        sf(x)
        y = sf(x)
    assert sf.captured and sf.captures == 1
    assert torch.equal(y, lin(x).detach())


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = Linear(4, 4, device="cpu")

    def forward(self, x):
        h = self.fc(x)
        if h.sum() > 0:
            return h * 2.0
        return h


def test_to_static_layer_matches_jax_and_rolls_back():
    class JNet(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = pt.nn.Linear(4, 4)

        def forward(self, x):
            h = self.fc(x)
            if h.sum() > 0:
                return h * 2.0
            return h

    pt.seed(0)
    jnet = JNet()
    net = Net()
    load_jax_params(net, {k: np.asarray(v)
                          for k, v in jnet.param_dict().items()})
    jsf = j_to_static(jnet)
    orig = net.forward
    sf = _captured(to_static(net))
    assert net.forward is not orig and sf.layer is net
    x = np.random.default_rng(0).normal(size=(2, 4)).astype(np.float32)
    for sign in (1.0, -1.0):
        with torch.no_grad():
            got = sf(torch.from_numpy(x * sign))
        np.testing.assert_allclose(_np(got), _np(jsf(jnp.asarray(x * sign))),
                                   rtol=1e-5, atol=1e-6)
    assert sf.captures == 1
    sf.rollback()
    assert "forward" not in net.__dict__


def test_not_to_static_keeps_the_function():
    def f(x):
        if x.sum() > 0:
            return x
        return -x

    jit.not_to_static(f)
    sf = to_static(f)
    assert sf._converted is f


def test_nested_static_function_runs_inline():
    inner = _captured(to_static(if_on_tensor_value))

    def outer(x):
        return inner(x) + 1.0

    sf = _captured(to_static(outer))
    assert float(sf(torch.tensor([1.0]))) == 3.0
    assert float(sf(torch.tensor([-1.0]))) == -1.0
    assert sf.captures == 1 and inner.captures == 0
    # inside a Program too, whose capture holds it
    scope = Scope()
    scope.set_var("w", torch.ones(1))

    def fn(state, feeds):
        return {"w": state["w"]}, {"y": inner(feeds["x"] * state["w"])}

    prog = Program(fn, state_names=["w"], compiled=True)
    prog._backend = EagerGraphs()
    exe = Executor("cpu")
    for v, want in ((2.0, 4.0), (-2.0, -3.0)):
        assert float(exe.run(prog, {"x": np.asarray([v], np.float32)},
                             ["y"], scope=scope)[0][0]) == want
    assert prog.captures == 1 and inner.captures == 0


def test_jit_save_of_a_converted_layer(tmp_path):
    pt_net = Net()
    sf = to_static(pt_net)
    path = str(tmp_path / "net")
    jit.save(sf, path, input_spec=[jit.InputSpec([None, 4], "float32")])
    loaded = jit.load(path, device="cpu")
    x = torch.randn(3, 4)
    for v in (x, -x * 10):
        with torch.no_grad():
            np.testing.assert_allclose(_np(loaded(v)), _np(pt_net(v)),
                                       rtol=1e-6, atol=1e-6)
    prog = to_static(if_with_early_return,
                     input_spec=[jit.InputSpec([None], "float32")])
    ep = prog.concrete_program
    assert isinstance(ep, torch.export.ExportedProgram)
    assert "where" in str(ep.graph)


def test_jit_save_refuses_a_tensor_while_by_its_line(tmp_path):
    class Loop(torch.nn.Module):
        def forward(self, x):
            s = x * 0.0
            while s.sum() < 10.0:
                s = s + x
            return s

    with pytest.raises(ValueError, match="tensor `while` at .* line"):
        jit.save(to_static(Loop()), str(tmp_path / "loop"),
                 input_spec=[jit.InputSpec([2], "float32")])
    with pytest.raises(ValueError, match="tensor `while`"):
        to_static(while_on_tensor, input_spec=[
            jit.InputSpec([1], "float32")]).concrete_program
