"""PyTorch port: the ``fluid`` migration namespace against the JAX
package's on the CPU (the port of ``tests/test_fluid_namespace.py`` and
the LoD re-exports of ``tests/test_lod.py``).

- Every public name of ``paddle_tpu.fluid`` and of its 18 submodules
  resolves in the port (but the TPU-only ``TPUPlace``), and the
  submodules import as modules.
- ``scope_guard`` isolates an ``Executor``'s scope, ``DataFeeder``
  batches samples as the JAX one, the graph-construction names raise
  naming the working route, ``core.globals()`` views the flags.
- ``io.save_persistables``/``load_persistables`` (and the ``*_params``
  spellings) round-trip a scope chain bit for bit, and read a JAX
  package's save of the same scope.
- A fluid-style train loop (``fluid.layers`` math, ``fluid.optimizer``)
  takes the JAX loop's losses within ``TOL``.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import importlib
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu.fluid as jfluid  # noqa: E402

import paddle_tpu_torch.fluid as fluid  # noqa: E402
from paddle_tpu_torch.static import Scope  # noqa: E402

TOL = 1e-5
TPU_ONLY = {"TPUPlace", "is_compiled_with_tpu"}
SUBMODULES = ("average", "backward", "contrib", "core", "dygraph",
              "executor", "framework", "transpiler", "unique_name",
              "incubate", "incubate.data_generator", "incubate.fleet",
              "incubate.fleet.base", "incubate.fleet.base.role_maker",
              "incubate.fleet.collective", "incubate.fleet.parameter_server",
              "incubate.fleet.parameter_server.distribute_transpiler")


def _public(mod) -> set:
    import inspect
    import types
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


@pytest.mark.parametrize("sub", ("",) + SUBMODULES)
def test_fluid_names_match_jax(sub):
    suffix = "." + sub if sub else ""
    jmod = importlib.import_module("paddle_tpu.fluid" + suffix)
    pmod = importlib.import_module("paddle_tpu_torch.fluid" + suffix)
    missing = sorted(n for n in _public(jmod) - TPU_ONLY
                     if not hasattr(pmod, n))
    assert not missing, (sub, missing)


def test_top_level_surface():
    assert fluid.executor.Executor is fluid.Executor
    assert fluid.metrics.Accuracy is not None
    assert callable(fluid.backward.gradients)
    assert fluid.is_compiled_with_cuda() == \
        fluid.framework.is_compiled_with_cuda() == torch.cuda.is_available()
    assert fluid.CUDAPinnedPlace is fluid.CPUPlace
    assert fluid.framework.Variable is fluid.Tensor
    assert fluid.framework.in_dygraph_mode() and fluid.dygraph.enabled()
    assert fluid.dygraph.BatchNorm is fluid.dygraph.BatchNorm2D
    assert fluid.contrib.slim is not None
    assert fluid.contrib.mixed_precision is not None
    assert fluid.incubate.fleet.collective.fleet is \
        fluid.incubate.fleet.parameter_server.distribute_transpiler.fleet
    assert fluid.embedding is fluid.layers.embedding


def test_graph_construction_redirects_are_loud():
    with pytest.raises(NotImplementedError, match="Program"):
        fluid.default_main_program()
    with pytest.raises(NotImplementedError, match="seed"):
        fluid.default_startup_program()
    with pytest.raises(NotImplementedError, match="static.Program"):
        with fluid.program_guard(None):
            pass
    with pytest.raises(NotImplementedError, match="TrainStep"):
        fluid.backward.append_backward(None)
    with pytest.raises(NotImplementedError, match="ShardedTrainStep"):
        fluid.DistributeTranspiler().transpile(None)
    with pytest.raises(NotImplementedError, match="max_memory_allocated"):
        fluid.contrib.memory_usage()


def test_core_globals_flag_view():
    g = fluid.core.globals()
    assert "FLAGS_check_nan_inf" in g and "check_nan_inf" in g.keys()
    assert "FLAGS_not_a_flag" not in g
    old = g["FLAGS_check_nan_inf"]
    try:
        g["FLAGS_check_nan_inf"] = True
        assert g["check_nan_inf"] is True
    finally:
        g["FLAGS_check_nan_inf"] = old
    assert set(g.keys()) == set(jfluid.core.globals().keys())


def test_data_feeder_matches_jax():
    rows = [(np.arange(3, dtype=np.float32) + i, i % 2) for i in range(4)]
    got = fluid.DataFeeder(["img", "label"]).feed(rows)
    want = jfluid.DataFeeder(["img", "label"]).feed(rows)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="feed names"):
        fluid.DataFeeder(["img", "label"]).feed([(np.zeros(3),)])
    with pytest.raises(ValueError, match="pad to a fixed seq_len"):
        fluid.DataFeeder(["seq"]).feed([(np.asarray([1, 2, 3]),),
                                        (np.asarray([4, 5]),)])


def test_executor_program_with_scope_guard_isolation():
    def fn(state, feeds):
        new = {"w": state["w"] + feeds["x"]}
        return new, {"w": new["w"]}

    prog = fluid.Program(fn, name="acc", state_names=["w"])
    exe = fluid.Executor(fluid.CPUPlace())  # made BEFORE the guard
    inner = fluid.Scope()
    inner.set_var("w", torch.zeros(2))
    with fluid.scope_guard(inner):
        out = exe.run(prog, feed={"x": np.ones((2,), np.float32)},
                      fetch_list=["w"])
        np.testing.assert_allclose(out[0], 1.0)
        assert fluid.executor.global_scope() is inner
    assert not fluid.global_scope().has_var("w")
    assert float(inner.find_var("w")[0]) == 1.0


def test_fluid_aux_submodules():
    from paddle_tpu_torch.fluid import unique_name
    with unique_name.guard():
        assert unique_name.generate("fc") == "fc_0"
        assert unique_name.generate("fc") == "fc_1"
    with unique_name.guard(b"infer_"):
        assert unique_name.generate("fc") == "infer_fc_0"
    with pytest.raises(TypeError, match="prefix"):
        with unique_name.guard(123):
            pass
    wa = fluid.average.WeightedAverage()
    wa.add(torch.tensor(2.0))
    wa.add(4.0, weight=3)
    assert float(wa.eval()) == pytest.approx(3.5)
    with pytest.raises(ValueError, match="before any add"):
        fluid.average.WeightedAverage().eval()
    for cls in ("RoundRobin", "HashName"):
        p = getattr(fluid.transpiler, cls)(["a", "b"])
        j = getattr(jfluid.transpiler, cls)(["a", "b"])
        assert p.dispatch(["v1", "v2", "v3"]) == j.dispatch(["v1", "v2",
                                                             "v3"])


def test_dygraph_flow():
    from paddle_tpu_torch.core import place
    saved = place._current_place
    place.set_device("cpu")
    try:
        with fluid.dygraph.guard():
            v = fluid.dygraph.to_variable(np.ones((2, 4), np.float32))
            assert v.device.type == "cpu"
            lin = fluid.dygraph.Linear(4, 3, device="cpu")
            assert lin(v).shape == (2, 3)
            pool = fluid.dygraph.Pool2D(2, "avg", 2)
            assert pool(torch.ones(1, 1, 4, 4)).shape == (1, 1, 2, 2)
            with pytest.raises(ValueError, match="max/avg"):
                fluid.dygraph.Pool2D(2, "sum")
    finally:
        place._current_place = saved


def _scope_values():
    rng = np.random.default_rng(5)
    return {"w": rng.normal(size=(2, 3)).astype(np.float32),
            "opt_m": rng.normal(size=(2, 3)).astype(np.float32),
            "step": np.asarray(7, np.int32)}


def test_persistables_round_trip_and_parent_chain(tmp_path):
    outer = Scope()
    for k, v in _scope_values().items():
        outer.set_var(k, torch.from_numpy(v))
    outer.set_var("not_an_array", "metadata string")
    inner = outer.new_scope()
    inner.set_var("w", torch.full((2, 3), 5.0))  # shadows the parent's
    with fluid.scope_guard(inner):
        exe = fluid.Executor(fluid.CPUPlace())
        d = str(tmp_path / "ck") + os.sep  # trailing slash survives
        fluid.io.save_persistables(exe, d)
        fluid.io.save_params(exe, str(tmp_path / "ck2"))
    fresh = Scope()
    with fluid.scope_guard(fresh):
        exe = fluid.Executor(fluid.CPUPlace())
        fluid.io.load_persistables(exe, d)
        assert sorted(fresh.local_var_names()) == ["opt_m", "step", "w"]
        assert torch.equal(fresh.find_var("w"), torch.full((2, 3), 5.0))
        assert torch.equal(fresh.find_var("opt_m"),
                           outer.find_var("opt_m"))
        assert fresh.find_var("step").dtype == torch.int32
        held = fresh.find_var("opt_m")
        fluid.io.load_params(exe, str(tmp_path / "ck2"))
        assert fresh.find_var("opt_m") is held  # written in place

    class _Empty:
        scope = Scope()

    with pytest.raises(ValueError, match="nothing to checkpoint"):
        fluid.io.save_persistables(_Empty(), str(tmp_path / "ck3"))


def test_persistables_read_a_jax_save(tmp_path):
    vals = _scope_values()
    js = jfluid.Scope()
    for k, v in vals.items():
        js.set_var(k, jnp.asarray(v))
    with jfluid.scope_guard(js):
        jfluid.io.save_persistables(jfluid.Executor(jfluid.CPUPlace()),
                                    str(tmp_path / "jax"))
    fresh = Scope()
    with fluid.scope_guard(fresh):
        fluid.io.load_persistables(fluid.Executor(fluid.CPUPlace()),
                                   str(tmp_path / "jax"))
    for k, v in vals.items():
        np.testing.assert_array_equal(fresh.find_var(k).numpy(), v)


def test_lod_re_exports_match_jax():
    data = [[1, 2, 3], [4, 5]]
    got = fluid.create_lod_tensor([np.asarray(d) for d in data], [[3, 2]],
                                  fluid.CPUPlace())
    want = jfluid.create_lod_tensor([np.asarray(d) for d in data], [[3, 2]],
                                    jfluid.CPUPlace())
    assert type(got).__name__ == type(want).__name__ == "RaggedBatch"
    np.testing.assert_array_equal(np.asarray(got.lengths),
                                  np.asarray(want.lengths))
    np.testing.assert_array_equal(np.asarray(got.data),
                                  np.asarray(want.data))


def test_fluid_style_training_matches_jax():
    """A migrated loop in fluid spellings: ``fluid.layers`` math and
    ``fluid.optimizer.SGDOptimizer``, 25 steps of a linear fit; the loss
    sequence within TOL of the JAX loop's."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (32, 4)).astype(np.float32)
    y = x @ np.asarray([[1.0], [-2.0], [0.5], [3.0]], np.float32)

    jparams = {"w": jnp.zeros((4, 1), jnp.float32)}
    jopt = jfluid.optimizer.SGDOptimizer(learning_rate=0.1)
    jstate = jopt.init(jparams)

    def jloss(p):
        return jfluid.layers.reduce_mean(jfluid.layers.square_error_cost(
            jfluid.layers.matmul(x, p["w"]), y))

    step = jax.jit(jax.value_and_grad(jloss))
    want = []
    for _ in range(25):
        loss, grads = step(jparams)
        jparams, jstate = jopt.apply_gradients(jparams, grads, jstate)
        want.append(float(loss))

    w = torch.zeros(4, 1, requires_grad=True)
    params = {"w": w}
    opt = fluid.optimizer.SGDOptimizer(learning_rate=0.1)
    state = opt.init(params)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got = []
    for _ in range(25):
        loss = fluid.layers.reduce_mean(fluid.layers.square_error_cost(
            fluid.layers.matmul(xt, w), yt))
        (g,) = torch.autograd.grad(loss, [w])
        with torch.no_grad():
            opt.apply_gradients(params, {"w": g}, state)
        got.append(float(loss.detach()))
    assert got[-1] < got[0] / 5
    np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-6)
