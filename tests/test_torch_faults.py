"""PyTorch port: fault injection and the train step's probes, against the
JAX package.

- ``testing.faults``: the spec grammar, the firing sequences of ``at=``,
  ``step=`` and seeded ``p=`` entries and the value multipliers equal
  JAX's over the same specs; ``kill=`` / ``exit=`` and an env-armed spec
  run in a subprocess of their own (never the pytest worker).
- ``TrainStep`` on the CPU (eager, and its captured body through a
  stand-in backend): the JAX suite's skip-guard and value-fault drills
  (``tests/test_numeric_guard.py``), the ``step=`` trigger, the loss
  spike reaching the anomaly sentinel, and ``lr_scale``, each against
  the JAX step on the same weights and batches.

Every test disarms both registries and restores each flag it sets.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as pt  # noqa: E402
from paddle_tpu.ops.loss import cross_entropy as jax_xent  # noqa: E402
from paddle_tpu.optimizer import Adam as JaxAdam  # noqa: E402
from paddle_tpu.optimizer import lr as jax_lr  # noqa: E402
from paddle_tpu.static import TrainStep as JaxTrainStep  # noqa: E402
from paddle_tpu.testing import faults as jax_faults  # noqa: E402

import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu_torch import observability as obs  # noqa: E402
from paddle_tpu_torch.convert import load_jax_params  # noqa: E402
from paddle_tpu_torch.nn.layers import Linear  # noqa: E402
from paddle_tpu_torch.ops.loss import cross_entropy  # noqa: E402
from paddle_tpu_torch.optimizer import Adam  # noqa: E402
from paddle_tpu_torch.optimizer import lr as port_lr  # noqa: E402
from paddle_tpu_torch.static import TrainStep  # noqa: E402
from paddle_tpu_torch.testing import faults  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32 Adam on both sides, in the same order: an ulp or two
TOL = 1e-6


@pytest.fixture(autouse=True)
def _clean():
    faults.configure(None)
    jax_faults.configure(None)
    faults.set_step_context(None)
    jax_faults.set_step_context(None)
    obs.reset_all()
    yield
    faults.configure(None)
    jax_faults.configure(None)
    faults.set_step_context(None)
    jax_faults.set_step_context(None)
    ptt.set_flags({"enable_metrics": False, "fault_spec": "",
                   "skip_nonfinite_steps": True})
    obs.reset_all()


def _both(spec):
    faults.configure(spec)
    jax_faults.configure(spec)


# -- the grammar ----------------------------------------------------------

SPECS = ["ckpt_write:p=1:at=2", "sigterm:step=7", "loader:exc=OSError",
         "train_step:step=3:exc=RuntimeError", "ckpt_write:step=8:kill=9",
         "llm_decode:sleep=25:at=3", "x:kill=TERM:seed=4",
         "nonfinite_grad:at=4,loss_spike:at=5:mul=1e8,loss_spike:mul=nan",
         "a:p=0.25:seed=11,b:exit=3", ""]


@pytest.mark.parametrize("text", SPECS)
def test_parse_and_format_match_jax(text):
    got, want = faults.parse_spec(text), jax_faults.parse_spec(text)
    # repr: a NaN multiplier compares equal as text
    assert [repr(vars(s)) for s in got] == [repr(vars(s)) for s in want]
    assert faults.format_spec(got) == jax_faults.format_spec(want)
    again = faults.parse_spec(faults.format_spec(got))
    assert faults.format_spec(again) == faults.format_spec(got)


@pytest.mark.parametrize("text", ["point:at", "=x", "p:bogus=1",
                                  "p:kill=NOSUCHSIG", "p:at=x"])
def test_malformed_specs_raise_as_in_jax(text):
    with pytest.raises(ValueError):
        jax_faults.parse_spec(text)
    with pytest.raises(ValueError):
        faults.parse_spec(text)


def _fires(mod, point, n, steps=None):
    """Indices (1-based) of the calls of ``point`` that raised."""
    out = []
    for i in range(1, n + 1):
        try:
            mod.hit(point, step=None if steps is None else steps[i - 1])
        except ValueError:
            out.append(i)
    return out


@pytest.mark.parametrize("spec,steps", [
    ("pt_x:at=3:exc=ValueError", None),
    ("pt_x:at=2:exc=ValueError,pt_x:at=3:exc=ValueError", None),
    ("pt_x:step=4:exc=ValueError", [1, 2, 4, 4, 5, 4, 6, 7, 8, 9]),
    ("pt_x:p=0.3:seed=7:exc=ValueError", None),
    ("pt_x:p=0.5:seed=1:at=5:exc=ValueError", None),
    ("pt_x:p=0.4:exc=ValueError,pt_x:p=0.6:seed=2:exc=ValueError", None),
    ("other:at=1:exc=ValueError", None),
])
def test_firing_sequences_match_jax(spec, steps):
    _both(spec)
    want = _fires(jax_faults, "pt_x", 10, steps)
    got = _fires(faults, "pt_x", 10, steps)
    assert got == want


def test_value_multipliers_match_jax():
    spec = ("nonfinite_grad:at=2,loss_spike:at=3:mul=1e8,"
            "loss_spike:step=6,vp:at=1:mul=2,vp:at=2:mul=4")
    _both(spec)
    assert faults.value_points_armed() and jax_faults.value_points_armed()
    seq = []
    for mod in (jax_faults, faults):
        out = []
        for k in range(1, 8):
            mod.set_step_context(k)
            out.append((mod.value_mult("nonfinite_grad"),
                        mod.value_mult("loss_spike"), mod.value_mult("vp")))
        seq.append(out)
    assert np.array_equal(np.array(seq[1]), np.array(seq[0]),
                          equal_nan=True)
    assert np.isnan(seq[1][1][0]) and seq[1][2][1] == 1e8 \
        and seq[1][5][1] == 1e6
    faults.configure("ckpt_write:at=99")
    assert not faults.value_points_armed()


def test_fired_faults_count_and_leave_a_forced_flight_event():
    faults.configure("pt_y:at=2:sleep=1,pt_z:exc=KeyError")
    faults.hit("pt_y")
    faults.hit("pt_y")  # sleeps 1 ms, then returns
    with pytest.raises(KeyError):
        faults.hit("pt_z", step=5)
    c = obs.counter("faults_injected_total", always=True)
    assert c.value(point="pt_y") == 1 and c.value(point="pt_z") == 1
    ev = [e for e in obs.flight_recorder().events()
          if e["kind"] == "fault_injected"]
    assert [(e["point"], e["step"]) for e in ev] == [("pt_y", None),
                                                     ("pt_z", 5)]


def test_the_flag_arms_and_disarms_the_registry():
    ptt.set_flags({"fault_spec": "pt_q:exc=ValueError"})
    assert faults.active()
    with pytest.raises(ValueError):
        faults.hit("pt_q")
    ptt.set_flags({"fault_spec": ""})
    assert not faults.active()
    faults.hit("pt_q")


_CHILD = """
import sys
sys.path.insert(0, {root!r})
from paddle_tpu_torch.testing import faults
faults.hit("train_step")
print("survived")
"""


@pytest.mark.parametrize("spec,rc", [("train_step:exit=7", 7),
                                     ("train_step:kill=TERM", -15),
                                     ("train_step:at=2:exit=5", 0)])
def test_kill_and_exit_actions_in_a_subprocess(spec, rc):
    """The env-set FLAGS_fault_spec arms the registry at import, as the
    JAX package's drills rely on; the action ends the child alone."""
    env = dict(os.environ, FLAGS_fault_spec=spec)
    p = subprocess.run([sys.executable, "-c", _CHILD.format(root=ROOT)],
                       env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == rc, p.stderr
    assert ("survived" in p.stdout) == (rc == 0)


# -- the train step -------------------------------------------------------

def _data(n=16, poison=False, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, 4)).astype(np.float32)
    if poison:
        x[0, 0] = np.inf
    y = rng.integers(0, 2, (n,)).astype(np.int64)
    return x, y


def _pair(lr=0.1, **step_kw):
    """A JAX and a port TrainStep over the same Linear(4, 2) weights."""
    pt.seed(0)
    jnet = pt.nn.Linear(4, 2)
    pnet = load_jax_params(Linear(4, 2, device="cpu"),
                           {k: np.asarray(v)
                            for k, v in jnet.param_dict().items()})
    jlr = lr(jax_lr) if callable(lr) else lr
    plr = lr(port_lr) if callable(lr) else lr
    js = JaxTrainStep(jnet, JaxAdam(learning_rate=jlr),
                      lambda o, y: jax_xent(o, y), **step_kw)
    ps = TrainStep(pnet, Adam(learning_rate=plr),
                   lambda o, y: cross_entropy(o, y), **step_kw)
    return js, ps


def _go(js, ps, x, y, k=None):
    if k is not None:
        jax_faults.set_step_context(k)
        faults.set_step_context(k)
    jl = float(js(jnp.asarray(x), labels=jnp.asarray(y))["loss"])
    pl = float(ps(torch.from_numpy(x), labels=torch.from_numpy(y))["loss"])
    return jl, pl


def _w(step):
    return {"weight": step.params["weight"].detach().clone(),
            "bias": step.params["bias"].detach().clone()}


def _same(js, ps, tol=TOL):
    for name, want in js.state["params"].items():
        got = ps.params[name].detach().numpy()
        want = np.asarray(want)
        assert np.max(np.abs(got - want)) <= tol * max(
            1.0, float(np.max(np.abs(want)))), name


def test_skip_guard_discards_nonfinite_update_as_jax():
    js, ps = _pair()
    x, y = _data()
    _go(js, ps, x, y)
    w1 = _w(ps)
    s1 = int(ps.state["step"])
    xp, yp = _data(poison=True)
    _go(js, ps, xp, yp)   # inf input -> non-finite grads
    for k, v in _w(ps).items():
        assert torch.equal(v, w1[k]), k
    assert int(ps.state["step"]) == s1 == int(js.state["opt"]["step"])
    _go(js, ps, x, y)     # a clean step trains again
    _same(js, ps)
    assert int(ps.nonfinite_steps) == 1


def test_skip_guard_counts_nonfinite_steps():
    ptt.set_flags({"enable_metrics": True})
    _, ps = _pair()
    xp, yp = _data(poison=True)
    ps(torch.from_numpy(xp), labels=torch.from_numpy(yp))
    ps.sync_to_model()  # a blocking flush of the probes
    assert obs.counter("nonfinite_steps_total").value() == 1
    kinds = [e["kind"] for e in obs.flight_recorder().events()]
    assert "nonfinite_step" in kinds
    assert obs.counter("anomalies_total").value(
        kind="nan", series="grad_norm") == 1


def test_skip_guard_opt_out_flag():
    ptt.set_flags({"skip_nonfinite_steps": False})
    _, ps = _pair()
    xp, yp = _data(poison=True)
    ps(torch.from_numpy(xp), labels=torch.from_numpy(yp))
    assert not torch.isfinite(ps.params["weight"]).all()


@pytest.mark.parametrize("spec,skipped", [("nonfinite_grad:at=2", 2),
                                          ("nonfinite_grad:step=3", 3)])
def test_injected_nonfinite_grad_value_fault_as_jax(spec, skipped):
    js, ps = _pair()
    _both(spec)
    x, y = _data()
    before = None
    for k in range(1, 5):
        if k == skipped:
            before = _w(ps)
        _go(js, ps, x, y, k)
        if k == skipped:
            for n, v in _w(ps).items():
                assert torch.equal(v, before[n]), n
        _same(js, ps)
    assert int(ps.nonfinite_steps) == 1
    assert int(ps.state["step"]) == int(js.state["opt"]["step"]) == 3
    assert obs.counter("faults_injected_total", always=True).value(
        point="nonfinite_grad") == 1


def test_loss_spike_reaches_the_sentinel_at_its_step():
    ptt.set_flags({"enable_metrics": True})
    js, ps = _pair(lr=0.001)
    _both("loss_spike:step=8")
    x, y = _data()
    got = []
    obs.anomaly_sentinel().add_listener(
        lambda series, v, kind: got.append((series, kind)))
    losses = [_go(js, ps, x, y, k) for k in range(1, 11)]
    ps.flush_signals()
    jl, pl = np.array(losses).T
    assert np.max(np.abs(pl - jl) / np.abs(jl)) <= 1e-5
    assert pl[7] > 1e4 * pl[6]
    kinds = [k for s, k in got if s == "loss"]
    assert kinds == [None] * 7 + ["spike"] + [None] * 2
    assert obs.counter("anomalies_total").value(
        kind="spike", series="loss") == 1


@pytest.mark.parametrize("lr", [0.05, lambda m: m.ExponentialDecay(
    learning_rate=0.05, gamma=0.8)])
def test_lr_scale_matches_jax(lr):
    js, ps = _pair(lr=lr)
    x, y = _data()
    for k, scale in enumerate([1.0, 0.5, 0.5, 0.25]):
        js.lr_scale = ps.lr_scale = scale
        _go(js, ps, *_data(seed=k))
    _same(js, ps)


# -- the captured body (a stand-in for the CUDA graph on the CPU) -----------

class _Graph:
    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


class _EagerGraphs:
    def warm_up(self, fn):
        return fn()

    def capture(self, fn, generator=None, table_rows=0):
        return _Graph(fn), []


def _state(step):
    out = {f"p.{n}": p.detach().clone() for n, p in step.params.items()}
    out["step"] = step.state["step"].clone()
    for n, slots in step.state["slots"].items():
        out.update({f"{n}.{k}": t.clone() for k, t in slots.items()})
    return out


def test_captured_value_fault_keeps_one_capture_and_equals_eager():
    """``nonfinite_grad:step=3`` over 5 steps: one capture, step 3 leaves
    every parameter, moment and the counter as step 2 left them, and the
    captured run equals its eager twin bit for bit; a rescale reuses the
    graph."""
    ptt.set_flags({"enable_metrics": True})
    runs = []
    for compiled in (True, False):
        _, ps = _pair()
        if compiled:
            ps.compiled, ps._backend = True, _EagerGraphs()
        faults.configure("nonfinite_grad:step=3")
        x, y = _data()
        states = []
        for k in range(1, 6):
            faults.set_step_context(k)
            ps(torch.from_numpy(x), labels=torch.from_numpy(y))
            states.append(_state(ps))
        ps.lr_scale = 0.5
        ps(torch.from_numpy(x), labels=torch.from_numpy(y))
        states.append(_state(ps))
        ps.sync_to_model()
        runs.append((ps, states))
    (cs, cstates), (es, estates) = runs
    assert cs.captures == 1 and es.captures == 0
    for k, v in cstates[1].items():
        assert torch.equal(cstates[2][k], v), k
    for a, b in zip(cstates, estates):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert obs.counter("nonfinite_steps_total").value() == 2
