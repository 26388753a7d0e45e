"""PyTorch port: the hang doctor against the JAX package.

The JAX suite's stack tests run against the port case for case (capture,
the lock and I/O wedge classification, the bounded sampling profiler,
``/stacks`` with metrics off, the SIGUSR2 dump, the SLO snapshot in the
flight final record, the doctor's debounce), then: ``classify`` gives the
JAX verdicts over the same frames, a host blocked on the card
(``synchronize``) is the port's ``blocked_in_collective``, the hang
monitor names the injected wedge's frame while a serving engine reads
stalled, and the engine's stall watchdog files its post-hoc diagnosis.
No test bounds a wall time (the sampler's cost is measured on the card).
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import json
import os
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request

import pytest

jax = pytest.importorskip("jax")

from paddle_tpu.observability import stacks as jax_stacks  # noqa: E402

import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu_torch import observability as obs  # noqa: E402
from paddle_tpu_torch.observability import server as obs_server  # noqa: E402
from paddle_tpu_torch.observability import stacks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def stacks_clean():
    obs.reset_all()
    try:
        yield
    finally:
        ptt.set_flags({"enable_metrics": False, "stack_sample_hz": 0.0,
                       "stack_profile_max": 512, "trace_dir": "",
                       "hang_check_interval_s": 1.0})
        obs.reset_all()


# -- capture + classification ---------------------------------------------------

def test_capture_sees_current_threads():
    recs = stacks.capture(top_n=8)
    by_name = {r["name"]: r for r in recs}
    main = by_name["MainThread"]
    assert main["daemon"] is False
    assert 1 <= len(main["frames"]) <= 8
    assert main["frames"][0].endswith(":capture")
    assert all("_frames_raw" not in t for t in stacks._public(recs))


_WEDGE = textwrap.dedent("""
    import threading, time

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._data = 0  # guarded-by: self._lock

        def use(self, started, release):
            started.set()
            with self._lock:
                self._data += 1
            release.wait()

    def sleeper(started, release):
        started.set()
        while not release.is_set():
            time.sleep(0.05)
""")


def _load(tmp_path, name, text):
    import importlib.util
    path = tmp_path / f"{name}.py"
    path.write_text(text)
    spec = importlib.util.spec_from_file_location(name, str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_classify_lock_and_io_wedges(tmp_path):
    wedge_mod = _load(tmp_path, "wedge_mod", _WEDGE)
    box = wedge_mod.Box()
    release = threading.Event()
    started_l, started_s = threading.Event(), threading.Event()
    box._lock.acquire()
    t_lock = threading.Thread(target=box.use, args=(started_l, release),
                              name="t-lock", daemon=True)
    t_io = threading.Thread(target=wedge_mod.sleeper,
                            args=(started_s, release), name="t-io",
                            daemon=True)
    t_lock.start()
    t_io.start()
    try:
        assert started_l.wait(5) and started_s.wait(5)
        lock_rec = io_rec = None
        for _ in range(250):
            by_name = {r["name"]: r for r in stacks.capture()}
            lock_rec, io_rec = by_name.get("t-lock"), by_name.get("t-io")
            if lock_rec and io_rec \
                    and lock_rec["state"] == "blocked_on_lock" \
                    and io_rec["state"] == "blocked_in_io":
                break
            release.wait(0.02)
        assert lock_rec["state"] == "blocked_on_lock", lock_rec
        assert lock_rec["lock"] == "self._lock", lock_rec
        assert lock_rec["guards"] == ["_data"], lock_rec
        assert io_rec["state"] == "blocked_in_io", io_rec
        assert "time.sleep" in io_rec["source_line"], io_rec
        # the same frames, the JAX verdicts
        for rec in (lock_rec, io_rec):
            assert stacks.classify(rec["_frames_raw"]) \
                == jax_stacks.classify(rec["_frames_raw"])
    finally:
        box._lock.release()
        release.set()
        t_lock.join(5)
        t_io.join(5)
    assert not t_lock.is_alive() and not t_io.is_alive()


_FRAMES = textwrap.dedent("""
    import threading

    def holder(lock):
        with lock:
            pass

    def acquirer(self):
        self._state_lock.acquire()

    def reader(sock):
        return sock.recv(10)

    def spin(n):
        return n + 1

    def all_gather(x):
        return x
""")


def _frames(path, func, line_text):
    lines = open(path).read().splitlines()
    line = next(i + 1 for i, ln in enumerate(lines) if line_text in ln)
    return {"file": str(path), "line": line, "func": func}


@pytest.mark.parametrize("case", ["with_lock", "acquire", "recv", "spin",
                                  "all_gather", "threading_wait",
                                  "distributed", "empty"])
def test_classify_matches_jax_on_the_same_frames(tmp_path, case):
    path = tmp_path / "frames_mod.py"
    path.write_text(_FRAMES)
    import threading as _th
    th_file = _th.__file__
    th_lines = open(th_file).read().splitlines()
    wait_line = next(i + 1 for i, ln in enumerate(th_lines)
                     if "def wait(" in ln)
    app = _frames(path, "holder", "with lock:")
    frames = {
        "with_lock": [app],
        "acquire": [_frames(path, "acquirer", ".acquire(")],
        "recv": [_frames(path, "reader", ".recv(")],
        "spin": [_frames(path, "spin", "n + 1")],
        "all_gather": [_frames(path, "spin", "n + 1"),
                       _frames(path, "all_gather", "return x")],
        "threading_wait": [{"file": th_file, "line": wait_line,
                            "func": "wait"}, app],
        "distributed": [_frames(path, "spin", "n + 1"),
                        {"file": "/x/torch/distributed/c10d.py",
                         "line": 1, "func": "barrier_impl"}],
        "empty": [],
    }[case]
    assert stacks.classify(frames) == jax_stacks.classify(frames)


def test_host_blocked_on_the_card_is_blocked_in_collective(tmp_path):
    """torch.cuda.synchronize / Event.synchronize / Stream.synchronize:
    the port's counterpart of JAX's block_until_ready."""
    path = tmp_path / "sync_mod.py"
    path.write_text("def synchronize():\n    return wait_for_card()\n")
    verdict = stacks.classify([
        {"file": str(path), "line": 2, "func": "synchronize"},
        {"file": str(path), "line": 1, "func": "train_loop"}])
    assert verdict["state"] == "blocked_in_collective"
    assert verdict["frame"].endswith(":synchronize")
    assert "synchronize" in stacks._COLLECTIVE_FUNCS
    assert set(jax_stacks._COLLECTIVE_FUNCS) <= set(stacks._COLLECTIVE_FUNCS)
    assert stacks._INFRA_THREADS == jax_stacks._INFRA_THREADS


# -- sampling profiler ------------------------------------------------------------

def test_sampler_profile_is_bounded():
    ptt.set_flags({"enable_metrics": True, "stack_profile_max": 8})
    stop = threading.Event()

    def vary(n):
        if n > 0:
            vary(n - 1)
        else:
            time.sleep(0.003)

    def churn():
        while not stop.is_set():
            for depth in range(30):
                vary(depth)

    t = threading.Thread(target=churn, name="t-churn", daemon=True)
    t.start()
    ptt.set_flags({"stack_sample_hz": 200.0})  # on_change starts it
    try:
        assert stacks.sampler().running()
        for _ in range(1000):
            if stacks.sampler().status()["dropped_total"] > 0:
                break
            stop.wait(0.01)
        st = stacks.sampler().status()
        assert st["samples_total"] > 0 and st["dropped_total"] > 0, st
        prof = stacks.sampler().profile()
        real = [k for k in prof if k[1] != stacks._OVERFLOW_KEY]
        assert len(real) <= 8
        assert any(k[1] == stacks._OVERFLOW_KEY for k in prof)
        text = stacks.collapsed_text()
        assert any(line.rsplit(" ", 1)[1].isdigit()
                   for line in text.splitlines())
        flame = stacks.flame_trace()
        assert any(e.get("ph") == "X" for e in flame["traceEvents"])
        assert obs.counter("stack_profile_dropped_total").value() > 0
        ratio = obs.gauge("stack_sampler_overhead_ratio").value()
        assert ratio is not None and 0.0 <= ratio <= 1.0
    finally:
        stop.set()
        ptt.set_flags({"stack_sample_hz": 0.0})
        t.join(5)
    assert not stacks.sampler().running()
    assert not t.is_alive()


def test_stacks_endpoint_serves_with_metrics_off():
    assert not obs.enabled()
    srv = obs_server.ObservabilityServer(0)
    base = f"http://127.0.0.1:{srv.port}"
    try:
        with urllib.request.urlopen(base + "/stacks?n=4", timeout=10) as r:
            assert r.status == 200
            body = json.loads(r.read().decode())
        assert "MainThread" in [t["name"] for t in body["threads"]]
        assert all(len(t["frames"]) <= 4 for t in body["threads"])
        assert body["sampler"]["running"] is False
        with urllib.request.urlopen(base + "/stacks?format=collapsed",
                                    timeout=10) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
        with urllib.request.urlopen(base + "/stacks?format=flame",
                                    timeout=10) as r:
            assert "traceEvents" in json.loads(r.read().decode())
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/stacks/nope", timeout=10)
        assert ei.value.code == 404
    finally:
        srv.stop()


# -- the signal dump and the flight final record ---------------------------------

_SIGUSR2_SCRIPT = r"""
import json, os, signal, sys, threading
import paddle_tpu_torch as ptt
from paddle_tpu_torch.observability import stacks

trace_dir = sys.argv[1]
ptt.set_flags({"trace_dir": trace_dir})
assert stacks.install_signal_dump()
os.kill(os.getpid(), signal.SIGUSR2)
path, ev = None, threading.Event()
for _ in range(200):
    hits = [f for f in os.listdir(trace_dir) if f.startswith("flight_")]
    if hits:
        path = os.path.join(trace_dir, hits[0])
        break
    ev.wait(0.05)
print("survived")
lines = [json.loads(l) for l in open(path)]
kinds = [l["kind"] for l in lines]
assert kinds[0] == "flight_header", kinds
assert "thread_stacks" in kinds[1:-1], kinds
e = next(l for l in lines if l["kind"] == "thread_stacks")
assert e["reason"] == "sigusr2", e
assert any(t["name"] == "MainThread" for t in e["threads"])
assert lines[-1]["kind"] == "final_metrics"
assert "alerts" in lines[-1] and "tsdb" in lines[-1], lines[-1].keys()
assert "goodput" in lines[-1], lines[-1].keys()
print("sigusr2 roundtrip OK")
"""


def test_sigusr2_dumps_stacks_to_flight(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _SIGUSR2_SCRIPT, str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "survived" in proc.stdout
    assert "sigusr2 roundtrip OK" in proc.stdout


def test_flight_final_carries_slo_and_goodput_snapshot(tmp_path):
    ptt.set_flags({"enable_metrics": True, "trace_dir": str(tmp_path)})
    rec = obs.flight.FlightRecorder(capacity=16)
    rec.record("step", step=1)
    path = rec.dump("manual", str(tmp_path))
    final = [json.loads(ln) for ln in open(path)][-1]
    assert final["kind"] == "final_metrics"
    assert "worst_state" in final["alerts"]
    assert "capacity" in final["tsdb"]
    assert "wall_seconds" in final["goodput"]


# -- the hang doctor --------------------------------------------------------------

def test_hang_doctor_debounce_and_post_hoc_suppression():
    doc = stacks.doctor()
    doc.reset()
    d1 = doc.diagnose("serving")
    assert d1 is not None and d1["culprit"] is not None
    assert doc.diagnose("serving") is None
    assert doc.diagnose("serving_step") is None
    assert doc.diagnose("serving_step", force=True) is not None
    doc.reset()
    assert doc.diagnose("serving_step") is not None
    assert obs.counter("hang_diagnoses_total", always=True).value(
        source="serving_step") == 2


_ENGINE_STEP = textwrap.dedent("""
    from paddle_tpu_torch.testing import faults

    def step(started, release):
        started.set()
        while not release.is_set():
            faults._injected_wedge_sleep(20.0)
""")


def test_monitor_names_the_injected_wedge_while_it_hangs(monkeypatch,
                                                         tmp_path):
    """A serving engine reads stalled while its thread sleeps in the
    fault registry's wedge under a ``serving_llm`` frame: the live
    monitor's diagnosis names the wedge's frame (what phase 8c holds on
    the card with a real engine)."""
    from paddle_tpu_torch.serving_llm import engine as eng_mod
    (tmp_path / "serving_llm").mkdir()
    step_mod = _load(tmp_path / "serving_llm", "fake_engine_step",
                     _ENGINE_STEP)
    started, release = threading.Event(), threading.Event()

    def wedged():
        step_mod.step(started, release)

    def health():
        return {"ok": False, "engines": [{"stalled": started.is_set()
                                          and not release.is_set(),
                                          "last_step_age_s": 1.0}]}

    monkeypatch.setattr(eng_mod, "health_snapshot", health)
    t = threading.Thread(target=wedged, name="serving-wedged", daemon=True)
    ptt.set_flags({"hang_check_interval_s": 0.02})
    t.start()
    assert started.wait(5)
    stacks.monitor().start()
    try:
        diag = None
        for _ in range(500):
            diag = next((e for e in obs.flight_recorder().events()
                         if e["kind"] == "hang_diagnosis"), None)
            if diag is not None:
                break
            release.wait(0.01)
        assert diag is not None
        assert diag["source"] == "serving"
        assert diag["culprit"]["thread"] == "serving-wedged"
        assert diag["culprit"]["state"] == "blocked_in_io"
        assert diag["culprit"]["frame"].endswith(
            "faults.py:" + diag["culprit"]["frame"].split(":")[-2]
            + ":_injected_wedge_sleep")
    finally:
        release.set()
        stacks.monitor().stop()
        t.join(5)
    assert not stacks.monitor().running() and not t.is_alive()


def test_engine_stall_watchdog_files_a_post_hoc_diagnosis():
    from paddle_tpu_torch.models import GPTConfig, GPTLanguageModel
    from paddle_tpu_torch.serving_llm import LLMEngine
    model = GPTLanguageModel(GPTConfig(vocab_size=64, hidden_size=32,
                                       num_layers=1, num_heads=2,
                                       max_position_embeddings=64),
                             device="cpu")
    eng = LLMEngine(model, block_size=4, pool_blocks=16, device="cpu")
    eng._step_ewma_s = 0.001
    eng._note_step(5.0)  # a step 5000x its EWMA: a stall
    diag = [e for e in obs.flight_recorder().events()
            if e["kind"] == "hang_diagnosis"]
    assert len(diag) == 1 and diag[0]["source"] == "serving_step"
    assert diag[0]["detail"]["step_s"] == 5.0
    assert eng.stalls_total == 1
