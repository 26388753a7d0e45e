"""PyTorch port: the LLM engine's observability and fault points against
the JAX engine.

Both engines (2 layers, width 64, the JAX weights moved over with
``convert.params_from_jax``) serve the same requests with metrics on:
the ``llm_*`` / ``kv_*`` metric names, label sets and counts are equal
(sums of times left out), every sequence's timeline has the same event
kinds, the step ring holds one record per engine step with the same
phases, and the port's ``gauges_agree()`` judges True. Then each serving
fault point ends the same sequence in both packages, and only it.

The JAX engine runs its Pallas kernels in interpret mode. Its metrics
switch and registries are reset around each test, as are the port's.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import contextlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import paddle_tpu as pt  # noqa: E402
from paddle_tpu import observability as jax_obs  # noqa: E402
from paddle_tpu.models import GPTLanguageModel as JaxGPT  # noqa: E402
from paddle_tpu.models.gpt_lm import GPTConfig as JaxConfig  # noqa: E402
from paddle_tpu.serving_llm import LLMEngine as JaxEngine  # noqa: E402
from paddle_tpu.testing import faults as jax_faults  # noqa: E402

import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu_torch import observability as obs  # noqa: E402
from paddle_tpu_torch.convert import (load_jax_params,  # noqa: E402
                                      params_from_jax)
from paddle_tpu_torch.models import GPTConfig, GPTLanguageModel  # noqa: E402
from paddle_tpu_torch.serving_llm import LLMEngine  # noqa: E402
from paddle_tpu_torch.testing import faults  # noqa: E402

SMALL = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2,
             intermediate_size=128)
_DEFAULTS = {"kv_prefix_sharing": False, "prefill_chunk_tokens": 0,
             "speculative_k": 0, "enable_metrics": False}


@contextlib.contextmanager
def both_flags(**flags):
    pt.set_flags(flags)
    ptt.set_flags(flags)
    try:
        yield
    finally:
        restore = {k: _DEFAULTS[k] for k in flags}
        pt.set_flags(restore)
        ptt.set_flags(restore)


@pytest.fixture(autouse=True)
def _clean():
    for mod in (faults, jax_faults):
        mod.configure(None)
    jax_obs.reset_all()
    obs.reset_all()
    yield
    for mod in (faults, jax_faults):
        mod.configure(None)
    pt.set_flags({"enable_metrics": False})
    ptt.set_flags({"enable_metrics": False})
    jax_obs.reset_all()
    obs.reset_all()


def _port(jm, cfg):
    m = GPTLanguageModel(GPTConfig(**cfg), device="cpu")
    return load_jax_params(m, params_from_jax(
        {k: np.asarray(v) for k, v in jm.param_dict().items()}))


@pytest.fixture(scope="module")
def pair():
    pt.seed(3)
    jm = JaxGPT(JaxConfig(**SMALL))
    return jm, _port(jm, SMALL)


@pytest.fixture(scope="module")
def draft_pair():
    cfg = dict(SMALL, num_layers=1)
    pt.seed(4)
    jm = JaxGPT(JaxConfig(**cfg))
    return jm, _port(jm, cfg)


def _script(eng, staggered=False, spec_only=False):
    """Requests in, stepped to quiescence: (tokens by seq, error seq ids,
    steps taken)."""
    toks, errs, steps = {}, [], 0
    shared = list(range(1, 15))
    eng.add_request(shared + [20, 21], max_new_tokens=3 if spec_only else 5)
    if not spec_only:
        eng.add_request([5, 9, 2], max_new_tokens=4)
    for _ in range(200):
        if staggered and steps == 4:
            eng.add_request(shared + [30], max_new_tokens=3)
        if not eng.active() and (steps > 4 or not staggered):
            return toks, errs, steps
        for ev in eng.step():
            if ev["type"] == "token":
                toks.setdefault(ev["seq_id"], []).append(ev["token"])
            elif ev["type"] == "error":
                errs.append(ev["seq_id"])
        steps += 1
    raise AssertionError("engine did not quiesce")


def _engines(pair, draft=None):
    jm, pm = pair
    kw = dict(block_size=4, pool_blocks=24)
    je = JaxEngine(jm, draft_model=None if draft is None else draft[0],
                   **kw)
    te = LLMEngine(pm, draft_model=None if draft is None else draft[1],
                   device="cpu", **kw)
    return je, te


def _metric_view(snap, prefixes=("llm_", "kv_")):
    """name -> (type, {labels: value-or-count}); histograms by count, and
    by sum too unless they hold times."""
    out = {}
    for name, m in snap.items():
        if not name.startswith(prefixes):
            continue
        series = {}
        for s in m["series"]:
            key = tuple(sorted(s["labels"].items()))
            if m["type"] == "histogram":
                timed = name.endswith("_ms")
                series[key] = (s["count"], None if timed else s["sum"])
            else:
                series[key] = s["value"]
        out[name] = (m["type"], series)
    return out


def _kinds(ring):
    return {tl["seq_id"]: [e["ev"] for e in tl["events"]]
            for tl in ring.recent()}


def test_engine_metrics_timelines_and_steps_match_jax(pair):
    with both_flags(enable_metrics=True, kv_prefix_sharing=True,
                    prefill_chunk_tokens=8):
        je, te = _engines(pair)
        want = _script(je, staggered=True)
        got = _script(te, staggered=True)
        assert te.allocator.gauges_agree() is True
    assert got == want
    jv = _metric_view(jax_obs.registry().snapshot())
    pv = _metric_view(obs.registry().snapshot())
    assert sorted(pv) == sorted(jv)
    for name in jv:
        assert pv[name] == jv[name], name
    assert pv["kv_cow_copies_total"][1][()] >= 1
    assert _kinds(obs.seqtrace.ring()) == \
        _kinds(jax_obs.seqtrace.ring())
    tl = obs.seqtrace.ring().get(1)
    kinds = [e["ev"] for e in tl["events"]]
    assert kinds[:2] == ["queued", "admitted"] and \
        kinds[-1] == "finished" and kinds.count("token") == 5
    jr, pr = jax_obs.stepprof.ring().recent(), obs.stepprof.ring().recent()
    assert len(pr) == got[2] == len(jr)
    assert [sorted(r["phase_ms"]) for r in pr] == \
        [sorted(r["phase_ms"]) for r in jr]
    for a, b in zip(pr, jr):
        for k in ("batch", "kv", "prefix_hit_tokens", "tokens", "events"):
            assert a[k] == b[k], k


def test_speculative_metrics_match_jax(pair, draft_pair):
    with both_flags(enable_metrics=True, speculative_k=2):
        je, te = _engines(pair, draft_pair)
        want = _script(je, spec_only=True)
        got = _script(te, spec_only=True)
    assert got == want
    jv = _metric_view(jax_obs.registry().snapshot(), ("llm_spec",))
    pv = _metric_view(obs.registry().snapshot(), ("llm_spec",))
    assert pv == jv and "llm_spec_proposed_tokens_total" in pv
    assert _kinds(obs.seqtrace.ring()) == \
        _kinds(jax_obs.seqtrace.ring())


@pytest.mark.parametrize("spec,flags", [
    ("llm_prefill:at=2", {}),
    ("llm_chunk_prefill:at=3", {"prefill_chunk_tokens": 4}),
    ("llm_decode:at=3", {}),
    ("llm_spec_verify:at=2", {"speculative_k": 2}),
    ("llm_cow_copy:at=1", {"kv_prefix_sharing": True,
                           "prefill_chunk_tokens": 8}),
    ("kv_alloc:at=3", {}),
])
def test_each_serving_fault_ends_the_same_sequence(pair, draft_pair, spec,
                                                   flags):
    with both_flags(enable_metrics=True, **flags):
        draft = draft_pair if "speculative_k" in flags else None
        je, te = _engines(pair, draft)
        jax_faults.configure(spec)
        want = _script(je, staggered=True)
        faults.configure(spec)
        got = _script(te, staggered=True)
    assert got == want
    assert len(got[1]) == 1, got
    point = spec.split(":")[0]
    assert obs.counter("faults_injected_total").value(point=point) == 1
    (sid,) = got[1]
    assert obs.seqtrace.ring().get(sid)["outcome"] == "error"
    outcomes = [tl["outcome"] for tl in obs.seqtrace.ring().recent()]
    assert outcomes.count("error") == 1
    assert te.allocator.num_used == 0
    te.allocator.check()
    ev = [e for e in obs.flight_recorder().events()
          if e["kind"] in ("fault_injected", "seq_timeline")]
    assert [e["kind"] for e in ev] == ["fault_injected", "seq_timeline"]
