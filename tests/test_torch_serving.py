"""PyTorch port: the paged-KV LLM engine against the JAX engine.

Both engines serve the same requests on the same weights (the JAX
model's ``param_dict()`` moved into the port) at temperature 0 and must
emit the same tokens, in the same order, with the same allocator and
speculative counters. The JAX engine runs its Pallas kernels in
interpret mode; the port runs the kernels' plain versions on the CPU.
Then the port's own invariants: position-keyed sampling at temperature
> 0, the allocator against a shadow model, admission and device rules.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import contextlib
import random

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as pt  # noqa: E402
from paddle_tpu.models import GPTLanguageModel as JaxGPT  # noqa: E402
from paddle_tpu.models.gpt_lm import GPTConfig as JaxConfig  # noqa: E402
from paddle_tpu.serving_llm import LLMEngine as JaxEngine  # noqa: E402

import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu_torch.convert import load_jax_params  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTLanguageModel  # noqa: E402
from paddle_tpu_torch.serving_llm import (AdmissionRejected,  # noqa: E402
                                          KVBlockAllocator, LLMEngine)
from paddle_tpu_torch.serving_llm.engine import sampling_noise  # noqa: E402

_DEFAULTS = {"kv_prefix_sharing": False, "prefill_chunk_tokens": 0,
             "speculative_k": 0, "kv_admission_watermark": 0.0}


@contextlib.contextmanager
def both_flags(**flags):
    """Set the same flags in the JAX package and in the port."""
    pt.set_flags(flags)
    ptt.set_flags(flags)
    try:
        yield
    finally:
        restore = {k: _DEFAULTS[k] for k in flags}
        pt.set_flags(restore)
        ptt.set_flags(restore)


def _port(jax_model, config=None):
    m = GPTLanguageModel(config, device="cpu")
    return load_jax_params(m, {k: np.asarray(v)
                               for k, v in jax_model.param_dict().items()})


@pytest.fixture(scope="module")
def pair():
    jm = JaxGPT()
    return jm, _port(jm)


@pytest.fixture(scope="module")
def draft_pair():
    cfg = dict(num_layers=1)
    jm = JaxGPT(JaxConfig(**cfg))
    return jm, _port(jm, GPTConfig(**cfg))


def _run(engine, out=None, max_steps=400):
    """Step to quiescence: tokens per seq id and the finish order."""
    out = {} if out is None else out
    order = []
    for _ in range(max_steps):
        if not engine.active():
            return out, order
        for ev in engine.step():
            assert ev["type"] in ("token", "finished"), ev
            if ev["type"] == "token":
                out.setdefault(ev["seq_id"], []).append(ev["token"])
            else:
                order.append(ev["seq_id"])
    raise AssertionError("engine did not quiesce")


def _both(pair, script, **engine_kw):
    """Run ``script(engine)`` on a JAX and a port engine built alike;
    return both results and both engines."""
    jm, pm = pair
    draft = engine_kw.pop("draft", None)
    je = JaxEngine(jm, draft_model=None if draft is None else draft[0],
                   **engine_kw)
    te = LLMEngine(pm, draft_model=None if draft is None else draft[1],
                   device="cpu", **engine_kw)
    return script(je), script(te), je, te


def _same_counters(je, te):
    for a in ("allocs_total", "freed_total", "cow_copies_total",
              "prefix_hit_tokens_total", "alloc_failures_total"):
        assert getattr(te.allocator, a) == getattr(je.allocator, a), a
    assert te.scheduler.preemptions_total == je.scheduler.preemptions_total
    assert te.spec_proposed_total == je.spec_proposed_total
    assert te.spec_accepted_total == je.spec_accepted_total
    assert te.allocator.num_used == 0
    te.allocator.check()


class TestEngineParityWithJax:
    def test_ragged_batch(self, pair):
        def script(eng):
            for p in ([5, 9, 2], [7] * 17, [1, 2]):
                eng.add_request(p, max_new_tokens=5)
            return _run(eng)
        got, want, je, te = _both(pair, script, block_size=4,
                                  pool_blocks=32)
        assert got == want
        _same_counters(je, te)

    def test_short_request_joins_mid_decode(self, pair):
        def script(eng):
            eng.add_request([3] * 40, max_new_tokens=12)
            out = {}
            for _ in range(2):                  # long one is decoding
                for ev in eng.step():
                    if ev["type"] == "token":
                        out.setdefault(ev["seq_id"], []).append(
                            ev["token"])
            eng.add_request([4, 5], max_new_tokens=3)
            return _run(eng, out)
        got, want, je, te = _both(pair, script, block_size=4,
                                  pool_blocks=64)
        assert got == want
        assert got[1] == [2, 1]                 # short finishes first
        _same_counters(je, te)

    def test_preemption_recompute_in_a_three_block_pool(self, pair):
        def script(eng):
            eng.add_request([5, 9, 2], max_new_tokens=6)
            eng.add_request([7, 7, 7], max_new_tokens=6)
            return _run(eng)
        got, want, je, te = _both(pair, script, block_size=4,
                                  pool_blocks=3, max_decode_batch=4)
        assert got == want
        assert te.scheduler.preemptions_total >= 1
        _same_counters(je, te)

    def test_prefix_sharing_cow_and_chunked_prefill(self, pair):
        shared = list(range(1, 15))

        def script(eng):
            out = {}
            eng.add_request(shared + [20, 21], max_new_tokens=8)
            for _ in range(6):                  # A prefilled + decoding
                for ev in eng.step():
                    if ev["type"] == "token":
                        out.setdefault(ev["seq_id"], []).append(
                            ev["token"])
            eng.add_request(shared + [30], max_new_tokens=8)
            return _run(eng, out)
        with both_flags(kv_prefix_sharing=True, prefill_chunk_tokens=4):
            got, want, je, te = _both(pair, script, block_size=4,
                                      pool_blocks=32)
        assert got == want
        assert te.allocator.cow_copies_total >= 1
        assert te.allocator.prefix_hit_tokens_total >= 14
        _same_counters(je, te)

    def test_speculative_with_a_converted_draft(self, pair, draft_pair):
        def script(eng):
            for p in ([5, 9, 2], [7] * 17):
                eng.add_request(p, max_new_tokens=6)
            return _run(eng)
        with both_flags(speculative_k=3):
            got, want, je, te = _both(pair, script, block_size=4,
                                      pool_blocks=32, draft=draft_pair)
        assert got == want
        # a different 1-layer model drafts: rollback must really run
        assert te.spec_accepted_total < te.spec_proposed_total
        _same_counters(je, te)

    def test_speculative_with_sharing_and_chunked_prefill(self, pair,
                                                          draft_pair):
        shared = list(range(1, 15))

        def script(eng):
            out = {}
            eng.add_request(shared + [20, 21], max_new_tokens=8)
            for _ in range(3):
                for ev in eng.step():
                    if ev["type"] == "token":
                        out.setdefault(ev["seq_id"], []).append(
                            ev["token"])
            eng.add_request(shared + [30], max_new_tokens=8)
            return _run(eng, out)
        with both_flags(kv_prefix_sharing=True, prefill_chunk_tokens=8,
                        speculative_k=2):
            got, want, je, te = _both(pair, script, block_size=4,
                                      pool_blocks=32, draft=draft_pair)
        assert got == want
        _same_counters(je, te)


class TestPortInvariants:
    @pytest.fixture(scope="class")
    def model(self):
        return GPTLanguageModel(device="cpu", seed=3)

    def _tokens(self, model, k, seed, draft=None, temperature=0.8):
        ptt.set_flags({"speculative_k": k})
        try:
            eng = LLMEngine(model, block_size=4, pool_blocks=16,
                            draft_model=draft, device="cpu")
            sid = eng.add_request([5, 9], max_new_tokens=6,
                                  temperature=temperature, seed=seed)
            out, _ = _run(eng)
            assert eng.allocator.num_used == 0
            return out[sid], eng
        finally:
            ptt.set_flags({"speculative_k": 0})

    def test_temperature_sampling_deterministic_and_spec_exact(self, model):
        plain, _ = self._tokens(model, 0, seed=11)
        assert self._tokens(model, 0, seed=11)[0] == plain
        spec, eng = self._tokens(model, 3, seed=11, draft=model)
        assert spec == plain
        assert eng.spec_accepted_total == eng.spec_proposed_total > 0
        others = {tuple(self._tokens(model, 0, seed=s)[0])
                  for s in range(12, 16)}
        assert len(others | {tuple(plain)}) > 1   # the seed matters

    def test_sampler_noise_is_position_keyed_and_draws_softmax(self):
        keys = [(7, i) for i in range(4000)]
        noise = sampling_noise(keys, 4, "cpu")
        # a row depends on its key alone, not on the batch around it
        assert torch.equal(sampling_noise([keys[9], keys[5]], 4, "cpu")[1],
                           noise[5])
        logits, t = torch.tensor([1.0, 0.0, -1.0, 0.5]), 0.8
        draws = torch.argmax(logits / t + noise, dim=-1)
        freq = torch.bincount(draws, minlength=4).float() / len(keys)
        # binomial standard error at n = 4000 is <= 0.008
        assert float((freq - torch.softmax(logits / t, -1)).abs().max()) \
            < 0.03

    def test_sample_offset_resumes_the_stream(self, model):
        full, _ = self._tokens(model, 0, seed=4)
        eng = LLMEngine(model, block_size=4, pool_blocks=16, device="cpu")
        sid = eng.add_request([5, 9] + full[:2], max_new_tokens=4,
                              temperature=0.8, seed=4, sample_offset=2)
        out, _ = _run(eng)
        assert out[sid] == full[2:]

    def test_admission_watermark_and_health(self, model):
        ptt.set_flags({"kv_admission_watermark": 0.5})
        try:
            eng = LLMEngine(model, block_size=4, pool_blocks=8,
                            device="cpu")
            eng.add_request([1] * 7, max_new_tokens=5)     # 3 blocks
            with pytest.raises(AdmissionRejected) as ei:
                eng.add_request([2] * 7, max_new_tokens=5)
            assert ei.value.retry_after_ms > 0
            assert "retry_after_ms=" in str(ei.value)
        finally:
            ptt.set_flags({"kv_admission_watermark": 0.0})
        _run(eng)
        h = eng.health()
        assert h["kv_blocks_used"] == 0 and not h["stalled"]
        assert h["speculative"]["accept_rate"] is None
        assert eng.admission_rejected_total == 1

    def test_never_fits_is_an_error_event_and_cancel_frees(self, model):
        eng = LLMEngine(model, block_size=4, pool_blocks=2, device="cpu")
        sid = eng.add_request([1] * 7, max_new_tokens=8)
        errors = [ev for _ in range(20) if eng.active()
                  for ev in eng.step() if ev["type"] == "error"]
        assert [e["seq_id"] for e in errors] == [sid]
        assert "pool" in errors[0]["error"]
        eng = LLMEngine(model, block_size=4, pool_blocks=8, device="cpu")
        sid = eng.add_request([1] * 9, max_new_tokens=50)
        eng.step()
        assert eng.allocator.num_used > 0
        assert eng.cancel(sid) and not eng.cancel(sid)
        assert eng.allocator.num_used == 0 and not eng.active()

    def test_engine_refuses_the_cpu_unasked(self, model):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is usable")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LLMEngine(model)

    def test_allocator_matches_shadow_model(self):
        # random alloc/extend/truncate/free against a shadow LIFO stack,
        # full-state agreement and check() after every op
        nb, bs = 16, 4
        rng = random.Random(0)
        a = KVBlockAllocator(num_blocks=nb, block_size=bs)
        stack = list(range(nb - 1, -1, -1))
        tables, toks = {}, {}
        for _ in range(300):
            op = rng.choice(("alloc", "extend", "free", "truncate"))
            if op == "alloc":
                sid, n = rng.randrange(24), rng.randrange(0, 5 * bs)
                if sid in tables:
                    with pytest.raises(ValueError):
                        a.allocate(sid, n)
                    continue
                need = -(-n // bs)
                assert a.allocate(sid, n) == (need <= len(stack))
                if need <= len(stack):
                    tables[sid] = [stack.pop() for _ in range(need)]
                    toks[sid] = n
            elif op == "extend" and tables:
                sid = rng.choice(sorted(tables))
                n = toks[sid] + rng.randrange(-bs, 2 * bs)
                ok = a.extend_to(sid, n)
                if n <= toks[sid]:
                    assert ok
                    continue
                need = -(-n // bs) - len(tables[sid])
                assert ok == (need <= len(stack))
                if ok:
                    tables[sid] += [stack.pop() for _ in range(need)]
                    toks[sid] = n
            elif op == "truncate" and tables:
                sid = rng.choice(sorted(tables))
                n = max(0, rng.randrange(-2, toks[sid] + bs))
                got = a.truncate_to(sid, n)
                if n >= toks[sid]:
                    assert got == 0
                    continue
                keep = -(-n // bs)
                dropped = tables[sid][keep:]
                del tables[sid][keep:]
                toks[sid] = n
                assert got == len(dropped)
                stack.extend(reversed(dropped))
            elif op == "free":
                sid = rng.choice(sorted(tables)) if tables \
                    else rng.randrange(24)
                blocks = tables.pop(sid, [])
                toks.pop(sid, None)
                assert a.free(sid) == len(blocks)
                stack.extend(reversed(blocks))
            for sid, t in tables.items():
                assert a.table(sid) == t and a.tokens(sid) == toks[sid]
            assert a.num_free == len(stack)
            a.check()
            assert a.gauges_agree() is None
