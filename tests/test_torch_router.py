"""PyTorch port: the front-door router (``serving_llm.router``).

The circuit breaker and backend pool unit tests of
``tests/test_serving_router.py`` run as one body over both packages'
classes (an injected clock, scripted probes). ``StreamInterrupted``'s
resume substrate runs for both packages' clients against a scripted
wire peer. Then the port's router over port backends on the CPU (a
small GPT, servers on 127.0.0.1:0): mid-stream failover bit for bit at
temperature 0 and 0.8, saturation shed with the largest hint, a dead
backend as a counted retry, STATS through the router, a tensor request
proxied, and prefix affinity with the same tokens as a direct run.
"""

import contextlib
import socket
import struct
import threading
import time
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import paddle_tpu as pt  # noqa: E402
from paddle_tpu import inference as jinf  # noqa: E402
from paddle_tpu.serving_llm import router as jrouter  # noqa: E402

import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu_torch import inference as pinf  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTLanguageModel  # noqa: E402
from paddle_tpu_torch.serving_llm import (LLMEngine,  # noqa: E402
                                          router as prouter)

SMALL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=256, max_position_embeddings=256)
WAIT_S = 30.0


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    """One package's router classes, Server and flag setter."""
    if request.param == "jax":
        return types.SimpleNamespace(
            CircuitBreaker=jrouter.CircuitBreaker, Backend=jrouter.Backend,
            BackendPool=jrouter.BackendPool, Server=jinf.Server,
            set_flags=pt.set_flags)
    return types.SimpleNamespace(
        CircuitBreaker=prouter.CircuitBreaker, Backend=prouter.Backend,
        BackendPool=prouter.BackendPool, Server=pinf.Server,
        set_flags=ptt.set_flags)


class FakeClock:
    """Injectable monotonic clock: tests advance time, never sleep."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# ---------------------------------------------------------------------------
# circuit breaker (pure unit, fake clock), both packages
# ---------------------------------------------------------------------------

def _cb(pkg, **kw):
    clk = FakeClock()
    kw.setdefault("threshold", 3)
    kw.setdefault("backoff_s", 10.0)
    kw.setdefault("backoff_max_s", 25.0)
    return pkg.CircuitBreaker(clock=clk, **kw), clk


def _trip(cb, n=3):
    for _ in range(n):
        cb.record_failure()


def test_breaker_trips_only_after_consecutive_threshold(pkg):
    cb, _ = _cb(pkg)
    _trip(cb, 2)
    assert cb.state == "closed" and cb.allow()
    cb.record_failure()
    assert cb.state == "open" and not cb.allow()
    assert cb.opened_total == 1


def test_breaker_success_resets_the_consecutive_count(pkg):
    cb, _ = _cb(pkg)
    _trip(cb, 2)
    cb.record_success()
    _trip(cb, 2)
    assert cb.state == "closed" and cb.failures == 2


def test_breaker_open_fast_fails_until_the_backoff_elapses(pkg):
    cb, clk = _cb(pkg)
    _trip(cb)
    clk.advance(9.9)
    assert cb.state == "open" and not cb.allow()
    clk.advance(0.2)
    assert cb.state == "half_open"


def test_breaker_half_open_admits_exactly_one_probe(pkg):
    cb, clk = _cb(pkg)
    _trip(cb)
    clk.advance(10.0)
    assert cb.allow()
    assert not cb.allow()
    assert cb.state == "half_open"


def test_breaker_probe_success_closes_and_resets(pkg):
    cb, clk = _cb(pkg)
    _trip(cb)
    clk.advance(10.0)
    assert cb.allow()
    cb.record_success()
    assert cb.state == "closed" and cb.failures == 0
    assert cb.allow() and cb.allow()


def test_breaker_probe_failure_doubles_backoff_up_to_the_cap(pkg):
    cb, clk = _cb(pkg)
    _trip(cb)
    assert cb.snapshot()["backoff_s"] == 10.0
    clk.advance(10.0)
    assert cb.allow()
    cb.record_failure()
    assert cb.snapshot()["backoff_s"] == 20.0
    clk.advance(15.0)
    assert not cb.allow()
    clk.advance(5.0)
    assert cb.allow()
    cb.record_failure()
    assert cb.snapshot()["backoff_s"] == 25.0
    assert cb.opened_total == 3


def test_breaker_failure_while_open_does_not_extend_the_backoff(pkg):
    cb, clk = _cb(pkg)
    _trip(cb, 4)
    clk.advance(10.0)
    assert cb.state == "half_open"


def test_breaker_defaults_come_from_flags_lazily(pkg):
    pkg.set_flags({"router_breaker_threshold": 2})
    try:
        cb = pkg.CircuitBreaker(clock=FakeClock())
        cb.record_failure()
        assert cb.state == "closed"
        cb.record_failure()
        assert cb.state == "open"
    finally:
        pkg.set_flags({"router_breaker_threshold": 3})


# ---------------------------------------------------------------------------
# backend pool: scripted probes, drain against death, both packages
# ---------------------------------------------------------------------------

def test_pool_drain_flag_is_draining_not_open(pkg):
    b = pkg.Backend("127.0.0.1", 1)
    answers = {"stats": {"serving.draining": 1}}
    pool = pkg.BackendPool([b], probe=lambda _b: answers)
    pool.probe_once()
    assert b.state() == "draining" and not b.in_rotation()
    assert b.breaker.state == "closed"
    assert b.breaker.snapshot()["opened_total"] == 0
    answers["stats"] = {"serving.draining": 0}
    pool.probe_once()
    assert b.state() == "closed" and b.in_rotation()


def test_pool_dead_probe_is_breaker_food(pkg):
    def probe(_b):
        raise ConnectionError("connection refused")
    b = pkg.Backend("127.0.0.1", 1, breaker=pkg.CircuitBreaker(
        threshold=3, backoff_s=60.0, clock=FakeClock()))
    pool = pkg.BackendPool([b], probe=probe)
    pool.probe_once()
    pool.probe_once()
    assert b.state() == "closed"
    pool.probe_once()
    assert b.state() == "open"
    assert pool.pick() is None
    assert "connection refused" in b.snapshot()["last_error"]


def test_pool_open_breaker_gates_probes_until_backoff(pkg):
    calls = []

    def probe(_b):
        calls.append(1)
        raise ConnectionError("down")
    clk = FakeClock()
    b = pkg.Backend("127.0.0.1", 1, breaker=pkg.CircuitBreaker(
        threshold=1, backoff_s=30.0, clock=clk))
    pool = pkg.BackendPool([b], probe=probe)
    pool.probe_once()
    assert b.state() == "open" and len(calls) == 1
    pool.probe_once()
    assert len(calls) == 1
    clk.advance(30.0)
    pool.probe_once()
    assert len(calls) == 2


def test_pool_half_open_probe_success_recovers_the_backend(pkg):
    state = {"up": False}

    def probe(_b):
        if not state["up"]:
            raise ConnectionError("down")
        return {"stats": {}}
    clk = FakeClock()
    b = pkg.Backend("127.0.0.1", 1, breaker=pkg.CircuitBreaker(
        threshold=1, backoff_s=5.0, clock=clk))
    pool = pkg.BackendPool([b], probe=probe)
    pool.probe_once()
    assert b.state() == "open"
    state["up"] = True
    clk.advance(5.0)
    pool.probe_once()
    assert b.state() == "closed" and b.in_rotation()
    assert b.breaker.failures == 0


def test_pool_healthz_codes_map_to_states(pkg):
    answers = {"stats": {}, "healthz": 200}
    b = pkg.Backend("127.0.0.1", 1, healthz=("127.0.0.1", 2))
    pool = pkg.BackendPool([b], probe=lambda _b: answers)
    pool.probe_once()
    assert b.state() == "closed"
    answers["healthz"] = 503
    pool.probe_once()
    assert b.state() == "draining"
    answers["healthz"] = 500
    pool.probe_once()
    assert b.state() == "unhealthy"


def test_pool_breaker_state_wins_over_stale_drain_flag(pkg):
    b = pkg.Backend("127.0.0.1", 1, breaker=pkg.CircuitBreaker(
        threshold=1, backoff_s=60.0, clock=FakeClock()))
    b.set_health(draining=True, unhealthy=False)
    assert b.state() == "draining"
    b.breaker.record_failure()
    assert b.state() == "open"


def test_pool_pick_round_robins_and_skips_burned(pkg):
    bs = [pkg.Backend("127.0.0.1", p) for p in (1, 2, 3)]
    pool = pkg.BackendPool(bs, probe=lambda _b: {"stats": {}})
    bs[1].mark_draining()
    first, second = pool.pick(), pool.pick()
    assert {first.port, second.port} == {1, 3}
    assert pool.pick(exclude=[bs[0]]).port == 3
    assert pool.pick(exclude=[bs[0], bs[2]]) is None
    assert pool.available() == 2


def test_pool_fresh_server_clears_stale_drain_flag(pkg):
    old = pkg.Server(None)
    old.drain(deadline_s=0.1, wait=True)
    old.stop()
    srv = pkg.Server(None)
    try:
        b = pkg.Backend("127.0.0.1", srv.port)
        pkg.BackendPool([b]).probe_once()   # the default probe: STATS
        assert b.state() == "closed", b.snapshot()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# StreamInterrupted carries the resume substrate (scripted peer), both
# packages' clients
# ---------------------------------------------------------------------------

_REQ_HDR = struct.Struct("<IQI")
_REPLY_HDR = struct.Struct("<QqI")


class _ScriptedPeer:
    """A one-connection wire peer: reads one request, plays back token
    chunks, then ``close``s, ends cleanly (``close_clean``), ``hang``s
    silent, or refuses with an admission hint (``refuse=<ms>``)."""

    def __init__(self, chunks, final="close"):
        self._chunks = list(chunks)
        self._final = final
        self._done = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(1)
        self.port = self._sock.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        try:
            conn, _ = self._sock.accept()
        except OSError:
            return
        try:
            hdr = b""
            while len(hdr) < _REQ_HDR.size:
                hdr += conn.recv(_REQ_HDR.size - len(hdr))
            _magic, tag, n = _REQ_HDR.unpack(hdr)
            body = b""
            while len(body) < n:
                body += conn.recv(n - len(body))
            for tok in self._chunks:
                payload = pinf.encode_tensors([np.asarray([tok], np.int32)])
                conn.sendall(_REPLY_HDR.pack(tag, 1, len(payload))
                             + payload)
            if self._final.startswith("refuse="):
                payload = (f"admission rejected: queue full: retry_after_"
                           f"ms={self._final[7:]}").encode()
                conn.sendall(_REPLY_HDR.pack(tag, -1, len(payload))
                             + payload)
            elif self._final == "close_clean":
                conn.sendall(_REPLY_HDR.pack(tag, 0, 0))
            if self._final != "close":
                self._done.wait(WAIT_S)
            conn.close()
        finally:
            self._sock.close()

    def stop(self):
        self._done.set()
        try:
            # wakes an accept() nobody came to
            socket.create_connection(("127.0.0.1", self.port),
                                     timeout=1).close()
        except OSError:
            pass
        self._thread.join(timeout=5.0)


@pytest.fixture(params=["jax", "port"])
def inf(request):
    return jinf if request.param == "jax" else pinf


def test_connection_lost_carries_delivered_tokens(inf):
    peer = _ScriptedPeer([7, 8], final="close")
    cli = inf.Client(port=peer.port, timeout_s=10.0, max_reconnects=0,
                     traced=False)
    try:
        seen = []
        with pytest.raises(inf.StreamConnectionLost) as ei:
            for ch in cli.generate_stream([1, 2], max_new_tokens=5):
                seen.extend(int(t) for t in np.asarray(ch).ravel())
        e = ei.value
        assert seen == [7, 8] and e.delivered_tokens == [7, 8]
        assert e.partial().dtype == np.int32
        assert np.array_equal(e.partial(), np.asarray([7, 8], np.int32))
        assert isinstance(e, ConnectionError)
        assert isinstance(e, inf.StreamInterrupted)
    finally:
        cli.close()
        peer.stop()


def test_stream_timeout_carries_delivered_tokens(inf):
    peer = _ScriptedPeer([4], final="hang")
    cli = inf.Client(port=peer.port, timeout_s=10.0, max_reconnects=0,
                     traced=False)
    try:
        with pytest.raises(inf.StreamTimeout) as ei:
            for _ch in cli.generate_stream([1], max_new_tokens=5,
                                           deadline_s=0.3):
                pass
        assert ei.value.delivered_tokens == [4]
        assert isinstance(ei.value, TimeoutError)
        assert "after 1 token(s)" in str(ei.value)
    finally:
        cli.close()
        peer.stop()


def test_zero_token_interrupt_has_empty_partial(inf):
    peer = _ScriptedPeer([], final="close")
    cli = inf.Client(port=peer.port, timeout_s=10.0, max_reconnects=0,
                     traced=False)
    try:
        with pytest.raises(inf.StreamConnectionLost) as ei:
            list(cli.generate_stream([1], max_new_tokens=5))
        assert ei.value.delivered_tokens == []
        assert ei.value.partial().shape == (0,)
    finally:
        cli.close()
        peer.stop()


# ---------------------------------------------------------------------------
# the port's router over port backends
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    return GPTLanguageModel(GPTConfig(**SMALL), device="cpu", seed=3)


def _tokens(chunks):
    return [int(t) for ch in chunks for t in np.asarray(ch).ravel()]


def _direct(model, prompt, **kw):
    """The uninterrupted in-process run of one request."""
    eng = LLMEngine(model, block_size=4, pool_blocks=32, device="cpu")
    sid = eng.add_request(prompt, **kw)
    out = []
    while eng.active():
        out += [e["token"] for e in eng.step()
                if e["type"] == "token" and e["seq_id"] == sid]
    return out


@contextlib.contextmanager
def fleet(model, n=2, paced_s=0.0, **router_kw):
    """``n`` port backends on 127.0.0.1:0 (each engine step sleeping
    ``paced_s`` first) behind a started port Router; everything stopped
    after."""
    ptt.set_flags({"router_retry_backoff_s": 0.0})
    backends = []
    router = None
    try:
        for _ in range(n):
            eng = LLMEngine(model, block_size=4, pool_blocks=32,
                            device="cpu")
            if paced_s:
                step = eng.step

                def paced(step=step):
                    time.sleep(paced_s)
                    return step()
                eng.step = paced
            backends.append((pinf.Server(None, llm_engine=eng), eng))
        router = prouter.Router([("127.0.0.1", s.port) for s, _ in backends],
                                **router_kw).start()
        yield router, backends
    finally:
        if router is not None:
            router.stop()
        for srv, _ in backends:
            srv.stop()
        ptt.set_flags({"router_retry_backoff_s": 0.05})


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_midstream_failover_is_bit_for_bit(model, temp):
    """Stop the backend serving a stream after two delivered chunks: the
    client's sequence equals the uninterrupted run's, greedy and sampled
    (position-keyed sampling + the sample offset)."""
    prompt = [5, 9, 2, 7]
    kw = dict(max_new_tokens=10, temperature=temp, seed=3)
    ref = _direct(model, prompt, **kw)
    with fleet(model, paced_s=0.05, probe_interval_s=0.2) as (router, bes):
        got = []
        with pinf.Client(port=router.port, timeout_s=WAIT_S,
                         deadline_s=WAIT_S) as cli:
            for i, ch in enumerate(cli.generate_stream(prompt, **kw)):
                got.extend(int(t) for t in np.asarray(ch).ravel())
                if i == 1:
                    busy = [b for b in router.snapshot()["backends"]
                            if b["streams_active"] > 0]
                    assert len(busy) == 1
                    port = int(busy[0]["name"].rsplit(":", 1)[1])
                    next(s for s, _ in bes if s.port == port).stop()
        snap = router.snapshot()
        deadline = time.monotonic() + WAIT_S
        while any(e.allocator.num_used for _, e in bes) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert all(e.allocator.num_used == 0 for _, e in bes)
    assert got == ref and len(ref) == 10
    assert snap["failovers_total"] == 1, snap
    assert snap["retries_total"] == 0 and snap["shed_total"] == 0, snap


def test_stats_through_the_router_door(model):
    with fleet(model, probe_interval_s=0.2) as (router, _):
        with pinf.Client(port=router.port) as cli:
            st = cli.stats()
        with jinf.Client(port=router.port) as jcli:
            assert jcli.stats()["router.backends"] == 2
    assert st["router.proto_version"] == 1
    assert st["router.backends"] == 2 and st["router.available"] == 2
    assert st["router.backend.0.state"] == 0
    assert all(isinstance(v, int) for v in st.values())


def test_plain_generate_and_a_tensor_request_proxy(model):
    with fleet(model, probe_interval_s=0.2) as (router, _):
        with pinf.Client(port=router.port, timeout_s=WAIT_S,
                         deadline_s=WAIT_S) as cli:
            out = cli.generate([3, 1, 4], max_new_tokens=6)
            # the backends are LLM-only: their error comes back verbatim
            with pytest.raises(RuntimeError, match="no predictor"):
                cli.infer([np.zeros((1, 2), np.float32)])
        snap = router.snapshot()
    assert out.tolist() == _direct(model, [3, 1, 4], max_new_tokens=6)
    assert snap["failovers_total"] == 0 and snap["streams_total"] == 1
    assert snap["proxied_total"] == 1


def test_all_saturated_sheds_with_the_max_hint():
    """Every backend refuses with an admission hint: the router sheds at
    the door with the largest hint, and saturation is no failure (no
    breaker trips, no retries)."""
    peers = [_ScriptedPeer([], final="refuse=75"),
             _ScriptedPeer([], final="refuse=120")]
    router = prouter.Router([("127.0.0.1", p.port) for p in peers],
                            start_probes=False).start()
    try:
        with pinf.Client(port=router.port, timeout_s=10.0) as cli:
            with pytest.raises(RuntimeError) as ei:
                list(cli.generate_stream([1, 2], max_new_tokens=4))
        assert "all backends saturated" in str(ei.value)
        assert "retry_after_ms=120" in str(ei.value)
        snap = router.snapshot()
        assert snap["shed_total"] == 1, snap
        assert snap["retries_total"] == 0 and snap["failovers_total"] == 0
        assert all(b["breaker"]["opened_total"] == 0
                   for b in snap["backends"]), snap
    finally:
        router.stop()
        for p in peers:
            p.stop()


def test_dead_backend_is_a_counted_retry_not_a_shed():
    dead = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    dead.bind(("127.0.0.1", 0))
    dead_port = dead.getsockname()[1]
    dead.close()                       # nothing listens there now
    peer = _ScriptedPeer([6], final="close_clean")
    router = prouter.Router([("127.0.0.1", dead_port),
                             ("127.0.0.1", peer.port)],
                            start_probes=False).start()
    ptt.set_flags({"router_retry_backoff_s": 0.0})
    try:
        with pinf.Client(port=router.port, timeout_s=10.0) as cli:
            assert _tokens(cli.generate_stream([1], max_new_tokens=1)) \
                == [6]
        snap = router.snapshot()
        assert snap["retries_total"] == 1 and snap["failovers_total"] == 0
        assert snap["backends"][0]["breaker"]["failures"] == 1
    finally:
        ptt.set_flags({"router_retry_backoff_s": 0.05})
        router.stop()
        peer.stop()


PREFIX = [5, 9, 2, 7, 3, 1, 4, 6]        # two full 4-token blocks


def _wave(model, affinity):
    """Four shared-prefix streams through a 2-backend router, each held
    mid-flight (paced decode) until the next has its first chunk.
    Returns ({prompt: tokens}, prefix-hit tokens of both engines)."""
    ptt.set_flags({"kv_prefix_sharing": True, "kv_block_size": 4,
                   "router_prefix_affinity": affinity})
    prompts = [PREFIX + [10 + i] for i in range(4)]
    outs = {}
    try:
        with fleet(model, paced_s=0.05, start_probes=False) as (router,
                                                                 bes):
            clis = [pinf.Client(port=router.port, timeout_s=WAIT_S,
                                deadline_s=WAIT_S) for _ in prompts]
            try:
                gens = []
                for cli, p in zip(clis, prompts):
                    g = cli.generate_stream(p, max_new_tokens=6)
                    gens.append((p, _tokens([next(g)]), g))
                for p, got, g in gens:
                    outs[tuple(p)] = got + _tokens(g)
            finally:
                for cli in clis:
                    cli.close()
            hits = sum(e.allocator.prefix_hit_tokens_total for _, e in bes)
    finally:
        ptt.set_flags({"kv_prefix_sharing": False, "kv_block_size": 16,
                       "router_prefix_affinity": False})
    return outs, hits


def test_prefix_affinity_beats_round_robin_with_the_same_tokens(model):
    rr_outs, rr_hits = _wave(model, affinity=False)
    aff_outs, aff_hits = _wave(model, affinity=True)
    # round-robin splits the four over both backends; affinity lands
    # every stream on the one holding the prefix
    assert aff_hits > rr_hits, (aff_hits, rr_hits)
    for p, got in aff_outs.items():
        ref = _direct(model, list(p), max_new_tokens=6)
        assert got == ref and rr_outs[p] == ref
