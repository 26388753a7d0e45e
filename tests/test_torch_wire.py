"""PyTorch port: the serving wire (codec, ``inference.Server``/``Client``,
``LLMStreamBridge``) against the JAX package's, and its native build.

The codec's bytes are the JAX package's for every dtype; a port server
answers port and JAX clients, a JAX server answers a port client, and
the greedy tokens over the wire equal the JAX engine's (its paged kernel
in interpret mode) on the same weights (a small GPT: 2 layers, width 64,
vocab 128, the JAX model's weights moved into the port). Then the
bridge's behaviours of ``tests/test_serving_llm.py`` on a port server on
the CPU, the engine's two names the bridge calls, and the native
library's build: two processes at once, nothing written into the JAX
package.
"""

import contextlib
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
ml_dtypes = pytest.importorskip("ml_dtypes")

import paddle_tpu as pt  # noqa: E402
from paddle_tpu import inference as jinf  # noqa: E402
from paddle_tpu.models.gpt_lm import GPTConfig as JaxConfig  # noqa: E402
from paddle_tpu.models.gpt_lm import GPTLanguageModel as JaxGPT  # noqa: E402
from paddle_tpu.serving_llm import LLMEngine as JaxEngine  # noqa: E402

import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu_torch import inference as pinf, native  # noqa: E402
from paddle_tpu_torch.convert import load_jax_params  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTLanguageModel  # noqa: E402
from paddle_tpu_torch.serving_llm import (LLMEngine,  # noqa: E402
                                          LLMStreamBridge)

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=256, max_position_embeddings=256)
SEED = 7
WAIT_S = 30.0


@pytest.fixture(scope="module")
def pair():
    """The JAX GPT from SEED and the port GPT holding its weights."""
    pt.seed(SEED)
    jm = JaxGPT(JaxConfig(**SMALL))
    pm = load_jax_params(GPTLanguageModel(GPTConfig(**SMALL), device="cpu"),
                         {k: np.asarray(v)
                          for k, v in jm.param_dict().items()})
    return jm, pm


@contextlib.contextmanager
def port_server(model, paced_s=0.0, **engine_kw):
    """A port Server on 127.0.0.1:0 over a fresh CPU engine; each engine
    step sleeps ``paced_s`` first (keeps a stream mid-flight)."""
    engine_kw.setdefault("block_size", 4)
    engine_kw.setdefault("pool_blocks", 32)
    eng = LLMEngine(model, device="cpu", **engine_kw)
    if paced_s:
        step = eng.step

        def paced():
            time.sleep(paced_s)
            return step()
        eng.step = paced
    srv = pinf.Server(None, llm_engine=eng)
    try:
        yield srv, eng
    finally:
        srv.stop()


@contextlib.contextmanager
def jax_server(jax_model):
    """A JAX Server on 127.0.0.1:0 over a fresh JAX engine."""
    eng = JaxEngine(jax_model, block_size=4, pool_blocks=32)
    srv = jinf.Server(None, llm_engine=eng)
    try:
        yield srv, eng
    finally:
        srv.stop()


def _tokens(chunks):
    return [int(t) for ch in chunks for t in np.asarray(ch).ravel()]


def _jax_engine_tokens(jm, prompt, max_new):
    eng = JaxEngine(jm, block_size=4, pool_blocks=32)
    sid = eng.add_request(prompt, max_new_tokens=max_new)
    out = []
    while eng.active():
        for ev in eng.step():
            assert ev["type"] in ("token", "finished"), ev
            if ev["type"] == "token" and ev["seq_id"] == sid:
                out.append(ev["token"])
    return out


def _wait_for(cond, timeout_s=WAIT_S):
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.01)


# ---------------------------------------------------------------------------
# the tensor codec, byte for byte
# ---------------------------------------------------------------------------

_CODEC_CASES = [np.arange(6, dtype=np.float32).reshape(2, 3),
                np.arange(5, dtype=np.float64),
                np.array([-3, 0, 7], np.int32),
                np.array(11, np.int64),                      # 0-d
                np.zeros((0, 4), np.uint8),                  # empty
                np.array([[True], [False]]),
                np.arange(4, dtype=np.float32).astype(ml_dtypes.bfloat16),
                np.linspace(-1, 1, 7).astype(np.float16),
                np.array([-128, 5, 127], np.int8),
                np.array([2 ** 32 - 1, 0], np.uint32),
                np.array([2 ** 64 - 1, 1], np.uint64),
                np.array([-2 ** 15, 2 ** 15 - 1], np.int16)]


@pytest.mark.parametrize("arr", _CODEC_CASES,
                         ids=[f"{a.dtype}-{a.ndim}d" for a in _CODEC_CASES])
def test_codec_bytes_equal_jax_and_cross_decode(arr):
    want = jinf.encode_tensors([arr, arr])
    assert pinf.encode_tensors([arr, arr]) == want
    for got in pinf.decode_tensors(want) + jinf.decode_tensors(
            pinf.encode_tensors([arr])):
        if isinstance(got, torch.Tensor):            # bf16 in the port
            assert got.dtype == torch.bfloat16
            got = got.view(torch.int16).numpy()
            ref = arr.view(np.int16)
        else:
            ref = arr
            assert got.dtype == ref.dtype
        assert got.shape == ref.shape and np.array_equal(got, ref)


def test_codec_takes_tensors_as_their_arrays():
    bits = np.arange(6, dtype=np.float32).astype(ml_dtypes.bfloat16)
    t_bf16 = torch.from_numpy(bits.view(np.int16).copy()).view(
        torch.bfloat16).reshape(2, 3)
    t_f32 = torch.arange(4, dtype=torch.float32)
    assert pinf.encode_tensors([t_bf16, t_f32]) == jinf.encode_tensors(
        [bits.reshape(2, 3), np.arange(4, dtype=np.float32)])


# ---------------------------------------------------------------------------
# the engine's names the bridge calls: add_request(trace_id=), cancel(outcome=)
# ---------------------------------------------------------------------------

def test_add_request_trace_id_parity(pair):
    jm, pm = pair
    tokens = []
    for eng in (JaxEngine(jm, block_size=4, pool_blocks=32),
                LLMEngine(pm, block_size=4, pool_blocks=32, device="cpu")):
        sid = eng.add_request([5, 9, 2], max_new_tokens=4, trace_id=77)
        assert eng.scheduler.waiting[0].seq_id == sid
        out = []
        while eng.active():
            out += [e["token"] for e in eng.step() if e["type"] == "token"]
        tokens.append(out)
    assert tokens[0] == tokens[1] and len(tokens[1]) == 4
    port = LLMEngine(pm, block_size=4, pool_blocks=32, device="cpu")
    port.add_request([1, 2], max_new_tokens=2, trace_id=123)
    assert port.scheduler.waiting[0].trace_id == 123


@pytest.mark.parametrize("outcome", ["cancelled", "shed"])
def test_cancel_with_outcome_parity(pair, outcome):
    jm, pm = pair
    for eng in (JaxEngine(jm, block_size=4, pool_blocks=32),
                LLMEngine(pm, block_size=4, pool_blocks=32, device="cpu")):
        sid = eng.add_request([3] * 9, max_new_tokens=8)
        eng.step()                                   # prefilled, holding KV
        assert eng.allocator.num_used > 0
        assert eng.cancel(sid, outcome=outcome) is True
        assert eng.cancel(sid, outcome=outcome) is False
        assert eng.allocator.num_used == 0 and not eng.active()


# ---------------------------------------------------------------------------
# the wire across the packages
# ---------------------------------------------------------------------------

PROMPT, MAX_NEW = [5, 9, 2, 7, 1], 6


@pytest.fixture(scope="module")
def jax_tokens(pair):
    return _jax_engine_tokens(pair[0], PROMPT, MAX_NEW)


@pytest.mark.parametrize("client", ["port", "jax"])
def test_port_server_streams_the_jax_engines_tokens(pair, jax_tokens,
                                                    client):
    cls = pinf.Client if client == "port" else jinf.Client
    with port_server(pair[1]) as (srv, eng):
        with cls(port=srv.port, timeout_s=WAIT_S) as cli:
            chunks = list(cli.generate_stream(PROMPT,
                                              max_new_tokens=MAX_NEW))
            assert all(c.dtype == np.int32 and c.shape == (1,)
                       for c in chunks)
            assert _tokens(chunks) == jax_tokens
            assert cli.generate(PROMPT, max_new_tokens=MAX_NEW).tolist() \
                == jax_tokens
        assert eng.allocator.num_used == 0


def test_jax_server_answers_a_port_client(pair, jax_tokens):
    srv = jinf.Server(None, llm_engine=JaxEngine(pair[0], block_size=4,
                                                 pool_blocks=32))
    try:
        with pinf.Client(port=srv.port, timeout_s=WAIT_S) as cli:
            assert _tokens(cli.generate_stream(
                PROMPT, max_new_tokens=MAX_NEW)) == jax_tokens
            assert cli.stats()["stream_total"] >= 1
            with pytest.raises(RuntimeError, match="no predictor"):
                cli.infer([np.zeros((1, 2), np.float32)])
    finally:
        srv.stop()


@pytest.mark.parametrize("client", ["port", "jax"])
def test_tensor_request_to_llm_only_server_is_an_error_reply(pair, client):
    cls = pinf.Client if client == "port" else jinf.Client
    with port_server(pair[1]) as (srv, _):
        with cls(port=srv.port, timeout_s=WAIT_S) as cli:
            with pytest.raises(RuntimeError, match="no predictor"):
                cli.infer([np.zeros((1, 2), np.float32)])
            # the connection still serves
            assert len(cli.generate([1, 2], max_new_tokens=2)) == 2


def test_server_with_a_predictor_serves(tmp_path):
    """A server takes a Predictor and answers tensor requests from it
    (tests/test_torch_inference.py covers the batching and errors)."""
    from paddle_tpu_torch import jit
    net = torch.nn.Linear(4, 2).eval()
    jit.save(net, str(tmp_path), input_spec=[jit.InputSpec([None, 4])])
    pred = pinf.create_predictor(pinf.Config(str(tmp_path), device="cpu"))
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    with pinf.Server(pred) as srv:
        with pinf.Client(port=srv.port, timeout_s=WAIT_S) as cli:
            got = cli.infer([x])[0]
    with torch.no_grad():
        np.testing.assert_array_equal(got, net(torch.from_numpy(x)).numpy())


# ---------------------------------------------------------------------------
# bridge behaviours on a port server
# ---------------------------------------------------------------------------

def test_tenant_descriptor_reaches_the_engine(pair):
    with port_server(pair[1]) as (srv, eng):
        seen = []
        add = eng.add_request

        def recording(*a, **kw):
            seen.append((kw["tenant"], kw["priority_class"],
                         kw["trace_id"]))
            return add(*a, **kw)
        eng.add_request = recording
        with pinf.Client(port=srv.port, timeout_s=WAIT_S) as cli:
            plain = cli.generate(PROMPT, max_new_tokens=4)
            tagged = cli.generate(PROMPT, max_new_tokens=4, tenant="acme",
                                  priority_class="premium")
            tid = cli.last_trace_id
        assert plain.tolist() == tagged.tolist()
        assert seen[0][:2] == ("default", "standard")
        assert seen[1] == ("acme", "premium", tid)


def test_admission_rejection_ships_its_retry_hint(pair):
    ptt.set_flags({"kv_admission_watermark": 0.5})
    try:
        with port_server(pair[1], paced_s=0.02, pool_blocks=8) as (srv,
                                                                   eng):
            with pinf.Client(port=srv.port, timeout_s=WAIT_S) as a, \
                    pinf.Client(port=srv.port, timeout_s=WAIT_S) as b:
                gen = a.generate_stream([1] * 8, max_new_tokens=8)
                next(gen)                    # 4 of 8 blocks projected
                with pytest.raises(RuntimeError,
                                   match=r"retry_after_ms=\d+"):
                    b.generate([2] * 8, max_new_tokens=8, retry=False)
                assert len(_tokens(gen)) == 7
            _wait_for(lambda: eng.allocator.num_used == 0)
    finally:
        ptt.set_flags({"kv_admission_watermark": 0.0})


def test_client_disconnect_frees_every_kv_block(pair):
    with port_server(pair[1], paced_s=0.02) as (srv, eng):
        cli = pinf.Client(port=srv.port, timeout_s=WAIT_S)
        gen = cli.generate_stream([3] * 10, max_new_tokens=100)
        next(gen)
        assert eng.allocator.num_used > 0
        cli.close()                   # the next chunk write fails
        _wait_for(lambda: eng.allocator.num_used == 0 and not eng.active())
        eng.allocator.check()


def test_drain_refuses_new_streams_and_terminates_the_rest(pair):
    with port_server(pair[1], paced_s=0.02, pool_blocks=64) as (srv, eng):
        with pinf.Client(port=srv.port, timeout_s=WAIT_S) as cli:
            gen = cli.generate_stream([3, 4, 5], max_new_tokens=100,
                                      deadline_s=WAIT_S)
            for _ in range(2):
                next(gen)
            srv.drain(deadline_s=0.3, wait=True)
            assert srv._drained.is_set()
            assert native.stat_get("serving.draining") == 1
            with pytest.raises(RuntimeError, match="drain"):
                for _ in gen:
                    pass
            with pinf.Client(port=srv.port, timeout_s=WAIT_S) as cli2:
                with pytest.raises(RuntimeError, match="draining"):
                    cli2.generate([1, 2], max_new_tokens=2, retry=False)
            assert srv.n_drain_rejected >= 1
        assert eng.allocator.num_used == 0
        eng.allocator.check()


def test_drain_of_an_idle_server_completes_at_once(pair):
    with port_server(pair[1]) as (srv, _):
        srv.drain(deadline_s=5.0, wait=True)
        assert srv._drained.is_set()
    # a fresh server is not draining, whatever an earlier one did
    with port_server(pair[1]) as (srv, _):
        assert native.stat_get("serving.draining") == 0


def test_stop_mid_stream_sends_a_terminal_frame(pair):
    with port_server(pair[1], paced_s=0.02, pool_blocks=64) as (srv, eng):
        with pinf.Client(port=srv.port, timeout_s=WAIT_S) as cli:
            gen = cli.generate_stream([5, 9, 2], max_new_tokens=100,
                                      deadline_s=WAIT_S)
            next(gen)
            t = threading.Thread(target=srv.stop)
            t.start()
            with pytest.raises(RuntimeError, match="server stopping"):
                for _ in gen:
                    pass
            t.join(timeout=WAIT_S)
        assert eng.allocator.num_used == 0


def test_a_failed_step_ends_open_streams_and_serving_goes_on(pair):
    with port_server(pair[1], paced_s=0.02) as (srv, eng):
        step, calls = eng.step, []

        def failing_once():
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("injected step failure")
            return step()
        eng.step = failing_once
        with pinf.Client(port=srv.port, timeout_s=WAIT_S) as cli:
            with pytest.raises(RuntimeError,
                               match="decode_error: injected step failure"):
                cli.generate([1, 2, 3], max_new_tokens=20, retry=False)
            # the terminal frame goes out before the sequence is freed
            _wait_for(lambda: eng.allocator.num_used == 0)
            assert srv.n_errors == 1
            assert len(cli.generate([1, 2, 3], max_new_tokens=3)) == 3


def test_native_stats_count_stream_frames(pair):
    with port_server(pair[1]) as (srv, _):
        with pinf.Client(port=srv.port, timeout_s=WAIT_S) as cli:
            list(cli.generate_stream([1, 2], max_new_tokens=3))
            stats = cli.stats()
    assert stats["stream_total"] >= 1
    assert stats["stream_chunks_total"] >= 3
    assert stats["serving.stream_total"] >= 1


def test_malformed_body_is_a_terminal_error(pair):
    with port_server(pair[1]) as (srv, eng):
        with pinf.Client(port=srv.port, timeout_s=WAIT_S) as cli:
            tag = cli._send_frame(
                cli._MAGIC_STREAM,
                struct.pack("<Q", cli.make_trace_id()) + b"xx")
            status, payload = cli._recv(tag)
            assert status < 0 and b"header" in payload
            with pytest.raises(RuntimeError, match="empty prompt"):
                cli.generate([], max_new_tokens=2, retry=False)
        assert eng.allocator.num_used == 0


def test_queue_deadline_sheds_a_waiting_stream(pair):
    with port_server(pair[1], paced_s=0.05, max_decode_batch=1) as (srv,
                                                                    eng):
        before = native.stat_get("serving.shed_total")
        with pinf.Client(port=srv.port, timeout_s=WAIT_S) as a, \
                pinf.Client(port=srv.port, timeout_s=WAIT_S) as b:
            gen = a.generate_stream([1, 2, 3], max_new_tokens=10)
            next(gen)
            # the next stream waits behind the running one (decode batch
            # of 1) past the deadline: shed before it starts
            srv.queue_deadline_ms = 1
            with pytest.raises(RuntimeError, match="request shed"):
                b.generate([4, 5], max_new_tokens=2, retry=False)
            assert len(_tokens(gen)) == 9          # never shed once started
        assert srv.n_shed == 1
        assert native.stat_get("serving.shed_total") == before + 1
        _wait_for(lambda: eng.allocator.num_used == 0)


class _StubTransport:
    def __init__(self):
        self.chunks = []

    def reply_chunk(self, rid, payload, status=0, final=False):
        self.chunks.append((rid, bytes(payload), status, final))
        return 0


class _StubServer:
    def __init__(self, deadline_s):
        self.transport = _StubTransport()
        self.shed = []
        self._ddl = deadline_s

    def _queue_deadline_s(self):
        return self._ddl

    def _shed(self, req, age_s, deadline_s):
        self.shed.append((req, age_s, deadline_s))


def test_bridge_sheds_only_unstarted_waiting_streams(pair):
    eng = LLMEngine(pair[1], block_size=4, pool_blocks=8,
                    max_decode_batch=1, device="cpu")
    stub = _StubServer(deadline_s=0.05)
    bridge = LLMStreamBridge(stub, eng)
    a = eng.add_request([1] * 8, max_new_tokens=4)
    b = eng.add_request([2, 3], max_new_tokens=4)    # behind the cap
    eng.step()
    assert [x.seq_id for x in eng.scheduler.waiting] == [b]
    old = time.monotonic() - 1.0
    bridge._reqs[a] = {"rid": 1, "dequeue_mono": old}
    bridge._reqs[b] = {"rid": 2, "dequeue_mono": old}
    bridge._shed_expired()
    assert [r[0]["rid"] for r in stub.shed] == [2]
    assert b not in bridge._reqs and a in bridge._reqs
    assert not eng.scheduler.waiting
    assert eng.cancel(a)
    assert eng.allocator.num_used == 0


def test_bridge_sheds_nothing_without_a_deadline(pair):
    eng = LLMEngine(pair[1], block_size=4, pool_blocks=3, device="cpu")
    stub = _StubServer(deadline_s=0.0)
    bridge = LLMStreamBridge(stub, eng)
    b = eng.add_request([2, 3], max_new_tokens=4)
    bridge._reqs[b] = {"rid": 2, "dequeue_mono": time.monotonic() - 99}
    bridge._shed_expired()
    assert stub.shed == [] and b in bridge._reqs
    eng.cancel(b)


# ---------------------------------------------------------------------------
# client resilience, both packages' clients against a scripted peer
# ---------------------------------------------------------------------------

class _FakeStreamServer:
    """One scripted handler per accepted connection."""

    def __init__(self, handlers):
        self._handlers = list(handlers)
        self.requests = []
        self._lsock = socket.socket()
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind(("127.0.0.1", 0))
        self._lsock.listen(8)
        self.port = self._lsock.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    @staticmethod
    def _readn(conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("peer closed")
            buf += chunk
        return buf

    @staticmethod
    def reply(conn, tag, status, payload=b""):
        conn.sendall(struct.pack("<QqI", tag, status, len(payload))
                     + payload)

    def _serve(self):
        for handler in self._handlers:
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return
            try:
                magic, tag, ln = struct.unpack(
                    "<IQI", self._readn(conn, struct.calcsize("<IQI")))
                self.requests.append((magic, tag, self._readn(conn, ln)))
                handler(conn, tag)
            except (OSError, ConnectionError):
                pass  # scripted teardown
            finally:
                conn.close()

    def close(self):
        self._lsock.close()
        self._thread.join(timeout=10)


def _chunk(tok):
    return pinf.encode_tensors([np.asarray([tok], np.int32)])


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_stream_deadline_times_out_and_poisons(pkg):
    mod = pinf if pkg == "port" else jinf
    stop = threading.Event()

    def one_chunk_then_silence(conn, tag):
        _FakeStreamServer.reply(conn, tag, 1, _chunk(7))
        stop.wait(10.0)

    fake = _FakeStreamServer([one_chunk_then_silence])
    cli = mod.Client(port=fake.port, timeout_s=WAIT_S)
    try:
        gen = cli.generate_stream([1, 2], max_new_tokens=4, deadline_s=0.3)
        assert int(next(gen)[0]) == 7
        with pytest.raises(mod.StreamTimeout) as ei:
            next(gen)
        assert ei.value.delivered_tokens == [7]
        assert isinstance(ei.value, TimeoutError)
        with cli._rcond:
            assert cli._sock is None
    finally:
        stop.set()
        cli.close()
        fake.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_generate_retries_once_with_zero_chunks(pkg):
    mod = pinf if pkg == "port" else jinf

    def die_before_first_chunk(conn, tag):
        conn.close()

    def serve_properly(conn, tag):
        for tok in (1, 2, 3):
            _FakeStreamServer.reply(conn, tag, 1, _chunk(tok))
        _FakeStreamServer.reply(conn, tag, 0)

    fake = _FakeStreamServer([die_before_first_chunk, serve_properly])
    cli = mod.Client(port=fake.port, timeout_s=WAIT_S)
    try:
        assert cli.generate([1, 2], max_new_tokens=3).tolist() == [1, 2, 3]
        assert len(fake.requests) == 2
    finally:
        cli.close()
        fake.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_generate_does_not_retry_after_the_first_chunk(pkg):
    mod = pinf if pkg == "port" else jinf

    def one_chunk_then_die(conn, tag):
        _FakeStreamServer.reply(conn, tag, 1, _chunk(9))
        time.sleep(0.1)
        conn.close()

    fake = _FakeStreamServer([one_chunk_then_die])
    cli = mod.Client(port=fake.port, timeout_s=WAIT_S)
    try:
        with pytest.raises(ConnectionError):
            cli.generate([1, 2], max_new_tokens=4)
        assert len(fake.requests) == 1
    finally:
        cli.close()
        fake.close()


def test_generate_frames_are_byte_identical_to_jax():
    """The same call sends the same PTST body from either client (the
    trace id pinned), tails and descriptor included."""
    bodies = []
    for mod in (pinf, jinf):
        fake = _FakeStreamServer(
            [lambda conn, tag: _FakeStreamServer.reply(conn, tag, 0)])
        with mod.Client(port=fake.port, timeout_s=WAIT_S) as cli:
            list(cli.generate_stream([4, 5, 6], max_new_tokens=3,
                                     eos_token_id=2, temperature=0.5,
                                     seed=9, trace_id=42, sample_offset=3,
                                     tenant="acme",
                                     priority_class="bulk"))
        fake.close()
        bodies.append(fake.requests[0])
    assert bodies[0] == bodies[1]


# ---------------------------------------------------------------------------
# the native library: built from csrc/ into the port, safely across processes
# ---------------------------------------------------------------------------

_BUILD_AND_LOAD = """
import ctypes, json, os, sys
written = []


def audit(event, args):
    # every path this process opens for writing, renames, or hands g++
    if event == "open" and (
            (args[1] is not None and any(c in args[1] for c in "wax+"))
            or (args[1] is None and args[2] & (os.O_WRONLY | os.O_RDWR))):
        written.append(os.fspath(args[0]))
    elif event == "os.rename":
        written.extend((os.fspath(args[0]), os.fspath(args[1])))
    elif event == "subprocess.Popen" and "-o" in list(args[1]):
        cmd = list(args[1])
        written.append(os.fspath(cmd[cmd.index("-o") + 1]))


sys.addaudithook(audit)
from paddle_tpu_torch import native
path = native.build(sys.argv[1])
lib = ctypes.CDLL(path)
lib.pt_mon_add.argtypes = [ctypes.c_char_p, ctypes.c_int64]
lib.pt_mon_get.argtypes = [ctypes.c_char_p]
lib.pt_mon_get.restype = ctypes.c_int64
lib.pt_mon_add(b"probe", 5)
assert lib.pt_mon_get(b"probe") == 5
assert hasattr(lib, "pt_srv_start") and hasattr(lib, "pt_srv_next_ex2")
print(json.dumps({"path": path, "written": written}))
"""


def test_two_processes_build_the_native_library_at_once(tmp_path):
    """Both processes start the build at once (one builds under the
    lock, the other waits and loads the finished library); each loads a
    whole library, and neither writes anywhere but the build directory:
    never into the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), PYTHONDONTWRITEBYTECODE="1")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_LOAD,
                               str(tmp_path)], cwd=str(tmp_path), env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    reports = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        reports.append(json.loads(out.strip().splitlines()[-1]))
    jax_pkg = ROOT / "paddle_tpu"
    built = 0
    for rep in reports:
        assert rep["path"] == str(tmp_path / "libptnative.so")
        for w in rep["written"]:
            w = Path(w) if os.path.isabs(w) else tmp_path / w
            assert jax_pkg not in w.resolve().parents, w
        built += any(w.endswith(".tmp") for w in rep["written"])
    assert built == 1             # one compiled; the other found it built
    names = {p.name for p in tmp_path.iterdir()}
    assert names == {"libptnative.so", "libptnative.so.sha256",
                     "libptnative.so.lock"}, names   # no temporary left
    # the sources' hash marks it current: another build is a no-op
    mtime = (tmp_path / "libptnative.so").stat().st_mtime_ns
    native.build(tmp_path)
    assert (tmp_path / "libptnative.so").stat().st_mtime_ns == mtime


# ---------------------------------------------------------------------------
# telemetry: the bridge's and the server's counters, spans and timelines
# after the same streams, against a JAX server
# ---------------------------------------------------------------------------

_STREAM_METRICS = ("serving_stream_requests_total",
                   "serving_stream_tokens_total",
                   "serving_stream_cancelled_total",
                   "serving_stream_errors_total", "serving_ttft_ms",
                   "serving_tpot_ms")


def _serve_streams(srv, fmod):
    """Two clean streams and a malformed body, then a stream whose third
    token write fails (``llm_chunk_write:at=3``, armed for it alone): the
    server cancels it, and its client sees silence past the deadline."""
    with pinf.Client(port=srv.port, timeout_s=WAIT_S) as cli:
        for p in (PROMPT, PROMPT[:3]):
            assert len(_tokens(cli.generate_stream(
                p, max_new_tokens=MAX_NEW))) == MAX_NEW
        with pytest.raises(RuntimeError):
            list(cli.generate_stream(np.zeros(0, np.int32),
                                     max_new_tokens=2))
    fmod.configure("llm_chunk_write:at=3")
    with pinf.Client(port=srv.port, timeout_s=WAIT_S) as cli:
        got = []
        with pytest.raises(TimeoutError):
            for ch in cli.generate_stream(PROMPT, max_new_tokens=MAX_NEW,
                                          deadline_s=1.0):
                got.append(ch)
        assert len(got) == 2


def _telemetry(obs_mod):
    snap = obs_mod.registry().snapshot()
    view = {}
    for name in _STREAM_METRICS:
        m = snap.get(name, {"series": []})
        view[name] = [s.get("count", s.get("value"))
                      for s in m["series"]]
    spans = [(r["outcome"], r["status"], r["tokens"])
             for r in obs_mod.reqtrace.recent() if r.get("stream")]
    timelines = sorted(tl["outcome"] for tl in obs_mod.seqtrace.ring()
                       .recent())
    return view, spans, timelines


def test_bridge_and_server_telemetry_match_jax(pair):
    from paddle_tpu import observability as jax_obs
    from paddle_tpu.testing import faults as jax_faults
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.testing import faults
    pt.set_flags({"enable_metrics": True, "metrics_port": -1})
    ptt.set_flags({"enable_metrics": True, "metrics_port": -1})
    jax_obs.reset_all()
    obs.reset_all()
    out = []
    try:
        for mod, fmod in ((jax_obs, jax_faults), (obs, faults)):
            cm = port_server(pair[1]) if mod is obs else jax_server(pair[0])
            with cm as (srv, _):
                try:
                    _serve_streams(srv, fmod)
                    eng = srv._llm.engine
                    _wait_for(lambda: eng.allocator.num_used == 0)
                finally:
                    fmod.configure(None)
            out.append(_telemetry(mod))
        assert obs.counter("faults_injected_total").value(
            point="llm_chunk_write") == 1
        kinds = [e["kind"] for e in obs.flight_recorder().events()]
        assert "serving_stream_cancelled" in kinds
    finally:
        pt.set_flags({"enable_metrics": False, "metrics_port": 0})
        ptt.set_flags({"enable_metrics": False, "metrics_port": 0})
        jax_obs.reset_all()
        obs.reset_all()
    assert out[1] == out[0]
    view, spans, timelines = out[1]
    assert view["serving_stream_requests_total"] == [3]
    assert view["serving_stream_cancelled_total"] == [1]
    assert [o for o, _, _ in spans] == ["ok", "ok", "decode_error",
                                       "cancelled"]
    assert timelines == ["cancelled", "finished", "finished"]
