"""The serving wire: the tensor codec, ``Server`` and ``Client``.

Counterpart of ``paddle_tpu.inference``'s serving half. The native
transport (``native.ServingTransport``: sockets, framing, the bounded
queue) takes the frames of ``docs/serving_protocol.md``; :class:`Server`
is the compute half on its own thread: it dequeues requests, hands every
streaming-generate ('PTST') frame to an ``LLMStreamBridge`` over an
``LLMEngine`` and steps the engine while generations are in flight,
admitting new prefills into the running decode batch (continuous
batching). :class:`Client` speaks the same frames. Both are byte for
byte the JAX package's: either package's client talks to either
package's server.

Not ported yet: ``Config``/``Predictor``/``create_predictor``, which
serve a ``jit.save`` export (their counterpart is ``torch.export`` per
shape bucket), so a server here takes ``predictor=None`` and answers a
tensor request with the error the JAX package's LLM-only server gives;
and the server's telemetry (metrics, request spans, flight records, the
exporter). Its own integer counters and the native STATS reply stay.
"""

from __future__ import annotations

import collections
import os
import socket
import struct
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..flags import GLOBAL_FLAGS
from ..native import ServingTransport, stat_add, stat_reset

__all__ = ["Server", "Client", "encode_tensors", "decode_tensors",
           "StreamInterrupted", "StreamConnectionLost", "StreamTimeout"]


class StreamInterrupted(Exception):
    """A streaming generate that died mid-stream, with the tokens already
    delivered attached: the resume substrate of the router's failover.
    Raised only by :meth:`Client.generate_stream`, always as one of the
    two subclasses, so ``except ConnectionError`` / ``except
    TimeoutError`` keep working:

    * :class:`StreamConnectionLost` (a ``ConnectionError``): the
      transport died between chunks;
    * :class:`StreamTimeout` (a ``TimeoutError``): the stream went
      silent past the per-chunk deadline and the connection was
      poisoned.

    Re-sending prompt + ``delivered_tokens`` with
    ``sample_offset=len(delivered_tokens)`` reproduces the rest of the
    stream bit for bit (the engine's sampler is keyed by position)."""

    def __init__(self, message: str, delivered_tokens=()):
        super().__init__(message)
        self.delivered_tokens: List[int] = [int(t)
                                            for t in delivered_tokens]

    def partial(self) -> np.ndarray:
        """Delivered tokens as an int32 [n] array (possibly empty)."""
        return np.asarray(self.delivered_tokens, np.int32)


class StreamConnectionLost(StreamInterrupted, ConnectionError):
    pass


class StreamTimeout(StreamInterrupted, TimeoutError):
    pass


# ------------------------------------------------------------------ codec
# Tensor payload codec of the serving transport. Little-endian:
#   u32 n_tensors | per tensor:
#     u8 dtype_code | u8 ndim | u32 dims[ndim] | u64 nbytes | raw bytes

_DTYPES = ["float32", "float64", "int32", "int64", "uint8", "bool",
           "bfloat16", "float16", "int8", "uint32", "uint64", "int16"]
_BF16 = _DTYPES.index("bfloat16")


def _dtype_code(dt) -> int:
    return _DTYPES.index(str(np.dtype(dt)))


def _coded(a) -> Tuple[int, Tuple[int, ...], bytes]:
    """(dtype code, shape, raw bytes) of one array or tensor."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return _BF16, tuple(t.shape), t.view(torch.int16).numpy() \
                .tobytes()
        a = t.numpy()
    # NOT ascontiguousarray: it promotes 0-d arrays to 1-d
    a = np.asarray(a, order="C")
    return _dtype_code(a.dtype), a.shape, a.tobytes()


def encode_tensors(arrays: Sequence) -> bytes:
    """Encode numpy arrays or tensors (a tensor is read from the host;
    a bfloat16 one is coded by its bits, as a bfloat16 numpy array
    is)."""
    parts = [struct.pack("<I", len(arrays))]
    for a in arrays:
        code, shape, raw = _coded(a)
        parts.append(struct.pack("<BB", code, len(shape)))
        parts.append(struct.pack(f"<{len(shape)}I", *shape))
        parts.append(struct.pack("<Q", len(raw)))
        parts.append(raw)
    return b"".join(parts)


def decode_tensors(buf: bytes) -> List:
    """Decode to numpy arrays; a bfloat16 tensor (numpy has no such
    dtype) decodes to a CPU ``torch.bfloat16`` tensor."""
    (n,) = struct.unpack_from("<I", buf, 0)
    off = 4
    out: List = []
    for _ in range(n):
        code, ndim = struct.unpack_from("<BB", buf, off)
        off += 2
        dims = struct.unpack_from(f"<{ndim}I", buf, off)
        off += 4 * ndim
        (nbytes,) = struct.unpack_from("<Q", buf, off)
        off += 8
        dt = np.dtype("int16" if code == _BF16 else _DTYPES[code])
        a = np.frombuffer(buf, dtype=dt, count=nbytes // dt.itemsize,
                          offset=off).reshape(dims).copy()
        out.append(torch.from_numpy(a).view(torch.bfloat16)
                   if code == _BF16 else a)
        off += nbytes
    return out


# ----------------------------------------------------------------- server

class Server:
    """Serving loop over the native transport (csrc/serving.cc).

    Streaming-generate requests go to ``llm_engine`` (an
    ``LLMEngine``) through an ``LLMStreamBridge``; requests that arrive
    within ``wait_ms`` of each other (up to ``max_batch``) are admitted
    together. The loop runs on its own thread, so the engine's device
    work does too: a CUDA engine's device is made current there.
    ``predictor`` must be None (tensor serving is not ported yet): a
    tensor request is answered with an error. The server starts on
    construction; ``port`` 0 takes an ephemeral port (``.port``)."""

    def __init__(self, predictor=None, port: int = 0, max_batch: int = 32,
                 wait_ms: int = 2, queue_cap: int = 512,
                 max_payload: int = 64 << 20,
                 queue_deadline_ms: Optional[int] = None,
                 llm_engine=None):
        if predictor is not None:
            raise NotImplementedError(
                "tensor serving (Predictor) is not ported yet: pass "
                "predictor=None and llm_engine=")
        self.predictor = None
        self._llm = None
        if llm_engine is not None:
            from ..serving_llm.server import LLMStreamBridge
            self._llm = LLMStreamBridge(self, llm_engine)
        self.max_batch = max_batch
        self.wait_ms = wait_ms
        # load shedding: requests older than this when the loop picks
        # them up are error-replied, not served (None: the
        # serving_queue_deadline_ms flag; 0 disables)
        self.queue_deadline_ms = queue_deadline_ms
        self.transport = ServingTransport(port=port, queue_cap=queue_cap,
                                          max_payload=max_payload)
        self.port = self.transport.port
        self._stop = threading.Event()
        # serving.draining is a process-wide monitor stat: a fresh server
        # is not draining, whatever an earlier one in this process did
        stat_reset("serving.draining")
        self._draining = False
        self._drain_deadline_pc: Optional[float] = None
        self._drained = threading.Event()
        self.n_drain_rejected = 0
        # n_batches and n_requests count tensor batches, which wait for
        # the predictor; n_errors counts failed engine steps
        self.n_batches = 0
        self.n_requests = 0
        self.n_errors = 0
        self.n_shed = 0
        # arrival-stamped staging queue, drained off the transport
        # eagerly so each request's queue age is measurable
        self._rq: collections.deque = collections.deque()  # guarded-by: single-owner (serving thread)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"serving-{self.port}")
        self._thread.start()

    def _queue_deadline_s(self) -> float:
        v = self.queue_deadline_ms
        if v is None:
            v = GLOBAL_FLAGS.get("serving_queue_deadline_ms")
        return max(0, int(v or 0)) / 1e3

    @staticmethod
    def _mk_req(r) -> Dict[str, Any]:
        rid, payload, trace_id, _ingress, is_stream = r
        return {"rid": rid, "payload": payload, "trace_id": trace_id,
                "dequeue_mono": time.monotonic(), "stream": is_stream}

    def _drain_transport(self) -> None:
        while True:
            r = self.transport.next_request_ex2(timeout_ms=0)
            if r is None:
                return
            self._rq.append((time.perf_counter(), self._mk_req(r)))

    def _next_request(self, timeout_ms: int):
        """The staging queue first, then the transport. Requests whose
        queue age exceeds the deadline are shed here."""
        self._drain_transport()
        if not self._rq:
            r = self.transport.next_request_ex2(timeout_ms=timeout_ms)
            if r is None:
                return None
            self._rq.append((time.perf_counter(), self._mk_req(r)))
        ddl = self._queue_deadline_s()
        while self._rq:
            ts, req = self._rq.popleft()
            age = time.perf_counter() - ts
            if ddl > 0 and age > ddl:
                self._shed(req, age, ddl)
                continue
            return req
        return None

    def _refuse(self, req: Dict[str, Any], msg: bytes) -> None:
        """Error-reply one request (a terminal frame for a stream). The
        client may be gone already; the native side counts that."""
        if req.get("stream"):
            self.transport.reply_chunk(req["rid"], msg, status=-1,
                                       final=True)
        else:
            self.transport.reply(req["rid"], msg, status=-1)

    def _shed(self, req: Dict[str, Any], age_s: float,
              deadline_s: float) -> None:
        self.n_shed += 1
        self._refuse(req, (f"request shed: queued {age_s * 1e3:.0f}ms > "
                           f"queue deadline {deadline_s * 1e3:.0f}ms"
                           ).encode())
        stat_add("serving.shed_total")

    def _loop(self) -> None:
        if self._llm is not None and self._llm.engine.device.type == "cuda":
            # the current device is per thread, and the kernels launch on
            # the current stream of the engine's device
            torch.cuda.set_device(self._llm.engine.device)
        while not self._stop.is_set():
            if self._draining:
                self._drain_tick()
                continue
            # while generations are in flight, poll with a tiny timeout
            # so new prefills join the running decode batch
            llm_busy = self._llm is not None and self._llm.active()
            first = self._next_request(timeout_ms=1 if llm_busy else 100)
            if first is None:
                if llm_busy:
                    self._llm_step()
                continue
            group = [first]
            deadline = time.perf_counter() + self.wait_ms / 1e3
            while len(group) < self.max_batch:
                left = deadline - time.perf_counter()
                if left <= 0 and self.transport.pending() == 0 \
                        and not self._rq:
                    break
                nxt = self._next_request(
                    timeout_ms=max(1, int(left * 1e3)))
                if nxt is None:
                    break
                group.append(nxt)
            for req in group:
                if not req.get("stream"):
                    self._refuse(req, b"server has no predictor (LLM-only "
                                      b"server: use streaming generate "
                                      b"frames)")
                elif self._llm is None:
                    self._refuse(req, b"server has no LLM engine")
                else:
                    self._llm.admit(req)
            if self._llm is not None and self._llm.active():
                self._llm_step()

    def _llm_step(self) -> None:
        """One engine step. A step that raises ends every open stream
        with a terminal ``decode_error`` frame (their KV blocks freed)
        and the loop keeps serving new requests."""
        try:
            self._llm.step()
        except Exception as e:  # noqa: BLE001 — keep the serving loop alive
            traceback.print_exc()
            self.n_errors += 1
            self._llm.close(message=f"decode_error: {e}".encode(),
                            outcome="decode_error")

    # -- graceful drain ---------------------------------------------------

    def drain(self, deadline_s: Optional[float] = None,
              wait: bool = True) -> None:
        """Begin a graceful drain: refuse every request that arrives
        from now on, let in-flight generations decode for up to
        ``deadline_s`` (default ``serving_drain_deadline_s``), then end
        the rest with terminal negative-status frames. ``wait`` blocks
        until the drain completes. Idempotent. The drain shows as
        ``serving.draining=1`` in STATS, which a router's probe reads
        (the monitor is process-wide: with several servers in one
        process it reads "some server here is draining")."""
        if deadline_s is None:
            deadline_s = float(GLOBAL_FLAGS.get("serving_drain_deadline_s"))
        deadline_s = max(0.0, float(deadline_s))
        if not self._draining:
            self._drain_deadline_pc = time.perf_counter() + deadline_s
            self._draining = True
            stat_reset("serving.draining")
            stat_add("serving.draining", 1)
        if wait:
            self._drained.wait(deadline_s + 30.0)

    def _drain_tick(self) -> None:
        """One loop pass while draining: refuse new arrivals, step the
        in-flight generations until they finish or the deadline passes,
        then end the rest with terminal frames."""
        self._drain_transport()
        while self._rq:
            _, req = self._rq.popleft()
            self.n_drain_rejected += 1
            self._refuse(req, b"server draining: not accepting new "
                              b"requests")
        llm_busy = self._llm is not None and self._llm.active()
        if llm_busy:
            if time.perf_counter() < (self._drain_deadline_pc or 0):
                self._llm_step()
                return
            self._llm.close(
                message=b"server draining: drain deadline exceeded",
                outcome="drain_deadline")
        self._drained.set()
        self._stop.wait(0.02)  # idle: keep refusing stragglers

    def serve_forever(self, drain_deadline_s: Optional[float] = None,
                      on_drained=None) -> None:
        """Block the calling (main) thread until the process is asked
        to stop, draining gracefully on SIGTERM, then re-deliver the
        signal so the exit status stays honest. ``on_drained(server)``
        runs after the drain and before the transport stops. Returns
        normally only if ``stop()`` was called elsewhere."""
        from .. import preemption
        with preemption.guard() as g:
            while not g.preempted and not self._stop.is_set():
                time.sleep(0.05)
            if not g.preempted:
                return
            self.drain(deadline_s=drain_deadline_s, wait=True)
            if on_drained is not None:
                try:
                    on_drained(self)
                except Exception:  # noqa: BLE001
                    traceback.print_exc()
            self.stop()
            g.reraise()

    def stop(self) -> None:
        """Stop the loop, end every open stream with a terminal
        ``server stopping`` frame (KV blocks freed) and close the
        transport. Idempotent."""
        self._stop.set()
        self._thread.join(timeout=5)
        if self._llm is not None:
            self._llm.close()
        self.transport.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


# ----------------------------------------------------------------- client

class Client:
    """Socket client of the serving protocol. Thread-safe; pipelines.

    * Per-call deadlines: ``deadline_s`` (constructor default, or per
      ``infer``/``stats`` call) bounds the round trip and raises
      ``TimeoutError``; a deadline that fires mid-frame poisons the
      connection, which the next call repairs by reconnecting.
    * Bounded reconnect with backoff: a ``ConnectionError`` while
      sending triggers up to ``max_reconnects`` reconnects
      (exponential backoff from ``reconnect_backoff_s``) and a resend.
    * ``stats()`` also retries a round trip that died while waiting
      (it has no side effects); ``infer()`` does not.
    * Every ``infer`` carries a unique 64-bit trace id ('PTSR' frames;
      ``traced=False`` sends untraced 'PTSV' frames); the id of the
      latest call is ``last_trace_id``.
    """

    _MAGIC = 0x56535450        # 'PTSV' tensor request
    _MAGIC_CTL = 0x43535450    # 'PTSC' control frame
    _MAGIC_TRACE = 0x52535450  # 'PTSR' traced tensor request
    _MAGIC_STREAM = 0x54535450  # 'PTST' streaming generate request
    _OP_STATS = 1

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 timeout_s: float = 30.0,
                 deadline_s: Optional[float] = None,
                 max_reconnects: int = 2,
                 reconnect_backoff_s: float = 0.05,
                 traced: bool = True,
                 connect_timeout_s: Optional[float] = None):
        self._host = host
        self._port = port
        self._timeout_s = timeout_s
        # connect may be gated tighter than reads: a refused connect
        # fails fast even when reads sit through a cold backend's first
        # request (the router's failover detection relies on it)
        self._connect_timeout_s = (timeout_s if connect_timeout_s is None
                                   else connect_timeout_s)
        self._deadline_s = deadline_s
        self._max_reconnects = int(max_reconnects)
        self._reconnect_backoff_s = float(reconnect_backoff_s)
        self._traced = bool(traced)
        # trace ids: a random 48-bit client base | a 16-bit call counter,
        # never 0 (the wire's "untraced")
        self._trace_base = int.from_bytes(os.urandom(6), "little") << 16
        self._trace_n = 0  # guarded-by: self._conn_lock
        self.last_trace_id: Optional[int] = None
        self._wlock = threading.Lock()
        self._rlock = threading.Lock()
        self._conn_lock = threading.Lock()
        self._tag = 0  # guarded-by: self._wlock
        self._replies: Dict[int, Tuple[int, bytes]] = {}  # guarded-by: self._rcond
        self._rcond = threading.Condition()
        self._sock: Optional[socket.socket] = None  # guarded-by: self._rcond
        self._gen = 0  # guarded-by: self._rcond
        self._connect()

    def make_trace_id(self) -> int:
        """Next unique nonzero trace id of this client."""
        with self._conn_lock:
            self._trace_n += 1
            tid = (self._trace_base | (self._trace_n & 0xFFFF)) \
                & 0xFFFFFFFFFFFFFFFF
        return tid or 1

    # -- connection management -------------------------------------------

    def _connect(self) -> None:
        sock = socket.create_connection((self._host, self._port),
                                        timeout=self._connect_timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(self._timeout_s)
        with self._rcond:
            self._sock = sock
            self._gen += 1
            # tags of the old connection can never be answered
            self._replies.clear()
            self._rcond.notify_all()

    def _poison(self, gen: int) -> None:
        """Mark connection ``gen`` dead: waiters raise instead of
        hanging; the next call reconnects."""
        with self._rcond:
            if self._gen != gen:
                return  # already superseded
            sock, self._sock = self._sock, None
            self._rcond.notify_all()
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass  # the fd is dropped either way

    def _reconnect_with_backoff(self, attempts: int, gen: int,
                                deadline: Optional[float]) -> int:
        """One bounded retry step; returns the new attempt count or
        raises the terminal error."""
        if attempts >= self._max_reconnects:
            raise ConnectionError(
                f"server unreachable after {attempts} reconnect "
                f"attempts ({self._host}:{self._port})")
        delay = self._reconnect_backoff_s * (2 ** attempts)
        if deadline is not None:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError("deadline exceeded while reconnecting")
            delay = min(delay, left)
        time.sleep(delay)
        with self._conn_lock:
            with self._rcond:
                stale = self._sock is None or self._gen == gen
            if stale:
                try:
                    self._connect()
                except OSError as e:
                    self._poison(self._gen)
                    if attempts + 1 >= self._max_reconnects:
                        raise ConnectionError(
                            f"reconnect to {self._host}:{self._port} "
                            f"failed: {e}") from e
        return attempts + 1

    def _deadline_of(self, deadline_s: Optional[float]
                     ) -> Optional[float]:
        eff = deadline_s if deadline_s is not None else self._deadline_s
        return None if eff is None else time.monotonic() + float(eff)

    # -- public API -------------------------------------------------------

    def infer(self, arrays: Sequence, deadline_s: Optional[float] = None,
              trace_id: Optional[int] = None) -> List:
        """One tensor request round trip; returns the decoded reply."""
        if trace_id is None and self._traced:
            trace_id = self.make_trace_id()
        self.last_trace_id = trace_id
        deadline = self._deadline_of(deadline_s)
        attempts = 0
        while True:
            with self._rcond:
                gen = self._gen
            try:
                tag = self._send(arrays, trace_id)
            except (ConnectionError, OSError) as e:
                # nothing reached the server: reconnect and resend
                self._poison(gen)
                if isinstance(e, socket.timeout):
                    raise TimeoutError(f"send timed out: {e}") from e
                attempts = self._reconnect_with_backoff(
                    attempts, gen, deadline)
                continue
            try:
                status, payload = self._recv(tag, gen, deadline)
            except ConnectionError:
                # the request may have run server-side: repair the
                # transport for later calls, but surface the error
                try:
                    self._reconnect_with_backoff(
                        max(0, self._max_reconnects - 1), gen, deadline)
                except (ConnectionError, TimeoutError):
                    pass  # the original error is raised below either way
                raise
            if status != 0:
                raise RuntimeError(f"server error: {payload.decode()!r}")
            return decode_tensors(payload)

    def stats(self, deadline_s: Optional[float] = None) -> Dict[str, int]:
        """STATS control round trip: the server's ``key=value`` lines
        (queue depth, in-flight count, totals, uptime, ``serving.*``
        monitor lines) as ints. Retried across reconnects."""
        deadline = self._deadline_of(deadline_s)
        attempts = 0
        while True:
            with self._rcond:
                gen = self._gen
            try:
                tag = self._send_frame(
                    self._MAGIC_CTL, struct.pack("<I", self._OP_STATS))
                status, payload = self._recv(tag, gen, deadline)
            except (ConnectionError, OSError) as e:
                self._poison(gen)
                if isinstance(e, socket.timeout):
                    raise TimeoutError(f"stats timed out: {e}") from e
                attempts = self._reconnect_with_backoff(
                    attempts, gen, deadline)
                continue
            if status != 0:
                raise RuntimeError(f"stats error: {payload.decode()!r}")
            out: Dict[str, int] = {}
            for line in payload.decode().splitlines():
                if "=" in line:
                    k, v = line.rsplit("=", 1)
                    try:
                        out[k] = int(v)
                    except ValueError:
                        pass  # the format is k=<int> per line; skip others
            return out

    def generate_stream(self, prompt_ids, max_new_tokens: int = 16,
                        eos_token_id: Optional[int] = None,
                        temperature: float = 0.0, seed: int = 0,
                        deadline_s: Optional[float] = None,
                        trace_id: Optional[int] = None,
                        sample_offset: int = 0,
                        tenant: Optional[str] = None,
                        priority_class: Optional[str] = None):
        """Streaming generate: send one 'PTST' frame, then yield each
        token chunk (an int32 array of length 1) as the server streams
        it, until the terminal frame. A negative terminal status raises
        RuntimeError with the server's message.

        ``deadline_s`` is per chunk: a stream silent past it raises
        :class:`StreamTimeout` and poisons the connection; a transport
        death between chunks raises :class:`StreamConnectionLost`. Both
        carry ``delivered_tokens``. ``sample_offset`` > 0 marks a
        resumed stream: the prompt carries the original prompt plus the
        delivered tokens and the offset moves the sampler past them.
        Never retried (generation is not idempotent).
        ``tenant``/``priority_class`` ride the optional uint8 tenant
        descriptor; omitted, the frame is the pre-tenancy one."""
        if trace_id is None:
            trace_id = self.make_trace_id()
        self.last_trace_id = trace_id
        eff = deadline_s if deadline_s is not None else self._deadline_s
        body = struct.pack(
            "<IIfI", int(max_new_tokens),
            0xFFFFFFFF if eos_token_id is None else int(eos_token_id),
            float(temperature), int(seed))
        arrays = [np.ascontiguousarray(prompt_ids, dtype=np.int32)]
        if sample_offset:
            arrays.append(np.asarray([int(sample_offset)], np.int32))
        if tenant is not None or priority_class is not None:
            from ..serving_llm import tenancy
            arrays.append(tenancy.encode_descriptor(
                tenant or tenancy.DEFAULT_TENANT,
                priority_class or tenancy.DEFAULT_CLASS))
        body += encode_tensors(arrays)
        with self._rcond:
            gen = self._gen
        tag = self._send_frame(self._MAGIC_STREAM,
                               struct.pack("<Q", trace_id) + body)
        delivered: List[int] = []
        while True:
            deadline = None if eff is None \
                else time.monotonic() + float(eff)
            try:
                status, payload = self._recv(tag, gen, deadline)
            except TimeoutError as e:
                # silent stream: the server may still write chunks for
                # this tag later, so the connection is unusable
                self._poison(gen)
                raise StreamTimeout(
                    f"stream silent past the per-chunk deadline "
                    f"after {len(delivered)} token(s): {e}",
                    delivered_tokens=delivered) from e
            except ConnectionError as e:
                raise StreamConnectionLost(
                    f"stream connection lost after {len(delivered)} "
                    f"token(s): {e}",
                    delivered_tokens=delivered) from e
            if status == 1:
                chunk = decode_tensors(payload)[0]
                delivered.extend(int(t) for t in chunk.reshape(-1))
                yield chunk
            elif status == 0:
                return
            else:
                raise RuntimeError(f"server error: {payload.decode()!r}")

    def generate(self, prompt_ids, retry: bool = True,
                 **kw) -> np.ndarray:
        """The whole generated int32 sequence of one
        :meth:`generate_stream`. Retries ONCE when the stream dies
        before its first chunk (then the request is still idempotent);
        after the first chunk the error is raised."""
        chunks: List[np.ndarray] = []

        def attempt():
            # a known-dead socket is repaired first (nothing was sent)
            with self._conn_lock:
                with self._rcond:
                    dead = self._sock is None
                if dead:
                    try:
                        self._connect()
                    except OSError as e:
                        raise ConnectionError(
                            f"reconnect to {self._host}:{self._port} "
                            f"failed: {e}") from e
            for c in self.generate_stream(prompt_ids, **kw):
                chunks.append(c)

        try:
            attempt()
        except (TimeoutError, ConnectionError):
            if not retry or chunks:
                raise
            attempt()
        if not chunks:
            return np.zeros((0,), np.int32)
        return np.concatenate(chunks)

    # -- wire -------------------------------------------------------------

    def _send(self, arrays: Sequence, trace_id: Optional[int] = None) -> int:
        """Send one tensor request ('PTSR' with a trace id, whose payload
        starts with the LE u64 id; else 'PTSV'); returns its tag."""
        payload = encode_tensors(arrays)
        if trace_id:
            return self._send_frame(self._MAGIC_TRACE,
                                    struct.pack("<Q", trace_id) + payload)
        return self._send_frame(self._MAGIC, payload)

    def _send_frame(self, magic: int, payload: bytes) -> int:
        with self._wlock:
            with self._rcond:
                sock = self._sock
            if sock is None:
                raise ConnectionError("not connected")
            self._tag += 1
            tag = self._tag
            sock.sendall(struct.pack("<IQI", magic, tag, len(payload))
                         + payload)
        return tag

    def _recv(self, want_tag: int, gen: Optional[int] = None,
              deadline: Optional[float] = None) -> Tuple[int, bytes]:
        # one thread at a time owns the socket's read side (_rlock) and
        # parks frames for the others, who wait on the condition
        if gen is None:
            with self._rcond:
                gen = self._gen
        while True:
            with self._rcond:
                if want_tag in self._replies:
                    return self._replies.pop(want_tag)
                if self._gen != gen or self._sock is None:
                    raise ConnectionError("connection lost")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    "deadline exceeded waiting for server reply")
            if not self._rlock.acquire(blocking=False):
                with self._rcond:
                    if want_tag in self._replies:
                        return self._replies.pop(want_tag)
                    if self._gen != gen or self._sock is None:
                        raise ConnectionError("connection lost")
                    self._rcond.wait(timeout=0.05)
                continue
            try:
                with self._rcond:
                    if want_tag in self._replies:
                        return self._replies.pop(want_tag)
                    if self._gen != gen or self._sock is None:
                        raise ConnectionError("connection lost")
                    sock = self._sock
                try:
                    if deadline is not None:
                        sock.settimeout(max(
                            0.001, min(self._timeout_s,
                                       deadline - time.monotonic())))
                    else:
                        sock.settimeout(self._timeout_s)
                    hdr = self._read_exact(sock, 8 + 8 + 4)
                    tag, status, n = struct.unpack("<QqI", hdr)
                    payload = self._read_exact(sock, n) if n else b""
                except socket.timeout as e:
                    # mid-frame timeout: the stream position is lost
                    self._poison(gen)
                    raise TimeoutError(
                        "deadline exceeded waiting for server reply"
                    ) from e
                except (ConnectionError, OSError) as e:
                    self._poison(gen)
                    raise ConnectionError(str(e)) from e
                with self._rcond:
                    self._replies[tag] = (status, payload)
                    self._rcond.notify_all()
            finally:
                self._rlock.release()

    @staticmethod
    def _read_exact(sock: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed connection")
            buf += chunk
        return buf

    def close(self) -> None:
        with self._rcond:
            sock, self._sock = self._sock, None
            self._rcond.notify_all()
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass  # the fd is dropped either way

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
