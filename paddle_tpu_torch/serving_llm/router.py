"""Front-door router: health-gated fan-out of the serving wire over N
backends, with deterministic mid-stream failover.

Counterpart of ``paddle_tpu.serving_llm.router``. A thin stdlib TCP
front that speaks the PTSV/PTSC/PTSR/PTST frames of
``docs/serving_protocol.md`` on both sides and spreads work over a pool
of ``inference.Server`` backends (of either package: the wire is the
same):

* **Health-gated pool** (:class:`BackendPool`): a probe thread runs a
  STATS round trip against every backend. Each backend has a
  :class:`CircuitBreaker`: consecutive connect/deadline failures trip it
  ``closed -> open`` with exponential backoff; after the backoff a
  single half-open probe decides recovery. A backend that answers but
  reports ``serving.draining=1`` leaves rotation as ``draining``, with
  its breaker untouched.
* **Deterministic mid-stream failover**: the router records each
  stream's prompt, sampling parameters and delivered tokens. When a
  backend dies mid-stream it re-issues prompt + delivered on a survivor
  with ``sample_offset=len(delivered)``; the engine's position-keyed
  sampler then continues the stream bit for bit. At most
  ``router_failover_budget`` failovers a stream.
* **Retry and shed**: a stream that delivered no token may be retried
  on another backend with jittered backoff (``router_retry_budget``); a
  started stream is only ever failed over. Admission refusals' retry
  hints are collected, and when every backend is saturated the router
  sheds at the door with the largest hint; ``bulk`` sheds on the first
  saturated answer, ``premium`` re-sweeps the pool up to the retry
  budget.
* **Prefix affinity** (``router_prefix_affinity``): a prompt goes to
  the backend that served the longest recorded prefix of its leading
  KV blocks, else by class-weighted load.

Observability, as the JAX router's (with FLAGS_enable_metrics on): the
``router_backend_state{backend=}`` and ``router_streams_active`` gauges,
the ``router_{shed,retries,failovers}_total`` counters, the flight
records of backend transitions, sheds and failovers, and a per-hop
request span (``kind=router_stream``) riding the client's trace id. The
router's own counters are in its STATS reply and ``snapshot()`` either
way, and every started router is in the module-level registry that
:func:`snapshot_all` reads (the exporter's ``GET /router``).
"""

from __future__ import annotations

import random
import socket
import struct
import threading
import time
import weakref
import zlib
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence as Seq, Tuple

import numpy as np

from .. import inference as _inf
from .. import observability as obs
from ..flags import GLOBAL_FLAGS
from ..observability import flight as _flight
from ..observability import reqtrace as _reqtrace
from . import tenancy

__all__ = ["CircuitBreaker", "Backend", "BackendPool", "Router",
           "snapshot_all"]

# wire constants, as inference.Client's
_MAGIC = 0x56535450         # 'PTSV' tensor request
_MAGIC_CTL = 0x43535450     # 'PTSC' control frame
_MAGIC_TRACE = 0x52535450   # 'PTSR' traced tensor request
_MAGIC_STREAM = 0x54535450  # 'PTST' streaming generate request
_OP_STATS = 1
_HDR = struct.Struct("<IQI")       # magic | tag | payload len
_REPLY = struct.Struct("<QqI")     # tag | status | payload len
_GEN_HDR = struct.Struct("<IIfI")  # max_new | eos | temperature | seed
_EOS_NONE = 0xFFFFFFFF
_MAX_PAYLOAD = 64 * 1024 * 1024
_CONNECT_TIMEOUT_S = 5.0
_PROBE_DEADLINE_S = 2.0
# prefix-affinity map bounds: at most _AFFINITY_BLOCKS leading full KV
# blocks hashed per prompt, at most _AFFINITY_CAP prefixes held (LRU)
_AFFINITY_BLOCKS = 32
_AFFINITY_CAP = 4096

# rotation states as the STATS text codes them; in rotation is code 0
STATE_CODES = {"closed": 0, "draining": 1, "unhealthy": 2,
               "half_open": 3, "open": 4}


def _flag(name: str):
    return GLOBAL_FLAGS.get(name)


class _ClientGone(Exception):
    """The router-to-client socket died; abandon the stream quietly."""


# -- circuit breaker ------------------------------------------------------


class CircuitBreaker:
    """Per-backend breaker: ``closed -> open`` on
    ``router_breaker_threshold`` consecutive failures, with an open-state
    backoff that doubles per re-open (capped at
    ``router_breaker_backoff_max_s``); once it elapses ONE caller wins
    the half-open probe slot and its outcome decides recovery (closed,
    reset) or re-open (doubled). All timing goes through the injectable
    monotonic ``clock``; the flags are read per decision unless given."""

    def __init__(self, threshold: Optional[int] = None,
                 backoff_s: Optional[float] = None,
                 backoff_max_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._threshold = threshold
        self._backoff_s = backoff_s
        self._backoff_max_s = backoff_max_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"      # guarded-by: self._lock
        self._failures = 0          # guarded-by: self._lock
        self._open_until = 0.0      # guarded-by: self._lock
        self._backoff = 0.0         # guarded-by: self._lock
        self.opened_total = 0       # guarded-by: self._lock

    def _threshold_v(self) -> int:
        if self._threshold is not None:
            return int(self._threshold)
        return max(1, int(_flag("router_breaker_threshold")))

    def _base_backoff(self) -> float:
        if self._backoff_s is not None:
            return float(self._backoff_s)
        return float(_flag("router_breaker_backoff_s"))

    def _max_backoff(self) -> float:
        if self._backoff_max_s is not None:
            return float(self._backoff_max_s)
        return float(_flag("router_breaker_backoff_max_s"))

    @property
    def state(self) -> str:
        with self._lock:
            if self._state == "open" and self._clock() >= self._open_until:
                return "half_open"  # probe slot available but unclaimed
            return self._state

    @property
    def failures(self) -> int:
        with self._lock:
            return self._failures

    def allow(self) -> bool:
        """May the caller contact the backend now? Closed: always. Open:
        once the backoff elapsed, and then exactly ONE caller wins the
        probe slot (state ``half_open``); the rest fast-fail until the
        probe reports back."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open" and self._clock() >= self._open_until:
                self._state = "half_open"
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._state = "closed"
            self._failures = 0
            self._backoff = 0.0

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == "half_open":
                self._open(doubled=True)
            elif self._state == "closed" \
                    and self._failures >= self._threshold_v():
                self._open(doubled=False)
            # open: a failure from a path that predates the trip keeps
            # the clock running without extending the backoff

    # holds-lock: self._lock
    def _open(self, doubled: bool) -> None:
        base = self._base_backoff()
        self._backoff = base if (not doubled or self._backoff <= 0) \
            else min(self._backoff * 2.0, self._max_backoff())
        self._open_until = self._clock() + self._backoff
        self._state = "open"
        self.opened_total += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"state": self._state, "failures": self._failures,
                    "backoff_s": round(self._backoff, 3),
                    "opened_total": self.opened_total}


# -- backend + pool -------------------------------------------------------


class Backend:
    """One serving backend: wire address, optional exporter healthz
    address, breaker, and the probe-maintained rotation state."""

    def __init__(self, host: str, port: int,
                 healthz: Optional[Tuple[str, int]] = None,
                 name: Optional[str] = None,
                 breaker: Optional[CircuitBreaker] = None):
        self.host = host
        self.port = int(port)
        self.healthz = healthz
        self.name = name or f"{host}:{port}"
        self.breaker = breaker or CircuitBreaker()
        self._lock = threading.Lock()
        self.draining = False        # guarded-by: self._lock
        self.unhealthy = False       # guarded-by: self._lock
        self.streams_active = 0      # guarded-by: self._lock
        self.last_probe_unix: Optional[float] = None
        self.last_error: Optional[str] = None

    def state(self) -> str:
        """Rotation state, breaker first: a tripped breaker wins over a
        drain flag a probe saw before the process died."""
        bs = self.breaker.state
        if bs != "closed":
            return bs
        with self._lock:
            if self.draining:
                return "draining"
            if self.unhealthy:
                return "unhealthy"
        return "closed"

    def in_rotation(self) -> bool:
        return self.state() == "closed"

    def set_health(self, draining: bool, unhealthy: bool) -> None:
        with self._lock:
            self.draining = bool(draining)
            self.unhealthy = bool(unhealthy)

    def mark_draining(self) -> None:
        with self._lock:
            self.draining = True

    def stream_delta(self, d: int) -> int:
        with self._lock:
            self.streams_active += d
            return self.streams_active

    def snapshot(self) -> Dict[str, Any]:
        st = self.state()
        with self._lock:
            return {"name": self.name, "state": st,
                    "state_code": STATE_CODES[st],
                    "draining": self.draining,
                    "unhealthy": self.unhealthy,
                    "streams_active": self.streams_active,
                    "breaker": self.breaker.snapshot(),
                    "last_probe_unix": self.last_probe_unix,
                    "last_error": self.last_error}


def _default_probe(backend: Backend) -> Dict[str, Any]:
    """One STATS round trip (answered by the backend's reader thread
    even when its queue is full; it carries ``serving.draining``).
    Raises on a connect or deadline failure: breaker food. The healthz
    reading is None: the port has no exporter yet."""
    cli = _inf.Client(backend.host, backend.port,
                      timeout_s=_PROBE_DEADLINE_S,
                      deadline_s=_PROBE_DEADLINE_S,
                      max_reconnects=0, traced=False)
    try:
        return {"stats": cli.stats(deadline_s=_PROBE_DEADLINE_S),
                "healthz": None}
    finally:
        cli.close()


class BackendPool:
    """Round-robin rotation over the healthy subset, kept by a periodic
    probe thread. ``probe`` is injectable (scripted answers in tests)."""

    def __init__(self, backends: Seq[Backend],
                 probe: Optional[Callable[[Backend], Dict[str, Any]]] = None,
                 probe_interval_s: Optional[float] = None):
        self.backends: List[Backend] = list(backends)
        self._probe = probe or _default_probe
        self._interval = probe_interval_s
        self._lock = threading.Lock()
        self._rr = 0                 # guarded-by: self._lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        for b in self.backends:
            self._set_gauge(b)

    # -- rotation ---------------------------------------------------------

    def pick(self, exclude: Seq[Backend] = ()) -> Optional[Backend]:
        """Next in-rotation backend after the round-robin pointer,
        skipping ``exclude`` (backends this stream already burned); None
        when nothing is eligible."""
        excluded = set(id(b) for b in exclude)
        with self._lock:
            n = len(self.backends)
            for i in range(n):
                b = self.backends[(self._rr + i) % n]
                if id(b) in excluded:
                    continue
                if b.in_rotation():
                    self._rr = (self._rr + i + 1) % n
                    return b
        return None

    def available(self) -> int:
        return sum(1 for b in self.backends if b.in_rotation())

    # -- probe loop -------------------------------------------------------

    def interval_s(self) -> float:
        if self._interval is not None:
            return float(self._interval)
        return float(_flag("router_probe_interval_s"))

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._probe_loop, name="router-probe", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.interval_s()):
            self.probe_once()

    def probe_once(self) -> None:
        for b in self.backends:
            if self._stop.is_set():
                return
            self._probe_one(b)

    def _probe_one(self, b: Backend) -> None:
        # the breaker gates probes too: while open the backend is left
        # alone; the first probe after the backoff is the half-open one
        before = b.state()
        if b.breaker.allow():
            try:
                out = self._probe(b)
            except (OSError, ConnectionError, TimeoutError,
                    RuntimeError) as e:
                b.last_error = f"{type(e).__name__}: {e}"[:200]
                b.breaker.record_failure()
            else:
                stats = out.get("stats") or {}
                hz = out.get("healthz")
                b.set_health(
                    draining=(int(stats.get("serving.draining", 0)) > 0
                              or hz == 503),
                    unhealthy=(hz is not None and hz not in (200, 503)))
                b.last_error = None
                b.breaker.record_success()
        b.last_probe_unix = time.time()
        self.note_transition(b, before)

    # -- the router's data path reports here ------------------------------

    def note_failure(self, b: Backend, error: str = "") -> None:
        """A data-path connect/deadline failure: breaker food."""
        before = b.state()
        if error:
            b.last_error = error[:200]
        b.breaker.record_failure()
        self.note_transition(b, before)

    def note_success(self, b: Backend) -> None:
        before = b.state()
        b.breaker.record_success()
        self.note_transition(b, before)

    def note_draining(self, b: Backend) -> None:
        """The backend answered with a drain refusal: out of rotation,
        breaker untouched (drain is not death)."""
        before = b.state()
        b.mark_draining()
        self.note_transition(b, before)

    def note_transition(self, b: Backend, before: str) -> None:
        after = b.state()
        self._set_gauge(b)
        if after != before:
            _flight.record("router_backend_transition", backend=b.name,
                           before=before, after=after,
                           failures=b.breaker.failures)

    def _set_gauge(self, b: Backend) -> None:
        if obs.enabled():
            obs.gauge("router_backend_state",
                      "router rotation state per backend: 0=closed "
                      "(in rotation), 1=draining, 2=unhealthy, "
                      "3=half_open, 4=open (breaker tripped)"
                      ).set(STATE_CODES[b.state()], backend=b.name)

    def snapshot(self) -> List[Dict[str, Any]]:
        return [b.snapshot() for b in self.backends]


# -- router ---------------------------------------------------------------


def _parse_backend(spec) -> Backend:
    """``Backend`` | ``(host, port)`` | ``"host:port[:healthzport]"``."""
    if isinstance(spec, Backend):
        return spec
    if isinstance(spec, (tuple, list)):
        return Backend(spec[0], int(spec[1]))
    parts = str(spec).split(":")
    if len(parts) == 2:
        return Backend(parts[0], int(parts[1]))
    if len(parts) == 3:
        return Backend(parts[0], int(parts[1]),
                       healthz=(parts[0], int(parts[2])))
    raise ValueError(f"bad backend spec {spec!r} "
                     "(want host:port[:healthzport])")


def _retry_hint(msg: str) -> Optional[int]:
    """The ``retry_after_ms=N`` hint of an admission refusal."""
    marker = "retry_after_ms="
    i = msg.find(marker)
    if i < 0:
        return None
    j = k = i + len(marker)
    while k < len(msg) and msg[k].isdigit():
        k += 1
    return int(msg[j:k]) if k > j else None


# live routers for the exporter's GET /router endpoint
_ROUTERS: "weakref.WeakSet[Router]" = weakref.WeakSet()


def snapshot_all() -> List[Dict[str, Any]]:
    """JSON-ready snapshots of every live router in this process
    (the exporter's ``GET /router`` body)."""
    outs = [r.snapshot() for r in list(_ROUTERS)]
    outs.sort(key=lambda s: s.get("addr", ""))
    return outs


class Router:
    """The front door: accepts client connections speaking the serving
    frames and fans work out over the pool.

    * PTSC STATS: answered here (router counters and each backend's
      state code as ``key=int`` lines, which ``Client.stats()`` reads).
    * PTSV / PTSR: proxied to one backend; idempotent, so connect and
      deadline failures retry on another within the retry budget.
    * PTST: the failover state machine (``_serve_stream``)."""

    # the bound on stop()'s join of the stream threads, seconds
    STOP_JOIN_S = 5.0

    def __init__(self, backends: Seq,
                 host: str = "127.0.0.1", port: int = 0,
                 pool: Optional[BackendPool] = None,
                 probe_interval_s: Optional[float] = None,
                 start_probes: bool = True):
        self.pool = pool or BackendPool(
            [_parse_backend(b) for b in backends],
            probe_interval_s=probe_interval_s)
        self._host = host
        self._port = int(port)
        self._start_probes = start_probes
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._conns: set = set()          # guarded-by: self._lock
        self._streams_active = 0          # guarded-by: self._lock
        self._stream_threads: set = set()  # guarded-by: self._lock
        # guarded-by: self._lock
        self._counts = {"failovers": 0, "retries": 0, "shed": 0,
                        "streams": 0, "proxied": 0}
        # prefix-affinity map: crc32 of leading full prompt blocks ->
        # backend name, LRU-bounded. guarded-by: self._lock
        self._affinity: "OrderedDict[int, str]" = OrderedDict()
        self._t0 = time.monotonic()

    # -- lifecycle --------------------------------------------------------

    @property
    def port(self) -> int:
        return self._port

    @property
    def addr(self) -> str:
        return f"{self._host}:{self._port}"

    def start(self) -> "Router":
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self._host, self._port))
        s.listen(128)
        self._port = s.getsockname()[1]
        self._sock = s
        self._stop.clear()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="router-accept", daemon=True)
        self._accept_thread.start()
        if self._start_probes:
            self.pool.start()
        _ROUTERS.add(self)
        _flight.record("router_start", addr=self.addr,
                       backends=[b.name for b in self.pool.backends])
        return self

    def stop(self) -> None:
        self._stop.set()
        self.pool.stop()
        s, self._sock = self._sock, None
        if s is not None:
            # shutdown wakes the accept() blocked on the listener
            for close in (lambda: s.shutdown(socket.SHUT_RDWR), s.close):
                try:
                    close()
                # ptlint: disable=silent-failure -- teardown: the listener fd is gone either way
                except OSError:
                    pass
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            try:
                c.close()
            # ptlint: disable=silent-failure -- teardown: peer may already be gone
            except OSError:
                pass  # the peer may be gone already
        t, self._accept_thread = self._accept_thread, None
        if t is not None:
            t.join(timeout=5.0)
        # a stream sends its end frame before its finally lowers
        # router_streams_active: join the stream threads (their
        # connections are closed above, so each ends at its next write),
        # so that the gauge reads 0 once stop() returns
        with self._lock:
            streams, self._stream_threads = self._stream_threads, set()
        deadline = time.monotonic() + self.STOP_JOIN_S
        for st in streams:
            st.join(timeout=max(0.0, deadline - time.monotonic()))
        _ROUTERS.discard(self)

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- flag knobs (read per decision) -----------------------------------

    def _failover_budget(self) -> int:
        return max(0, int(_flag("router_failover_budget")))

    def _retry_budget(self) -> int:
        return max(0, int(_flag("router_retry_budget")))

    def _retry_backoff_s(self) -> float:
        return float(_flag("router_retry_backoff_s"))

    def _backend_deadline_s(self) -> float:
        return float(_flag("router_backend_deadline_s"))

    @staticmethod
    def _sat_persistence(cls: str) -> int:
        """Extra full-pool sweeps once every backend answered
        "saturated": premium persists for the retry budget, the rest
        shed after one pass (bulk sheds even earlier, in
        ``_serve_stream``)."""
        if tenancy.class_rank(cls) >= tenancy.class_rank("premium"):
            return max(0, int(_flag("router_retry_budget")))
        return 0

    # -- backend selection (prefix affinity + class-weighted load) --------

    def _pick_backend(self, burned: List[Backend], prompt: np.ndarray,
                      cls: str) -> Optional[Backend]:
        """One backend for the next attempt. ``router_prefix_affinity``
        off: round-robin. On: the backend holding the longest recorded
        prompt-block prefix; on a miss premium takes the least-loaded
        backend, bulk packs onto the most-loaded one, standard keeps
        round-robin. The choice is recorded for the prompt's prefixes
        either way."""
        if not bool(_flag("router_prefix_affinity")):
            return self.pool.pick(exclude=burned)
        keys = self._prefix_keys(prompt)
        with self._lock:
            name = next((self._affinity[k] for k in keys
                         if k in self._affinity), None)
        b = None
        if name is not None:
            b = next((x for x in self.pool.backends
                      if x.name == name and x.in_rotation()
                      and x not in burned), None)
        if b is None:
            cands = [x for x in self.pool.backends
                     if x.in_rotation() and x not in burned]
            if not cands:
                return None
            rank = tenancy.class_rank(cls)
            if rank >= tenancy.class_rank("premium"):
                b = min(cands, key=lambda x: x.stream_delta(0))
            elif rank <= tenancy.class_rank("bulk"):
                b = max(cands, key=lambda x: x.stream_delta(0))
            else:
                b = self.pool.pick(exclude=burned)
        return self._record_affinity(keys, b)

    def _prefix_keys(self, prompt: np.ndarray) -> List[int]:
        """crc32 keys of the leading full KV blocks of ``prompt``
        (``kv_block_size`` tokens each, at most ``_AFFINITY_BLOCKS``),
        longest prefix first."""
        bs = int(_flag("kv_block_size"))
        if bs <= 0:
            return []
        nb = min(len(prompt) // bs, _AFFINITY_BLOCKS)
        raw = np.asarray(prompt[:nb * bs], np.int32).tobytes()
        return [zlib.crc32(raw[:j * bs * 4]) for j in range(nb, 0, -1)]

    def _record_affinity(self, keys: List[int],
                         b: Optional[Backend]) -> Optional[Backend]:
        if b is None or not keys:
            return b
        with self._lock:
            for k in keys:
                self._affinity[k] = b.name
                self._affinity.move_to_end(k)
            while len(self._affinity) > _AFFINITY_CAP:
                self._affinity.popitem(last=False)
        return b

    # -- accept / frame loop ----------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except (OSError, AttributeError):
                return  # listener closed by stop()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="router-conn", daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        wlock = threading.Lock()
        try:
            while not self._stop.is_set():
                hdr = _recv_exact(conn, _HDR.size)
                if hdr is None:
                    return
                magic, tag, ln = _HDR.unpack(hdr)
                if ln > _MAX_PAYLOAD:
                    _discard_exact(conn, ln)
                    self._reply(conn, wlock, tag, -2, b"payload too large")
                    continue
                payload = _recv_exact(conn, ln)
                if payload is None and ln:
                    return
                self._dispatch(conn, wlock, magic, tag, payload or b"")
        except (OSError, _ClientGone):
            return  # the client went away; nothing to answer
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            # ptlint: disable=silent-failure -- teardown: peer may already be gone
            except OSError:
                pass

    def _dispatch(self, conn, wlock, magic: int, tag: int,
                  payload: bytes) -> None:
        if magic == _MAGIC_CTL:
            (op,) = struct.unpack_from("<I", payload, 0)
            if op == _OP_STATS:
                self._reply(conn, wlock, tag, 0,
                            self._stats_text().encode())
            else:
                self._reply(conn, wlock, tag, -4,
                            f"unknown control op {op}".encode())
        elif magic in (_MAGIC, _MAGIC_TRACE):
            trace_id = 0
            if magic == _MAGIC_TRACE:
                (trace_id,) = struct.unpack_from("<Q", payload, 0)
                payload = payload[8:]
            self._proxy_infer(conn, wlock, tag, trace_id, payload)
        elif magic == _MAGIC_STREAM:
            try:
                (trace_id,) = struct.unpack_from("<Q", payload, 0)
                max_new, eos_raw, temp, seed = _GEN_HDR.unpack_from(
                    payload, 8)
                arrs = _inf.decode_tensors(payload[8 + _GEN_HDR.size:])
                prompt = np.asarray(arrs[0], np.int32).reshape(-1)
                # optional tails, told apart by dtype as the bridge does:
                # int32 [1] resume offset, uint8 tenant descriptor
                base_offset = 0
                tenant_cls: Optional[Tuple[str, str]] = None
                for arr in arrs[1:]:
                    dtype = getattr(arr, "dtype", None)
                    if dtype == np.int32 and arr.size == 1:
                        base_offset = int(arr.reshape(-1)[0])
                    elif dtype == np.uint8:
                        tenant_cls = tenancy.decode_descriptor(arr)
            except Exception as e:  # noqa: BLE001 — fail ONE request
                self._reply(conn, wlock, tag, -1,
                            f"router: bad generate body: {e}".encode())
                return
            t = threading.Thread(
                target=self._serve_stream,
                args=(conn, wlock, tag, trace_id, prompt, int(max_new),
                      None if eos_raw == _EOS_NONE else int(eos_raw),
                      float(temp), int(seed), base_offset, tenant_cls),
                name="router-stream", daemon=True)
            with self._lock:
                # stop() joins what is left of these
                self._stream_threads = {
                    s for s in self._stream_threads if s.is_alive()}
                self._stream_threads.add(t)
            t.start()
        else:
            self._reply(conn, wlock, tag, -4,
                        f"unknown magic 0x{magic:08x}".encode())

    def _reply(self, conn, wlock, tag: int, status: int,
               payload: bytes = b"") -> None:
        with wlock:
            conn.sendall(_REPLY.pack(tag, status, len(payload)) + payload)

    def _backend_client(self, b: Backend) -> "_inf.Client":
        # fast connect failure, patient reads: a cold backend's first
        # request must not read as a dead one
        return _inf.Client(b.host, b.port,
                           timeout_s=self._backend_deadline_s(),
                           connect_timeout_s=_CONNECT_TIMEOUT_S,
                           deadline_s=self._backend_deadline_s(),
                           max_reconnects=0, traced=False)

    # -- PTSV/PTSR proxy (idempotent: retried) ----------------------------

    def _proxy_infer(self, conn, wlock, tag: int, trace_id: int,
                     body: bytes) -> None:
        with self._lock:
            self._counts["proxied"] += 1
        tried: List[Backend] = []
        last_err = "no backend available"
        while True:
            b = self.pool.pick(exclude=tried)
            if b is None or len(tried) > self._retry_budget():
                self._reply(conn, wlock, tag, -1,
                            f"router: no backend available: "
                            f"{last_err}".encode())
                return
            if tried:
                self._count_retry(trace_id, tried[-1])
                self._sleep_jittered(len(tried))
            tried.append(b)
            try:
                cli = self._backend_client(b)
                try:
                    outs = cli.infer(_inf.decode_tensors(body),
                                     trace_id=trace_id or None)
                finally:
                    cli.close()
            except (ConnectionError, TimeoutError, OSError) as e:
                last_err = str(e)
                self.pool.note_failure(b, error=last_err)
                continue
            except RuntimeError as e:
                msg = str(e)
                if _is_drain_refusal(msg):
                    self.pool.note_draining(b)
                    last_err = msg
                    continue  # orderly refusal: next backend, no penalty
                self._reply(conn, wlock, tag, -1, msg.encode())
                return
            self.pool.note_success(b)
            self._reply(conn, wlock, tag, 0, _inf.encode_tensors(outs))
            return

    # -- PTST stream failover state machine -------------------------------

    def _serve_stream(self, conn, wlock, tag: int, trace_id: int,
                      prompt: np.ndarray, max_new: int,
                      eos: Optional[int], temp: float, seed: int,
                      base_offset: int,
                      tenant_cls: Optional[Tuple[str, str]] = None) -> None:
        tenant, cls = tenant_cls if tenant_cls is not None else (
            tenancy.DEFAULT_TENANT, tenancy.DEFAULT_CLASS)
        t_ingress = time.time()
        delivered: List[int] = []
        burned: List[Backend] = []
        hints: List[int] = []
        retries = failovers = sat_rounds = 0
        last_err = "no backend available"
        last_backend = ""
        dispatch_unix: Optional[float] = None

        def trace(outcome: str) -> None:
            self._trace(trace_id, t_ingress, dispatch_unix, last_backend,
                        delivered, retries, failovers, outcome, tenant,
                        cls)

        with self._lock:
            self._counts["streams"] += 1
            self._streams_active += 1
            self._set_streams_gauge()
        try:
            while True:
                b = self._pick_backend(burned, prompt, cls)
                if b is None:
                    if hints and not delivered:
                        # every backend answered "saturated": bulk shed
                        # already, standard re-sweeps once, premium to
                        # the retry budget
                        sat_rounds += 1
                        if sat_rounds <= self._sat_persistence(cls):
                            burned.clear()
                            self._sleep_jittered(sat_rounds)
                            continue
                        self._shed(conn, wlock, tag, trace_id, hints,
                                   tenant)
                        trace("shed")
                    else:
                        self._reply(
                            conn, wlock, tag, -1,
                            f"router: no backend available after "
                            f"{len(delivered)} token(s): "
                            f"{last_err}".encode())
                        trace("error")
                    return
                burned.append(b)
                last_backend = b.name
                if dispatch_unix is None:
                    dispatch_unix = time.time()
                try:
                    self._run_attempt(b, conn, wlock, tag, trace_id,
                                      prompt, delivered, max_new, eos,
                                      temp, seed, base_offset,
                                      tenant_cls)
                except _ClientGone:
                    return  # the backend connection is closed: its next
                    # chunk write fails and cancels the sequence
                except (ConnectionError, TimeoutError, OSError) as e:
                    # connect, deadline or mid-stream transport failure
                    # (StreamInterrupted is one of these): breaker food
                    last_err = str(e)
                    self.pool.note_failure(b, error=last_err)
                except RuntimeError as e:
                    msg = str(e)
                    if _is_drain_refusal(msg):
                        # orderly refusal: out of rotation without a
                        # breaker penalty, on to a survivor
                        last_err = msg
                        self.pool.note_draining(b)
                    elif _retry_hint(msg) is not None:
                        # saturated: keep the hint and try the next
                        # backend at once (the shed needs every answer);
                        # bulk sheds on the first saturated answer
                        hints.append(_retry_hint(msg))
                        last_err = msg
                        if not delivered and tenancy.class_rank(cls) \
                                <= tenancy.class_rank("bulk"):
                            self._shed(conn, wlock, tag, trace_id, hints,
                                       tenant)
                            trace("shed")
                            return
                        continue
                    else:
                        # the backend answered with an application error:
                        # forward it verbatim, nothing to retry
                        self._reply(conn, wlock, tag, -1,
                                    _strip_client_prefix(msg).encode())
                        trace("backend_error")
                        return
                else:
                    self._reply(conn, wlock, tag, 0, b"")
                    trace("ok")
                    return
                # an infra failure: a started stream fails over (resumed
                # with the offset), an unstarted one retries with backoff
                if delivered:
                    failovers += 1
                    if failovers > self._failover_budget():
                        self._reply(
                            conn, wlock, tag, -1,
                            f"router: failover budget exhausted after "
                            f"{len(delivered)} token(s): "
                            f"{last_err}".encode())
                        trace("failover_exhausted")
                        return
                    self._count_failover(trace_id, b, delivered)
                else:
                    retries += 1
                    if retries > self._retry_budget():
                        self._reply(conn, wlock, tag, -1,
                                    f"router: retry budget exhausted: "
                                    f"{last_err}".encode())
                        trace("retry_exhausted")
                        return
                    self._count_retry(trace_id, b)
                    self._sleep_jittered(retries)
        except OSError:
            return  # a reply write failed: the client is gone
        finally:
            with self._lock:
                self._streams_active -= 1
                self._set_streams_gauge()

    def _run_attempt(self, b: Backend, conn, wlock, tag: int,
                     trace_id: int, prompt: np.ndarray,
                     delivered: List[int], max_new: int,
                     eos: Optional[int], temp: float, seed: int,
                     base_offset: int,
                     tenant_cls: Optional[Tuple[str, str]] = None
                     ) -> None:
        """One backend attempt: forwards chunks as they arrive and
        appends them to ``delivered`` (the resume state). Raises the
        attempt's error; returns on the backend's clean terminal frame.
        A resumed attempt sends prompt + delivered with the sampler
        offset moved past them."""
        remaining = max_new - len(delivered)
        if remaining <= 0:
            return
        full_prompt = np.concatenate(
            [prompt, np.asarray(delivered, np.int32)]) \
            if delivered else prompt
        offset = base_offset + len(delivered)
        b.stream_delta(+1)
        cli = None
        try:
            cli = self._backend_client(b)
            # the tenant descriptor is forwarded only when the client
            # sent one, so tenant-less frames stay byte-identical
            tkw = {} if tenant_cls is None else {
                "tenant": tenant_cls[0], "priority_class": tenant_cls[1]}
            for chunk in cli.generate_stream(
                    full_prompt, max_new_tokens=remaining,
                    eos_token_id=eos, temperature=temp, seed=seed,
                    trace_id=trace_id or None, sample_offset=offset,
                    **tkw):
                toks = [int(t) for t in np.asarray(chunk).reshape(-1)]
                try:
                    self._reply(conn, wlock, tag, 1, _inf.encode_tensors(
                        [np.asarray(toks, np.int32)]))
                except OSError as e:
                    raise _ClientGone() from e
                delivered.extend(toks)
        finally:
            b.stream_delta(-1)
            if cli is not None:
                cli.close()
        self.pool.note_success(b)

    # -- shed / counters --------------------------------------------------

    def _shed(self, conn, wlock, tag: int, trace_id: int,
              hints: List[int], tenant: str = "") -> None:
        hint = max(hints)
        label = tenancy.tenant_label(tenant or tenancy.DEFAULT_TENANT)
        with self._lock:
            self._counts["shed"] += 1
        if obs.enabled():
            obs.counter("router_shed_total",
                        "streams refused at the router door because "
                        "every backend was saturated (the reply "
                        "carries the max retry_after_ms hint); "
                        "tenant= is the bounded tenant label, "
                        "default for tenant-less frames"
                        ).inc(tenant=label)
        _flight.record("router_shed", trace_id=trace_id,
                       retry_after_ms=hint, tenant=label)
        self._reply(conn, wlock, tag, -1,
                    f"router: all backends saturated: "
                    f"retry_after_ms={hint}".encode())

    def _count_retry(self, trace_id: int, b: Backend) -> None:
        with self._lock:
            self._counts["retries"] += 1
        if obs.enabled():
            obs.counter("router_retries_total",
                        "zero-token requests re-sent to another "
                        "backend after a connect/deadline failure "
                        "(started streams fail over instead)").inc()

    def _count_failover(self, trace_id: int, b: Backend,
                        delivered: List[int]) -> None:
        with self._lock:
            self._counts["failovers"] += 1
        if obs.enabled():
            obs.counter("router_failovers_total",
                        "started streams resumed on a surviving "
                        "backend after backend death (prompt+"
                        "delivered re-issued with the sample offset; "
                        "continuation is bitwise-exact)").inc()
        _flight.record("router_failover", trace_id=trace_id,
                       dead_backend=b.name, delivered=len(delivered))

    # holds-lock: self._lock
    def _set_streams_gauge(self) -> None:
        if obs.enabled():
            obs.gauge("router_streams_active",
                      "client streams currently held open by the "
                      "router (across all backends)"
                      ).set(self._streams_active)

    def _trace(self, trace_id: int, ingress_unix: float,
               dispatch_unix: Optional[float], backend: str,
               delivered: List[int], retries: int, failovers: int,
               outcome: str, tenant: str = "",
               cls: str = "") -> None:
        """Per-hop request span riding the client's trace id: joins
        against the backend's own span for the same id, so the router
        hop is visible beside it."""
        _reqtrace.record({
            "trace_id": trace_id, "kind": "router_stream",
            "ingress_unix": ingress_unix,
            "dispatch_unix": dispatch_unix,
            "reply_unix": time.time(),
            "backend": backend, "tokens": len(delivered),
            "retries": retries, "failovers": failovers,
            "outcome": outcome, "tenant": tenant, "cls": cls})

    def _sleep_jittered(self, attempt: int) -> None:
        base = self._retry_backoff_s()
        if base <= 0:
            return
        span = base * (2 ** max(0, attempt - 1))
        time.sleep(span * (0.5 + random.random() / 2.0))

    # -- stats / snapshot -------------------------------------------------

    def _stats_text(self) -> str:
        with self._lock:
            c = dict(self._counts)
            active = self._streams_active
        lines = [
            "router.proto_version=1",
            f"router.uptime_ms={int((time.monotonic() - self._t0) * 1e3)}",
            f"router.backends={len(self.pool.backends)}",
            f"router.available={self.pool.available()}",
            f"router.streams_active={active}",
            f"router.streams_total={c['streams']}",
            f"router.proxied_total={c['proxied']}",
            f"router.failovers_total={c['failovers']}",
            f"router.retries_total={c['retries']}",
            f"router.shed_total={c['shed']}",
        ]
        for i, b in enumerate(self.pool.backends):
            lines.append(
                f"router.backend.{i}.state={STATE_CODES[b.state()]}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """The router's state as a JSON-ready dict."""
        with self._lock:
            c = dict(self._counts)
            active = self._streams_active
        return {"addr": self.addr,
                "streams_active": active,
                "streams_total": c["streams"],
                "proxied_total": c["proxied"],
                "failovers_total": c["failovers"],
                "retries_total": c["retries"],
                "shed_total": c["shed"],
                "available": self.pool.available(),
                "backends": self.pool.snapshot()}


# -- wire helpers ---------------------------------------------------------


def _is_drain_refusal(msg: str) -> bool:
    return "draining" in msg or "server stopping" in msg


def _strip_client_prefix(msg: str) -> str:
    """Unwrap ``server error: '<payload>'`` (how a backend Client wraps
    an error payload) so the backend's payload goes out verbatim."""
    prefix = "server error: "
    if msg.startswith(prefix):
        body = msg[len(prefix):]
        if len(body) >= 2 and body[0] == body[-1] == "'":
            return body[1:-1]
    return msg


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Exactly ``n`` bytes; None on a clean EOF before the first byte;
    ConnectionError on EOF mid-object."""
    if n == 0:
        return b""
    chunks: List[bytes] = []
    got = 0
    while got < n:
        part = sock.recv(min(n - got, 1 << 20))
        if not part:
            if got == 0:
                return None
            raise ConnectionError("peer closed mid-frame")
        chunks.append(part)
        got += len(part)
    return b"".join(chunks)


def _discard_exact(sock: socket.socket, n: int) -> None:
    while n > 0:
        part = sock.recv(min(n, 1 << 20))
        if not part:
            raise ConnectionError("peer closed mid-frame")
        n -= len(part)
