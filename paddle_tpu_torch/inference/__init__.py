"""Inference: ``Config``/``Predictor`` over an exported program, the
tensor codec, ``Server`` and ``Client``.

Counterpart of ``paddle_tpu.inference``. Export a model with
``paddle_tpu_torch.jit.save(model, d, input_spec=[jit.InputSpec([None,
128], "int64", name="input_ids"), ...])`` (a ``torch.export`` program of
its eval forward, the kernels as the ``paddle_tpu_torch::`` operators),
then ``pred = create_predictor(Config(d))`` loads it onto the card
(``Config(d, device="cpu")`` for the CPU, as the tests run it) and
``pred.run([ids, types, mask])`` returns host arrays. With
``ir_optim`` on (the default) each batch is padded to a bucket of
``Config.batch_buckets()`` and, on the card, each bucket is one CUDA
graph, captured after one eager warm-up and replayed after;
``clone()`` shares the weights, the graphs and the run lock.

The native transport (``native.ServingTransport``: sockets, framing,
the bounded queue) takes the frames of ``docs/serving_protocol.md``;
:class:`Server` is the compute half on its own thread: it batches
concurrent tensor requests of one row signature into one
``predictor.run`` (``Server(pred, max_batch=16, wait_ms=2)``;
``Client(port=srv.port).infer([ids, types, mask])``), and hands every
streaming-generate ('PTST') frame to an ``LLMStreamBridge`` over an
``LLMEngine``, stepping the engine while generations are in flight and
admitting new prefills into the running decode batch (continuous
batching). :class:`Client` speaks the same frames. Both are byte for
byte the JAX package's: either package's client talks to either
package's server.

The server's telemetry is the JAX server's: the native stats
``serving.batches_total``, ``serving.batch_rows_total``,
``serving.batch_size_le_*`` and ``serving.batch_errors_total`` (in the
STATS reply), and with FLAGS_enable_metrics on ``serving_batch_size``,
``serving_requests_total``, ``serving_errors_total``, the
``serving_*_ms`` span histograms, ``requests_shed_total{kind=,tenant=}``,
the request span ring (``observability.reqtrace``: a record per tensor
request, ``ok``, ``decode_error`` or ``execute_error``, and per refused
or shed one; the bridge records each stream's) and the flight records
of sheds, drains and client reconnects. A server also brings up the
HTTP exporter (``observability.server.maybe_start``: metrics on and
``metrics_port`` >= 0) and a bridge thread that scrapes the native
transport's stats into the registry (``scrape_stats``: ``serving_*``
gauges and counters) every ``stats_interval_s``, once more at
``stop()``.
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

from .. import observability as obs
from ..core.dtype import convert_dtype
from ..flags import GLOBAL_FLAGS
from ..native import ServingTransport, stat_add, stat_reset
from ..observability import flight as _flight
from ..observability import reqtrace as _reqtrace

__all__ = ["Config", "PrecisionType", "Predictor", "create_predictor",
           "Tensor", "Server", "Client", "encode_tensors", "decode_tensors",
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


class PrecisionType:
    """(ref: paddle_api.h PaddlePrecision) The JAX package's names and
    values; ``Config.set_precision`` stores one and nothing reads it, as
    in the JAX package."""
    Float32 = "float32"
    Half = "bfloat16"
    Bfloat16 = "bfloat16"
    Int8 = "int8"


class Config:
    """Predictor configuration (ref: analysis_config.h AnalysisConfig).

    ``model_dir`` holds a ``jit.save`` artifact (``params/``,
    ``module.pt2``, ``meta.json``). ``device`` None means the card
    (``core.place.resolve_device``); pass ``"cpu"`` for the CPU."""

    def __init__(self, model_dir: str, device=None):
        self.model_dir = model_dir
        self._ir_optim = True
        self._memory_optim = True
        self._profile = False
        self._precision = PrecisionType.Float32
        self._max_batch_size = 64
        self._batch_buckets: Optional[List[int]] = None
        self._device = device

    # -- parity surface (reference names) --------------------------------
    def switch_ir_optim(self, on: bool = True) -> None:
        """On: each batch is padded to a shape bucket and, on the card,
        each bucket runs as one CUDA graph. Off: the exported program
        runs eagerly at each exact shape."""
        self._ir_optim = bool(on)

    def enable_memory_optim(self, on: bool = True) -> None:
        self._memory_optim = bool(on)

    def enable_profile(self) -> None:
        """Counts runs and their microseconds into the native stats
        ``inference.runs`` / ``inference.us``."""
        self._profile = True

    def set_precision(self, p: str) -> None:
        self._precision = p

    def set_max_batch_size(self, n: int) -> None:
        self._max_batch_size = int(n)

    def set_batch_buckets(self, sizes: Sequence[int]) -> None:
        """Explicit bucket ladder; default is powers of two up to
        max_batch_size."""
        self._batch_buckets = sorted(int(s) for s in sizes)

    def disable_glog_info(self) -> None:  # parity no-op
        pass

    def batch_buckets(self) -> List[int]:
        if self._batch_buckets:
            return self._batch_buckets
        out, b = [], 1
        while b < self._max_batch_size:
            out.append(b)
            b *= 2
        out.append(self._max_batch_size)
        return out


def _host_value(o):
    """A tensor as the host value the wire and the caller take: a numpy
    array, or a CPU tensor for bfloat16 (which numpy lacks)."""
    if not isinstance(o, torch.Tensor):
        return np.asarray(o)
    t = o.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


class Tensor:
    """Input/output handle (ref: paddle_api.h ZeroCopyTensor).

    Inputs: ``copy_from_cpu`` stages a host array (or a CPU tensor).
    Outputs: the value stays a device tensor until ``copy_to_cpu``."""

    def __init__(self, name: str, spec_shape: Tuple, dtype: str):
        self.name = name
        self._spec_shape = tuple(spec_shape)
        self._dtype = dtype
        self._value = None

    def copy_from_cpu(self, arr) -> None:
        if not isinstance(arr, torch.Tensor):
            arr = np.asarray(arr)
        if arr.ndim != len(self._spec_shape):
            raise ValueError(
                f"input {self.name}: rank {arr.ndim} does not match spec "
                f"{self._spec_shape}")
        for have, want in zip(arr.shape[1:], self._spec_shape[1:]):
            if want is not None and have != want:
                raise ValueError(
                    f"input {self.name}: shape {tuple(arr.shape)} does not "
                    f"match spec {self._spec_shape}")
        self._value = arr

    def reshape(self, shape) -> None:
        if self._value is not None:
            self._value = self._value.reshape(shape)

    def copy_to_cpu(self):
        if self._value is None:
            raise ValueError(f"tensor {self.name} has no value")
        return _host_value(self._value)

    @property
    def shape(self):
        return None if self._value is None else tuple(self._value.shape)


class _Shared:
    """What a predictor shares with its clones: the loaded program, the
    weights on the device, the captured graphs (one per input
    signature), their counters and the run lock. Also the owner
    ``static._capture`` books a capture to (``_backend``, ``captures``,
    ``capture_ms``)."""

    def __init__(self, config: Config) -> None:
        from .. import jit as jit_mod
        from ..static import _CudaGraphs
        translated = jit_mod.load(config.model_dir, config._device)
        self.meta = translated.meta
        self.device = translated.device
        self.module = translated._module
        self.params = translated._params
        self.buffers = translated._buffers
        self.graphs: Dict[tuple, Any] = {}
        self._backend = _CudaGraphs(self.device) \
            if self.device.type == "cuda" else None
        self.captures = 0
        self.capture_ms = 0.0
        self.run_lock = threading.Lock()

    def call(self, args):
        with torch.no_grad():
            return self.module(self.params, self.buffers, *args)

    def replay(self, args: List[torch.Tensor]):
        """The outputs of the graph of ``args``' signature (a CPU tensor
        each): copies them into its static inputs and replays it
        (``static._Graph.replay``, which adds the replay's kernel
        launches to the counters and clones the outputs). The first call
        of a signature runs the program eagerly on the capture's side
        stream (the warm-up, whose outputs it returns), then captures it
        into a graph. Hold ``run_lock``."""
        from ..static import _capture, _Graph
        key = tuple((tuple(a.shape), a.dtype) for a in args)
        graph = self.graphs.get(key)
        if graph is not None:
            return graph.replay(args)
        graph = _Graph([a.to(self.device) for a in args])
        out = self._backend.warm_up(lambda: self.call(graph.inputs))

        def body() -> None:
            graph.outputs = self.call(graph.inputs)

        _capture(self, graph, body)
        self.graphs[key] = graph
        return out


class Predictor:
    """Serving executor over a ``jit.save`` artifact
    (ref: analysis_predictor.cc AnalysisPredictor::Run/ZeroCopyRun).

    Loads the program with ``jit.load`` and moves the weights to the
    device once. With ``ir_optim`` on and every input's batch dim
    dynamic, a batch is padded up to ``config.batch_buckets()`` by
    repeating its last row, and the outputs sliced back; on the card
    each padded shape (a batch above the largest bucket keeps its own)
    is captured once as a CUDA graph after one eager warm-up, then
    replayed, the counterpart of one XLA executable per bucket; the CPU
    runs the program eagerly. With ``ir_optim`` off the program runs
    eagerly at each exact shape. A failed capture or launch raises;
    nothing runs eagerly or on the CPU instead. The host inputs reach
    the device by a plain copy into the graph's static inputs, outside
    any capture, and the outputs are copied out of the graph's under
    the run lock, which a clone shares with its parent (the next replay
    overwrites them). ``captures`` and ``capture_ms`` count the
    captures; each replay adds its graph's kernel launches to the
    counters (``kernels.launch_counts``). ``clone()`` shares the
    weights, the graphs and the run lock."""

    def __init__(self, config: Config, _shared: Optional[_Shared] = None):
        self.config = config
        self._shared = _Shared(config) if _shared is None else _shared
        specs = self._shared.meta["input_spec"]
        self._inputs = [Tensor(s.get("name", f"x{i}"), tuple(s["shape"]),
                               s["dtype"])
                        for i, s in enumerate(specs)]
        self._poly_batch = [bool(s["shape"]) and s["shape"][0] is None
                            for s in specs]
        self._outputs: List[Tensor] = []
        self._n_runs = 0

    @property
    def device(self) -> torch.device:
        return self._shared.device

    @property
    def captures(self) -> int:
        return self._shared.captures

    @property
    def capture_ms(self) -> float:
        return self._shared.capture_ms

    # -- reference API ---------------------------------------------------
    def get_input_names(self) -> List[str]:
        return [t.name for t in self._inputs]

    def get_input_handle(self, name: str) -> Tensor:
        for t in self._inputs:
            if t.name == name:
                return t
        raise KeyError(name)

    get_input_tensor = get_input_handle

    def get_output_names(self) -> List[str]:
        return [t.name for t in self._outputs]

    def get_output_handle(self, name: str) -> Tensor:
        for t in self._outputs:
            if t.name == name:
                return t
        raise KeyError(name)

    get_output_tensor = get_output_handle

    def run(self, inputs: Optional[Sequence] = None):
        """Execute. Either pass arrays positionally or stage them on the
        input handles first (zero-copy style). Returns host values (numpy
        arrays; CPU tensors for bfloat16) and fills the output handles,
        whose values stay on the device."""
        if inputs is not None:
            for t, a in zip(self._inputs, inputs):
                t.copy_from_cpu(a)
        args = [t._value for t in self._inputs]
        if any(a is None for a in args):
            missing = [t.name for t in self._inputs if t._value is None]
            raise ValueError(f"inputs not set: {missing}")
        t0 = time.perf_counter()
        outs = self._run_batched(args)
        self._n_runs += 1
        outs_list = list(outs) if isinstance(outs, (tuple, list)) else [outs]
        host = [_host_value(o) for o in outs_list]
        if self.config._profile:
            stat_add("inference.runs", 1)
            stat_add("inference.us", int((time.perf_counter() - t0) * 1e6))
        self._outputs = []
        for i, o in enumerate(outs_list):
            t = Tensor(f"out{i}", tuple(o.shape), str(o.dtype))
            t._value = o
            self._outputs.append(t)
        return host

    zero_copy_run = run

    def _host_args(self, args) -> List[torch.Tensor]:
        """The staged inputs as CPU tensors of their specs' dtypes (an
        integer input may come in another integer width, a float in
        another float width, as the JAX export takes them)."""
        out = []
        for t, a in zip(self._inputs, args):
            h = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(a))
            want = convert_dtype(t._dtype)
            if h.dtype != want:
                if h.dtype.is_floating_point != want.is_floating_point \
                        or h.dtype == torch.bool or want == torch.bool:
                    raise ValueError(f"input {t.name}: dtype {h.dtype} "
                                     f"does not match spec {t._dtype}")
                h = h.to(want)
            out.append(h)
        return out

    def _run_batched(self, args):
        batch = args[0].shape[0] if (args and self._poly_batch
                                     and self._poly_batch[0]) else None
        pad_to = None
        if (batch is not None and self.config._ir_optim
                and all(self._poly_batch)):
            for b in self.config.batch_buckets():
                if b >= batch:
                    pad_to = b
                    break
        host = self._host_args(args)
        if pad_to is not None and pad_to != batch:
            # repeat the final row: inert padding for any pointwise or
            # row-wise head (zeros can still NaN under 1/x-style heads)
            host = [torch.cat([a, a[-1:].expand(pad_to - a.shape[0],
                                                *a.shape[1:])])
                    for a in host]
        shared = self._shared
        with shared.run_lock:
            if shared._backend is not None and self.config._ir_optim:
                outs = shared.replay(host)
            else:
                outs = shared.call([a.to(shared.device) for a in host])
        if pad_to is not None and pad_to != batch:
            outs = _slice_leading(outs, batch)
        return outs

    def clone(self) -> "Predictor":
        return Predictor(self.config, _shared=self._shared)


def _slice_leading(outs, n):
    if isinstance(outs, (tuple, list)):
        return type(outs)(_slice_leading(o, n) for o in outs)
    return outs[:n] if hasattr(outs, "shape") and outs.ndim >= 1 else outs


def create_predictor(config: Config) -> Predictor:
    """(ref: paddle_infer::CreatePredictor / create_paddle_predictor)."""
    return Predictor(config)


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
    """Dynamic-batching serving loop over the native transport
    (csrc/serving.cc).

    Requests that arrive within ``wait_ms`` of each other (up to
    ``max_batch``) form a group. Tensor requests go to ``predictor`` (a
    :class:`Predictor`): the group's requests with the same per-row
    signature are concatenated along the batch dim, run as ONE bucketed
    ``predictor.run`` and the replies sliced back per request.
    Streaming-generate requests go to ``llm_engine`` (an ``LLMEngine``)
    through an ``LLMStreamBridge``. Either may be None: a request for
    the missing half gets an error reply. The loop runs on its own
    thread, so the device work does too: the predictor's (or a CUDA
    engine's) device is made current there. The server starts on
    construction; ``port`` 0 takes an ephemeral port (``.port``)."""

    # batch-size buckets published to the native stat registry (and the
    # STATS reply): cumulative "le" semantics like the Python histogram
    _BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)

    def __init__(self, predictor: Optional[Predictor] = None, port: int = 0,
                 max_batch: int = 32, wait_ms: int = 2, queue_cap: int = 512,
                 max_payload: int = 64 << 20,
                 queue_deadline_ms: Optional[int] = None,
                 llm_engine=None, stats_interval_s: float = 1.0):
        self.predictor = predictor
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
        # n_batches and n_requests count tensor batches and the requests
        # they answered; n_errors counts the requests of failed batches
        # and the failed engine steps
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
        # live observability: the flag-gated HTTP exporter, and a bridge
        # thread that scrapes the native transport's stats into the
        # metrics registry so server internals ride the same /metrics
        from ..observability import server as _obs_server
        _obs_server.maybe_start()
        self._stats_interval_s = max(0.05, float(stats_interval_s))
        self._bridge = threading.Thread(target=self._bridge_loop,
                                        daemon=True,
                                        name=f"serving-stats-{self.port}")
        self._bridge.start()

    def _bridge_loop(self) -> None:
        while not self._stop.wait(self._stats_interval_s):
            self.scrape_stats()
        self.scrape_stats()  # final snapshot so totals survive stop()

    def scrape_stats(self) -> Dict[str, int]:
        """One bridge pass: pull the native transport stats into the
        metrics registry (gauges for levels, set_total for the native
        monotonic counters). Returns the raw stats dict."""
        stats = self.transport.stats()
        if not stats or not obs.enabled():
            return stats
        gauges = {"queue_depth": "serving_queue_depth",
                  "inflight": "serving_inflight",
                  "connections_active": "serving_connections_active",
                  "queue_cap": "serving_queue_cap"}
        counters = {"accepted_total": "serving_accepted_total",
                    "replied_total": "serving_replied_total",
                    "reply_dropped_total": "serving_reply_dropped_total",
                    "oversized_total": "serving_oversized_total",
                    "connections_total": "serving_connections_total"}
        for key, name in gauges.items():
            if key in stats:
                obs.gauge(name, f"native serving transport {key}"
                          ).set(float(stats[key]))
        for key, name in counters.items():
            if key in stats:
                obs.counter(name, f"native serving transport {key}"
                            ).set_total(float(stats[key]))
        if "uptime_ms" in stats:
            obs.gauge("serving_uptime_seconds",
                      "native serving transport uptime"
                      ).set(stats["uptime_ms"] / 1e3)
        return stats

    def _queue_deadline_s(self) -> float:
        v = self.queue_deadline_ms
        if v is None:
            v = GLOBAL_FLAGS.get("serving_queue_deadline_ms")
        return max(0, int(v or 0)) / 1e3

    @staticmethod
    def _mk_req(r) -> Dict[str, Any]:
        """Wrap one transport dequeue into the request-span dict the loop
        threads through to the reply (reqtrace.STAMPS order)."""
        rid, payload, trace_id, ingress, is_stream = r
        return {"rid": rid, "payload": payload, "trace_id": trace_id,
                "ingress_unix": ingress, "dequeue_unix": time.time(),
                "dequeue_mono": time.monotonic(), "stream": is_stream}

    @staticmethod
    def _req_tenancy(req: Dict[str, Any]) -> Tuple[str, str]:
        """(tenant, class) of a request for shed accounting: a stream's
        optional uint8 tenant descriptor, else default/standard (tensor
        requests, malformed bodies, tenant-less frames). Memoized on the
        req dict (the bridge sets the same keys when it admits)."""
        from ..serving_llm import tenancy
        if "tenant" in req:
            return req["tenant"], req.get("class", tenancy.DEFAULT_CLASS)
        tenant, cls = tenancy.DEFAULT_TENANT, tenancy.DEFAULT_CLASS
        if req.get("stream"):
            hdr = struct.calcsize("<IIfI")
            try:
                arrs = decode_tensors(req["payload"][hdr:])
            except (ValueError, struct.error):
                arrs = []  # the bridge would reject it: default tenant
            for arr in arrs[1:]:
                if getattr(arr, "dtype", None) == np.uint8:
                    tenant, cls = tenancy.decode_descriptor(arr)
                    break
        req["tenant"], req["class"] = tenant, cls
        return tenant, cls

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
        _flight.record("serving_shed", force=True,
                       trace_id=req.get("trace_id"),
                       age_ms=round(age_s * 1e3, 3),
                       deadline_ms=round(deadline_s * 1e3, 3))
        self._count_shed(req)
        self._record_span(req, status=-1, outcome="shed",
                          reply_unix=time.time())

    def _count_shed(self, req: Dict[str, Any]) -> None:
        if obs.enabled():
            from ..serving_llm import tenancy
            tenant, _cls = self._req_tenancy(req)
            obs.counter("requests_shed_total",
                        "requests answered with an error because they "
                        "sat in the serving queue longer than the "
                        "queue deadline (kind=stream for PTST "
                        "generates, kind=tensor otherwise; tenant= is "
                        "the bounded tenant label, default for "
                        "tenant-less frames)").inc(
                kind="stream" if req.get("stream") else "tensor",
                tenant=tenancy.tenant_label(tenant))

    def _record_span(self, req: Dict[str, Any], status: int,
                     outcome: str,
                     dispatch_unix: Optional[float] = None,
                     reply_unix: Optional[float] = None,
                     batch_rows: Optional[int] = None,
                     batch_members: Optional[int] = None,
                     error: Optional[str] = None) -> None:
        """Close one tensor request's or refused request's span record
        (with metrics on): the queue-wait / assembly / compute /
        end-to-end spans, observed into the ``serving_*_ms`` histograms
        for a served request (status 0), and the record into the request
        ring. Served streams are recorded by the bridge."""
        if not obs.enabled():
            return
        rec = {"trace_id": req.get("trace_id") or 0,
               "req_id": req.get("rid"),
               "status": status, "outcome": outcome,
               "ingress_unix": req.get("ingress_unix"),
               "dequeue_unix": req.get("dequeue_unix"),
               "assembly_unix": req.get("assembly_unix"),
               "dispatch_unix": dispatch_unix,
               "reply_unix": reply_unix}
        if batch_rows is not None:
            rec["batch_rows"] = batch_rows
        if batch_members is not None:
            rec["batch_members"] = batch_members
        if error is not None:
            rec["error"] = error
        if "tenant" in req:  # streams: per-tenant gap attribution
            rec["tenant"] = req["tenant"]
            rec["cls"] = req.get("class")

        def span_ms(a, b):
            if rec.get(a) is None or rec.get(b) is None:
                return None
            return max(0.0, (rec[b] - rec[a]) * 1e3)

        rec["queue_wait_ms"] = span_ms("ingress_unix", "dequeue_unix")
        rec["batch_assembly_ms"] = span_ms("dequeue_unix",
                                           "assembly_unix")
        rec["compute_ms"] = span_ms("dispatch_unix", "reply_unix")
        rec["e2e_ms"] = span_ms("ingress_unix", "reply_unix")
        if status == 0:
            from ..observability import metrics as _m
            spans = {
                "serving_queue_wait_ms":
                    ("native-queue wait: frame ingress to batcher "
                     "dequeue", rec["queue_wait_ms"]),
                "serving_batch_assembly_ms":
                    ("dynamic-batch window: dequeue to batch close",
                     rec["batch_assembly_ms"]),
                "serving_compute_ms":
                    ("predictor dispatch to reply written (XLA run "
                     "+ scatter)", rec["compute_ms"]),
                "serving_e2e_ms":
                    ("whole server-side round trip: ingress to "
                     "reply written", rec["e2e_ms"]),
            }
            for name, (help_, v) in spans.items():
                if v is not None:
                    obs.histogram(name, help_,
                                  buckets=_m.LATENCY_MS_BUCKETS).observe(v)
        _reqtrace.record(rec)

    def _loop(self) -> None:
        # the current device is per thread, and the kernels launch on the
        # current stream of their tensors' device
        for dev in (getattr(self.predictor, "device", None),
                    self._llm.engine.device if self._llm is not None
                    else None):
            if dev is not None and dev.type == "cuda":
                torch.cuda.set_device(dev)
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
            for req in [r for r in group if r.get("stream")]:
                if self._llm is None:
                    self._refuse(req, b"server has no LLM engine")
                    self._record_span(req, status=-1,
                                      outcome="no_engine",
                                      reply_unix=time.time())
                else:
                    self._llm.admit(req)
            plain = [r for r in group if not r.get("stream")]
            if plain:
                try:
                    self._serve_group(plain)
                except Exception:  # noqa: BLE001
                    # one bad batch must not kill the serving loop;
                    # members not yet answered time out client-side
                    traceback.print_exc()
            if self._llm is not None and self._llm.active():
                self._llm_step()

    def _serve_group(self, group) -> None:
        """Answer a group of tensor requests: decode each (a malformed
        one gets a ``decode_error`` reply), batch those of one per-row
        signature into one ``predictor.run`` and reply each its rows (an
        ``execute_error`` reply to every member of a failed batch)."""
        # batch-assembly stamp: the dynamic-batch window just closed
        t_assembly = time.time()
        decoded = []
        for req in group:
            req["assembly_unix"] = t_assembly
            try:
                if self.predictor is None:
                    raise ValueError(
                        "server has no predictor (LLM-only server: "
                        "use streaming generate frames)")
                arrs = decode_tensors(req["payload"])
                # batching concatenates along dim 0: every tensor needs one
                if not arrs or any(a.ndim == 0 for a in arrs):
                    raise ValueError(
                        "request must carry >=1 tensors, each with a "
                        "leading batch dim")
                decoded.append((req, arrs))
            except Exception as e:  # noqa: BLE001
                self.transport.reply(req["rid"], str(e).encode(),
                                     status=-1)
                self._record_span(req, status=-1, outcome="decode_error",
                                  reply_unix=time.time())
        # group by per-row signature (shape minus batch dim + dtypes)
        sigs: Dict[Tuple, List[Tuple[Dict, List]]] = {}
        for req, arrs in decoded:
            sig = tuple((tuple(a.shape[1:]), str(a.dtype)) for a in arrs)
            sigs.setdefault(sig, []).append((req, arrs))
        for members in sigs.values():
            t_dispatch = time.time()
            try:
                rows = [m[1][0].shape[0] for m in members]
                joined = [_concat([m[1][i] for m in members])
                          for i in range(len(members[0][1]))]
                outs = self.predictor.run(joined)
                self.n_batches += 1
                self._note_batch(len(members), sum(rows))
                off = 0
                for (req, _), r in zip(members, rows):
                    part = [o[off:off + r] for o in outs]
                    self.transport.reply(req["rid"], encode_tensors(part))
                    off += r
                    self.n_requests += 1
                    self._record_span(req, status=0, outcome="ok",
                                      dispatch_unix=t_dispatch,
                                      reply_unix=time.time(),
                                      batch_rows=sum(rows),
                                      batch_members=len(members))
            except Exception as e:  # noqa: BLE001
                self.n_errors += len(members)
                self._note_error(len(members))
                for req, _ in members:
                    self.transport.reply(req["rid"], str(e).encode(),
                                         status=-1)
                    self._record_span(req, status=-1,
                                      outcome="execute_error",
                                      dispatch_unix=t_dispatch,
                                      reply_unix=time.time(),
                                      error=str(e)[:200])

    def _note_batch(self, n_members: int, n_rows: int) -> None:
        """Batch accounting on both planes: the native stat registry
        (always on: it backs the STATS reply) and the gated metrics
        registry (the /metrics page)."""
        stat_add("serving.batches_total")
        stat_add("serving.batch_rows_total", n_rows)
        for b in self._BATCH_BUCKETS:
            if n_rows <= b:
                stat_add(f"serving.batch_size_le_{b}")
        stat_add("serving.batch_size_le_inf")
        if obs.enabled():
            obs.histogram("serving_batch_size",
                          "rows per merged serving batch",
                          buckets=[float(b) for b in self._BATCH_BUCKETS]
                          ).observe(float(n_rows))
            obs.counter("serving_requests_total",
                        "requests answered by the dynamic batcher"
                        ).inc(n_members)

    def _note_error(self, n_members: int) -> None:
        stat_add("serving.batch_errors_total")
        if obs.enabled():
            obs.counter("serving_errors_total",
                        "requests answered with an error status"
                        ).inc(n_members)

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
            _flight.record("serving_drain_begin", force=True,
                           deadline_s=deadline_s,
                           llm_active=self._llm is not None
                           and self._llm.active())
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
            self._count_shed(req)
            self._record_span(req, status=-1, outcome="draining",
                              reply_unix=time.time())
        llm_busy = self._llm is not None and self._llm.active()
        if llm_busy:
            if time.perf_counter() < (self._drain_deadline_pc or 0):
                self._llm_step()
                return
            self._llm.close(
                message=b"server draining: drain deadline exceeded",
                outcome="drain_deadline")
        if not self._drained.is_set():
            self._drained.set()
            _flight.record("serving_drain_complete", force=True,
                           rejected=self.n_drain_rejected,
                           deadline_expired=llm_busy)
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
        self._bridge.join(timeout=5)
        if self._llm is not None:
            self._llm.close()
        self.transport.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def _concat(parts: List):
    """Rows of several requests as one batch: numpy arrays, or CPU
    tensors (bfloat16) where the codec gave those."""
    if any(isinstance(p, torch.Tensor) for p in parts):
        return torch.cat([p if isinstance(p, torch.Tensor)
                          else torch.from_numpy(p) for p in parts])
    return np.concatenate(parts, axis=0)


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
            # ptlint: disable=silent-failure -- closing a broken socket: the kernel may refuse, but the fd is dropped either way
            except OSError:
                pass  # the fd is dropped either way

    def _reconnect_with_backoff(self, attempts: int, gen: int,
                                deadline: Optional[float]) -> int:
        """One bounded retry step; returns the new attempt count or
        raises the terminal error."""
        _flight.record("client_reconnect", force=True,
                       host=self._host, port=self._port,
                       attempt=attempts + 1)
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
                # ptlint: disable=silent-failure -- transport repair is opportunistic: the original error is re-raised on the next line either way
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
                    # ptlint: disable=silent-failure -- a non-integer stat line is skipped, not fatal: the STATS wire format is k=v per line
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
                    _flight.record("client_deadline_expired",
                                   force=True, host=self._host,
                                   port=self._port, tag=want_tag)
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
            # ptlint: disable=silent-failure -- close() teardown: the fd is dropped whether or not the kernel objects
            except OSError:
                pass  # the fd is dropped either way

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
