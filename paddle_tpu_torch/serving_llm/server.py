"""Bridge between ``LLMEngine`` events and the streaming serving wire.

Counterpart of ``paddle_tpu.serving_llm.server``. ``inference.Server``
hands every 'PTST' streaming-generate request to an
:class:`LLMStreamBridge`, which owns the request's serving-side life:

* ``admit`` parses the generate body (the ``<IIfI`` header:
  max_new_tokens, eos id with ``0xFFFFFFFF`` meaning none, temperature,
  seed; then one int32 prompt tensor in the tensor codec, plus two
  optional tails told apart by dtype, in either order: an int32 [1]
  resume offset for a stream resumed after a failover, and a uint8
  tenant descriptor ``tenant \\x00 class``) and adds the sequence to the
  engine;
* ``step`` runs one engine step and turns its token events into
  status-1 chunks on the request's tag, the finish into the terminal
  status-0 frame, an engine error into a terminal status -1 frame, and
  a failed chunk write (client gone) into an engine ``cancel`` that
  frees the sequence's KV blocks.

Only the serving thread calls a bridge (the engine has one owner).
Request span records, their latency histograms and fault points are not
ported yet.
"""

from __future__ import annotations

import struct
import time
from typing import Any, Dict

import numpy as np

from ..inference import decode_tensors, encode_tensors
from . import tenancy
from .engine import LLMEngine

__all__ = ["LLMStreamBridge", "GENERATE_HEADER", "EOS_NONE"]

# body header after the u64 trace id: max_new_tokens, eos_token_id
# (EOS_NONE = no eos), temperature, seed; then the tensor codec
GENERATE_HEADER = "<IIfI"
EOS_NONE = 0xFFFFFFFF


class LLMStreamBridge:
    def __init__(self, server, engine: LLMEngine):
        self.server = server
        self.engine = engine
        # seq_id -> request  # guarded-by: single-owner (serving thread)
        self._reqs: Dict[int, Dict[str, Any]] = {}

    def active(self) -> bool:
        return self.engine.active()

    # -- request intake ---------------------------------------------------

    def admit(self, req: Dict[str, Any]) -> None:
        """Parse one streaming-generate request and hand it to the
        engine. A malformed body or a refused admission is answered at
        once with a terminal error frame (an ``AdmissionRejected``'s
        message carries its ``retry_after_ms=N`` hint); nothing enters
        the scheduler then."""
        try:
            buf = req["payload"]
            hdr = struct.calcsize(GENERATE_HEADER)
            if len(buf) < hdr:
                raise ValueError("generate body shorter than header")
            max_new, eos_raw, temperature, seed = struct.unpack_from(
                GENERATE_HEADER, buf, 0)
            arrs = decode_tensors(buf[hdr:])
            if not arrs or not isinstance(arrs[0], np.ndarray) \
                    or arrs[0].ndim != 1 or arrs[0].dtype != np.int32:
                raise ValueError(
                    "generate body must carry an int32 [T] prompt "
                    "tensor first")
            sample_offset = 0
            offset_seen = descriptor_seen = False
            tenant, cls = tenancy.DEFAULT_TENANT, tenancy.DEFAULT_CLASS
            for arr in arrs[1:]:
                dtype = getattr(arr, "dtype", None)
                if dtype == np.int32 and arr.size == 1 and not offset_seen:
                    # resumed stream: the prompt already carries the
                    # delivered tokens; this moves the sampler past them
                    sample_offset = int(arr.reshape(-1)[0])
                    offset_seen = True
                elif dtype == np.uint8 and not descriptor_seen:
                    tenant, cls = tenancy.decode_descriptor(arr)
                    descriptor_seen = True
                else:
                    raise ValueError(
                        "generate body must carry one prompt tensor "
                        "plus at most one resume-offset tensor "
                        "(int32 [1]) and one tenant descriptor "
                        "(uint8)")
            req["tenant"], req["class"] = tenant, cls
            seq_id = self.engine.add_request(
                arrs[0], max_new_tokens=max_new,
                eos_token_id=None if eos_raw == EOS_NONE else int(eos_raw),
                temperature=temperature, seed=seed,
                trace_id=req.get("trace_id") or 0,
                sample_offset=sample_offset,
                tenant=tenant, priority_class=cls)
        except Exception as e:  # noqa: BLE001 — fail ONE request
            self.server.transport.reply_chunk(
                req["rid"], str(e).encode(), status=-1, final=True)
            return
        req["seq_id"] = seq_id
        self._reqs[seq_id] = req

    # -- one serving step -------------------------------------------------

    def step(self) -> None:
        """One engine step; its events go out on the wire. Waiting
        sequences past the queue deadline are shed first."""
        self._shed_expired()
        for ev in self.engine.step():
            req = self._reqs.get(ev["seq_id"])
            if req is None:
                continue  # cancelled earlier this step
            if ev["type"] == "token":
                rc = self.server.transport.reply_chunk(
                    req["rid"],
                    encode_tensors([np.asarray([ev["token"]], np.int32)]),
                    status=1, final=False)
                if rc != 0:
                    self._cancel(ev["seq_id"])
            elif ev["type"] == "finished":
                self.server.transport.reply_chunk(
                    req["rid"], b"", status=0, final=True)
                del self._reqs[ev["seq_id"]]
            elif ev["type"] == "error":
                self.server.transport.reply_chunk(
                    req["rid"], ev["error"].encode(), status=-1,
                    final=True)
                del self._reqs[ev["seq_id"]]

    def _shed_expired(self) -> None:
        """Queue-deadline shedding of streams that have not started: a
        sequence still waiting for prefill (no token generated, never
        preempted) older than the server's queue deadline is cancelled
        and answered with a terminal shed frame. A stream that already
        streamed tokens is never shed."""
        ddl = self.server._queue_deadline_s()
        if ddl <= 0:
            return
        now = time.monotonic()
        for seq in list(self.engine.scheduler.waiting):
            req = self._reqs.get(seq.seq_id)
            if req is None or seq.generated or seq.preemptions:
                continue
            age = now - req.get("dequeue_mono", now)
            if age > ddl:
                self.engine.cancel(seq.seq_id, outcome="shed")
                self._reqs.pop(seq.seq_id, None)
                self.server._shed(req, age, ddl)

    def _cancel(self, seq_id: int) -> None:
        """A chunk write failed (client gone): drop the sequence so its
        KV blocks return to the pool."""
        self.engine.cancel(seq_id)
        self._reqs.pop(seq_id, None)

    def close(self, message: bytes = b"server stopping",
              outcome: str = "server_stop") -> None:
        """Terminal sweep (server stop, drain deadline, a failed step):
        every open stream gets a terminal negative-status frame carrying
        ``message`` before its sequence is cancelled with ``outcome``,
        so a client sees an explicit error, never a bare reset."""
        for seq_id, req in list(self._reqs.items()):
            self.server.transport.reply_chunk(req["rid"], message,
                                              status=-1, final=True)
            self.engine.cancel(seq_id, outcome=outcome)
        self._reqs.clear()
