"""LLM decode engine: paged KV pools + continuous-batching step loop.

Counterpart of ``paddle_tpu.serving_llm.engine``. The engine owns the
per-layer K/V block POOLS (``[num_blocks, block_size, heads, head_dim]``
fp32 tensors on the device, the layout the paged attention kernels
scan), drives the scheduler, and turns ``step()`` calls into token
events:

* admitted sequences are PREFILLED — a dense causal forward over the
  not-yet-cached suffix of the prompt whose attention callback also
  writes each layer's K/V into the sequence's pool blocks. Under
  ``FLAGS_kv_prefix_sharing`` the already-resident shared prefix is
  skipped (its K/V rows are gathered from the pool), and the first
  write into a still-shared block goes through copy-on-write. Under
  ``FLAGS_prefill_chunk_tokens`` the prefill advances one chunk per
  step, interleaved with decode, and yields its first token when the
  last chunk lands;
* the running set then takes ONE decode step as a single ragged batch:
  every sequence's newest token is written into its next pool slot and
  attention runs through the ragged paged kernel over the block tables.
  Under ``FLAGS_speculative_k`` the step is SPECULATIVE instead: a draft
  model proposes up to k tokens per sequence, the target verifies every
  window in one batched multi-query paged forward, the longest accepted
  prefix plus the target's bonus token is committed, and draft K/V past
  the accepted point is rolled back (``KVBlockAllocator.truncate_to``).

Pools are written in place (``pool[blocks, offsets] = k``); the JAX
engine rebuilds a whole pool per scatter because its arrays are
immutable. Sampling runs on the device, one host read per batch, and is
position-keyed — the token at generated-index i takes Gumbel noise from
a generator seeded by (seed, sample_offset + i) — so speculative and
plain decode give the same tokens at any temperature. The bits differ
from the JAX sampler's (``fold_in`` + ``categorical``).

The JAX engine's hooks are all here, under the same names: the sequence
timelines (``observability.seqtrace``), the step profiler
(``observability.stepprof``, host clocks at the JAX points, no added
device sync), the ``llm_*`` metrics and gauges, the flight records of
admission rejections, stalls and KV audit failures, and the fault points
``llm_prefill``, ``llm_chunk_prefill``, ``llm_decode``,
``llm_spec_verify`` and ``llm_cow_copy`` (``kv_alloc`` is the
allocator's), and the stall watchdog's thread-stack diagnosis (the hang
doctor of ``observability.stacks``: a post-hoc ``serving_step``
diagnosis here; the live one mid-wedge is the hang monitor's, which
reads :func:`health_snapshot`).
"""

from __future__ import annotations

import time
import weakref
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import kernels
from .. import observability as obs
from ..core.place import resolve_device
from ..flags import GLOBAL_FLAGS
from ..models.gpt_lm import dense_causal_attention
from ..observability import flight as _flight
from ..observability import metrics as _m
from ..observability import seqtrace as _seqtrace
from ..observability import stacks as _stacks
from ..observability import stepprof as _stepprof
from ..testing import faults as _faults
from . import tenancy
from .kv_cache import KVBlockAllocator
from .scheduler import ContinuousBatchingScheduler, Sequence

__all__ = ["LLMEngine", "AdmissionRejected", "health_snapshot"]

# stall watchdog floor: a step (or inter-step gap) must exceed both the
# floor and stall_factor * EWMA before the engine reads as stalled
STALL_MIN_S = 0.5

# live engines, for an aggregate health view (health_snapshot)
_ENGINES: "weakref.WeakSet[LLMEngine]" = weakref.WeakSet()

_MASK64 = (1 << 64) - 1


def _sample_seed(seed: int, index: int) -> int:
    """63-bit generator seed for (seed, position): splitmix64 mixing, so
    neighbouring positions get unrelated streams."""
    x = (seed * 0x9E3779B97F4A7C15 + index + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


def sampling_noise(keys, vocab: int, device) -> torch.Tensor:
    """Gumbel noise ``[len(keys), vocab]`` on ``device``: row r for the
    token at position key ``keys[r] = (seed, sample_offset + index)``,
    drawn from a generator on the device seeded by that key alone, so a
    position draws the same noise in whatever batch it is sampled.
    ``argmax(logits / T + noise)`` is a draw from ``softmax(logits / T)``
    (the Gumbel-max trick, as ``jax.random.categorical`` samples)."""
    u = torch.stack([
        torch.rand(vocab, device=device, generator=torch.Generator(
            device=device).manual_seed(_sample_seed(seed, pos)))
        for seed, pos in keys])
    return -torch.log(-torch.log(u))  # u == 0 gives -inf: never chosen


class AdmissionRejected(RuntimeError):
    """New sequence refused by the KV-watermark admission gate
    (FLAGS_kv_admission_watermark) or its tenant's KV budget: the pool
    could not cover the projected peak demand, so the request is
    rejected before prefill instead of admitted into preempt-thrash.
    ``retry_after_ms`` is a backoff hint sized to the current load."""

    def __init__(self, msg: str, retry_after_ms: int):
        super().__init__(msg)
        self.retry_after_ms = int(retry_after_ms)


def health_snapshot() -> Dict[str, Any]:
    """Aggregate engine health: per-engine stall / KV-audit state,
    ok=False when any live engine is unhealthy."""
    engines = [eng.health() for eng in list(_ENGINES)]
    ok = not any(h["stalled"] or h["audit_failed"] for h in engines)
    return {"ok": ok, "engines": engines}


class LLMEngine:
    """``device`` None means ``cuda`` (raises without a GPU); pass
    ``device="cpu"`` to serve on the CPU. The model (and draft) must
    live on that device."""

    def __init__(self, model, block_size: Optional[int] = None,
                 pool_blocks: Optional[int] = None,
                 max_decode_batch: Optional[int] = None,
                 draft_model=None, device=None):
        self.device = resolve_device(device)
        for m in (model, draft_model):
            if m is not None and m.device != self.device:
                raise ValueError(f"model is on {m.device}, engine on "
                                 f"{self.device}")
        cfg = model.config
        self.model = model
        self.block_size = int(block_size
                              or GLOBAL_FLAGS.get("kv_block_size"))
        self.pool_blocks = int(pool_blocks
                               or GLOBAL_FLAGS.get("kv_pool_blocks"))
        self.allocator = KVBlockAllocator(self.pool_blocks,
                                          self.block_size)
        self.scheduler = ContinuousBatchingScheduler(
            self.allocator, max_decode_batch=max_decode_batch)
        self._heads = cfg.num_heads
        self._head_dim = cfg.hidden_size // cfg.num_heads
        shape = (self.pool_blocks, self.block_size, self._heads,
                 self._head_dim)
        self._k_pools = [torch.zeros(shape, dtype=torch.float32,
                                     device=self.device)
                         for _ in range(cfg.num_layers)]
        self._v_pools = [torch.zeros(shape, dtype=torch.float32,
                                     device=self.device)
                         for _ in range(cfg.num_layers)]
        self._seqs: Dict[int, Sequence] = {}
        # tenant labels that ever held a live sequence (gauge zeroing)
        self._tenant_labels_seen: set = set()
        self._next_seq = 0
        self.tokens_generated = 0
        # projected peak blocks per live sequence (watermark gate)
        self._projected: Dict[int, int] = {}
        # stall watchdog / post-step audit state (health())
        self._step_begin_unix: Optional[float] = None
        self._step_end_unix: Optional[float] = None
        self._step_ewma_s: Optional[float] = None
        self._audit_failed = False
        self.stalls_total = 0
        self.admission_rejected_total = 0
        # step profiler (observability/stepprof.py): per-step phase-ms
        # accumulator, None while metrics are off or between steps
        self._steps_total = 0
        self._step_begin_mono: Optional[float] = None
        self._phase_ms: Optional[Dict[str, float]] = None
        self._spec_batch = 0  # sequences verified this step
        self._prefix_hits_snap = 0
        self._spec_snap = (0, 0)
        # speculative decoding (FLAGS_speculative_k): None means the
        # draft is auto-built on first use (FLAGS_speculative_draft_*);
        # draft_model=model self-drafts (accept rate 1.0)
        self._draft_model = draft_model
        self.spec_proposed_total = 0
        self.spec_accepted_total = 0
        self.spec_verify_steps = 0
        self.spec_verify_ms_total = 0.0
        _ENGINES.add(self)

    # -- request lifecycle ------------------------------------------------

    def add_request(self, prompt_ids, max_new_tokens: int = 16,
                    eos_token_id: Optional[int] = None,
                    temperature: float = 0.0, seed: int = 0,
                    trace_id: int = 0, sample_offset: int = 0,
                    tenant: str = tenancy.DEFAULT_TENANT,
                    priority_class: str = tenancy.DEFAULT_CLASS) -> int:
        """Queue one generate request; returns its sequence id.
        ``trace_id`` is the wire's id of the request (0: untraced), kept
        on the sequence and its timeline as the join key to the serving
        front's records."""
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        vocab = self.model.config.vocab_size
        if any(t < 0 or t >= vocab for t in prompt):
            raise ValueError(f"prompt token out of range [0, {vocab})")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if sample_offset < 0:
            raise ValueError("sample_offset must be >= 0")
        tenant = tenancy.sanitize_tenant(tenant)
        priority_class = tenancy.normalize_class(priority_class)
        projected = self._admission_gate(prompt, int(max_new_tokens),
                                         tenant)
        self._next_seq += 1
        seq = Sequence(seq_id=self._next_seq, prompt=prompt,
                       max_new_tokens=int(max_new_tokens),
                       eos_token_id=eos_token_id,
                       temperature=float(temperature), seed=int(seed),
                       trace_id=int(trace_id),
                       sample_offset=int(sample_offset),
                       tenant=tenant, priority_class=priority_class)
        self._seqs[seq.seq_id] = seq
        self._projected[seq.seq_id] = projected
        self.scheduler.add(seq)
        if obs.enabled():
            obs.counter("llm_tenant_admitted_total",
                        "sequences accepted into the engine per "
                        "tenant label (past the watermark AND the "
                        "tenant KV budget; the fleet_status.py "
                        "--tenants admitted column)").inc(
                            tenant=tenancy.tenant_label(tenant))
        # the timeline opens here; trace_id is the wire id the bridge
        # carries, so request records link to this timeline
        _seqtrace.begin(seq.seq_id, trace_id=int(trace_id),
                        engine=id(self), prompt_tokens=len(prompt),
                        max_new_tokens=int(max_new_tokens),
                        tenant=tenant, cls=priority_class)
        return seq.seq_id

    def _projected_blocks(self, prompt: List[int], max_new: int) -> int:
        """Peak private-block demand of a new sequence: blocks for
        prompt + max_new tokens, minus full prompt blocks that prefix
        sharing will satisfy from resident (or soon resident) blocks."""
        projected = self.allocator.blocks_for(len(prompt) + max_new)
        if not self.allocator._sharing():
            return projected
        m = self.allocator.probe_shared_tokens(prompt)
        for seq in self._seqs.values():
            other = seq.prompt
            limit = min(len(prompt) - 1, len(other))
            c = 0
            while c < limit and prompt[c] == other[c]:
                c += 1
            m = max(m, c)
        return max(1, projected - m // self.block_size)

    def _admission_gate(self, prompt: List[int], max_new: int,
                        tenant: str) -> int:
        """Reject when the summed projection of every live sequence
        would cross the watermark, or when this tenant's own summed
        projection would cross its FLAGS_tenant_kv_budget fraction of
        the pool. Returns the sequence's projected peak blocks."""
        projected = self._projected_blocks(prompt, max_new)
        watermark = float(GLOBAL_FLAGS.get("kv_admission_watermark"))
        # the tenant budget gates even when the global watermark is
        # off: it is an isolation contract, not an overload valve
        frac = tenancy.tenant_budget_frac(tenant)
        if frac is not None:
            t_budget = frac * self.pool_blocks
            t_committed = sum(
                p for sid, p in self._projected.items()
                if (s := self._seqs.get(sid)) is not None
                and s.tenant == tenant)
            if t_committed + projected > t_budget:
                self._reject(projected, t_committed, t_budget, tenant,
                             reason="tenant_budget")
        if watermark > 0:
            budget = watermark * self.pool_blocks
            committed = sum(self._projected.values())
            if committed + projected > budget:
                self._reject(projected, committed, budget, tenant,
                             reason="watermark")
        return projected

    def _reject(self, projected: int, committed: float, budget: float,
                tenant: str, reason: str) -> None:
        """Count + flight-record one admission rejection and raise
        AdmissionRejected with the retry-after hint."""
        self.admission_rejected_total += 1
        load = len(self.scheduler.running) + len(self.scheduler.waiting)
        retry_after_ms = 50 * (1 + load)
        _flight.record("llm_admission_rejected", force=True,
                       projected_blocks=projected,
                       committed_blocks=committed,
                       budget_blocks=round(budget, 1),
                       reason=reason, tenant=tenant,
                       retry_after_ms=retry_after_ms)
        if obs.enabled():
            obs.counter("llm_admission_rejected_total",
                        "new sequences refused before prefill, per "
                        "tenant label — by the KV-watermark admission "
                        "gate (kv_admission_watermark) or the "
                        "tenant's own KV budget (tenant_kv_budget); "
                        "overload fail-fast, not a shed or a "
                        "preemption").inc(
                            tenant=tenancy.tenant_label(tenant))
        what = ("tenant KV budget" if reason == "tenant_budget"
                else "watermark budget")
        raise AdmissionRejected(
            f"admission rejected: projected {projected} KV blocks + "
            f"{committed} committed exceeds {what} "
            f"{budget:.1f} of {self.pool_blocks}; "
            f"retry_after_ms={retry_after_ms}", retry_after_ms)

    def cancel(self, seq_id: int, outcome: str = "cancelled") -> bool:
        """Drop a sequence (client disconnect; ``outcome="shed"`` when
        the serving bridge sheds an aged waiting stream): blocks freed,
        no further events for it. True if it was live. ``outcome`` closes
        its timeline."""
        seq = self.scheduler.cancel(seq_id)
        self._seqs.pop(seq_id, None)
        self._projected.pop(seq_id, None)
        if seq is not None:
            _seqtrace.finish(seq_id, outcome, tokens=len(seq.generated))
        return seq is not None

    def active(self) -> bool:
        return self.scheduler.active()

    # -- one engine step --------------------------------------------------

    def step(self) -> List[Dict[str, Any]]:
        """Admit + prefill new sequences, then one decode step for the
        running batch. Returns token/finished/error event dicts in
        emission order. Timed by the stall watchdog (EWMA of step wall
        time, FLAGS_llm_stall_factor) and followed by the KV invariant
        audit, which raises on a leak. Each step also emits one step
        record into the step ring (observability/stepprof.py), its
        in-flight half registered up front so a wedged step shows
        there while it hangs. With metrics on the step is a tracer span,
        ``LLMEngine.step`` (a ``torch.profiler`` range too)."""
        if obs.enabled():
            with obs.span("LLMEngine.step"):
                return self._step()
        return self._step()

    def _step(self) -> List[Dict[str, Any]]:
        self._step_begin_unix = time.time()
        t0 = time.perf_counter()
        self._steps_total += 1
        self._prof_begin()
        events: List[Dict[str, Any]] = []
        try:
            with torch.no_grad():
                events = self._step_inner()
        finally:
            dt = time.perf_counter() - t0
            # fair-share ledger: resident context x step wall time
            self.scheduler.charge(dt)
            stalls_before = self.stalls_total
            self._note_step(dt)
            self._prof_end(dt, events,
                           stalled=self.stalls_total > stalls_before)
        self._audit()
        return events

    def _step_inner(self) -> List[Dict[str, Any]]:
        events: List[Dict[str, Any]] = []
        self._prof_phase("admit")
        _t = time.perf_counter()
        admitted: List[Sequence] = []
        try:
            admitted = self.scheduler.admit()
        except Exception as e:  # noqa: BLE001 — fail the one request
            # allocate() raised before the head left the waiting queue
            if self.scheduler.waiting:
                seq = self.scheduler.waiting.popleft()
                events.append(self._fail(seq, f"kv allocation: {e}"))
        self._prof_acc("admit", (time.perf_counter() - _t) * 1e3)
        for seq in admitted:
            _seqtrace.event(seq.seq_id,
                            "readmitted" if seq.preemptions
                            else "admitted",
                            cached_tokens=seq.cached_tokens,
                            order=seq.admit_order)
        # chunked prefill tick: every running sequence with unwritten
        # context advances ONE chunk (the whole remainder when chunking
        # is off), newly admitted sequences included
        self._prof_phase("prefill")
        for seq in [s for s in self.scheduler.running
                    if not s.prefill_done]:
            if seq not in self.scheduler.running:
                continue  # preempted by an earlier sequence's COW
            _t = time.perf_counter()
            try:
                events += self._prefill_chunk(seq)
            except Exception as e:  # noqa: BLE001 — fail ONE request
                events.append(self._fail(seq, str(e)))
            finally:
                self._prof_acc("prefill",
                               (time.perf_counter() - _t) * 1e3)
        self._prof_phase("decode")
        _t = time.perf_counter()
        spec0 = (self._phase_ms or {}).get("spec_verify", 0.0)
        events += self._decode()
        dec_ms = (time.perf_counter() - _t) * 1e3 \
            - ((self._phase_ms or {}).get("spec_verify", 0.0) - spec0)
        self._prof_acc("decode", max(0.0, dec_ms))
        self._publish()
        return events

    # -- step profiler (observability/stepprof.py) -------------------------

    def _prof_begin(self) -> None:
        """Open the step record: arm the phase-ms accumulator and
        register the live in-flight entry on the step ring."""
        self._step_begin_mono = time.monotonic()
        self._spec_batch = 0
        if not obs.enabled():
            self._phase_ms = None
            return
        self._phase_ms = {}
        self._prefix_hits_snap = self.allocator.prefix_hit_tokens_total
        self._spec_snap = (self.spec_proposed_total,
                           self.spec_accepted_total)
        _stepprof.ring().step_begin(id(self), step=self._steps_total,
                                    begin_unix=self._step_begin_unix)

    def _prof_phase(self, phase: str) -> None:
        if self._phase_ms is not None:
            _stepprof.ring().set_phase(id(self), phase)

    def _prof_acc(self, phase: str, ms: float) -> None:
        p = self._phase_ms
        if p is not None:
            p[phase] = p.get(phase, 0.0) + ms

    def _prof_end(self, dt: float, events: List[Dict[str, Any]],
                  stalled: bool) -> None:
        """Seal the step record and append it to the step ring (also
        observes llm_step_phase_ms{phase=})."""
        p, self._phase_ms = self._phase_ms, None
        if p is None:
            return
        run = self.scheduler.running
        dp = self.spec_proposed_total - self._spec_snap[0]
        da = self.spec_accepted_total - self._spec_snap[1]
        rec = {
            "step": self._steps_total,
            "engine": id(self) & 0xFFFF,
            "begin_unix": self._step_begin_unix,  # display only
            "begin_mono": self._step_begin_mono,
            "dur_ms": round(dt * 1e3, 3),
            "phase_ms": {k: round(v, 3) for k, v in sorted(p.items())},
            "batch": {
                "prefilling": sum(1 for s in run
                                  if not s.prefill_done),
                "decoding": sum(1 for s in run if s.prefill_done),
                "verifying": self._spec_batch,
                "waiting": len(self.scheduler.waiting)},
            "kv": {"used": self.allocator.num_used,
                   "free": self.allocator.num_free,
                   "shared": self.allocator.num_shared},
            "prefix_hit_tokens": self.allocator.prefix_hit_tokens_total
            - self._prefix_hits_snap,
            "spec": {"proposed": dp, "accepted": da,
                     "accept_rate": round(da / dp, 4) if dp else None},
            "tokens": sum(1 for e in events if e["type"] == "token"),
            "events": len(events),
            "stalled": bool(stalled),
        }
        _stepprof.ring().record(id(self), rec)

    # -- internals --------------------------------------------------------

    def _slots(self, seq: Sequence, positions: np.ndarray):
        """(block, offset) pool coordinates for absolute token positions
        of one sequence, as numpy arrays."""
        table = np.asarray(self.allocator.table(seq.seq_id), np.int64)
        return table[positions // self.block_size], \
            positions % self.block_size

    def _dev(self, a, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    def _block_tables(self, batch: List[Sequence]):
        """[B, max_blocks] int32 block tables (zero-padded) on the
        device."""
        tables = [self.allocator.table(s.seq_id) for s in batch]
        tbl = np.zeros((len(batch), max(len(t) for t in tables)),
                       np.int32)
        for i, t in enumerate(tables):
            tbl[i, :len(t)] = t
        return self._dev(tbl, torch.int32)

    @staticmethod
    def _chunk_tokens(block_size: int) -> int:
        """FLAGS_prefill_chunk_tokens floored to a block-size multiple
        (0 = chunking off: the whole prompt in one step)."""
        chunk = int(GLOBAL_FLAGS.get("prefill_chunk_tokens"))
        if chunk <= 0:
            return 0
        return max(block_size, chunk - chunk % block_size)

    def _make_writable(self, seq: Sequence, lo: int, hi: int) -> None:
        """Copy-on-write gate before writing K/V rows at positions
        [lo, hi): any still-shared block in that range is replaced with
        a private copy (rows copied in-pool), preempting younger
        sequences if the pool cannot supply the copy target. Raises
        when the pool can never cover it (caller fails the sequence)."""
        bs = self.block_size
        for idx in range(lo // bs, (max(lo, hi - 1)) // bs + 1):
            r = self.scheduler.make_writable(seq, idx)
            if r is None:
                continue
            if r is False:
                if seq not in self.scheduler.running:
                    # preempted itself: higher-class residents hold the
                    # pool; readmission retries the write
                    return
                raise RuntimeError(
                    f"sequence needs a private copy of a shared KV "
                    f"block but the pool holds "
                    f"{self.pool_blocks * self.block_size} tokens "
                    f"with no victims left")
            old, new = r
            _t = time.perf_counter()
            _faults.hit("llm_cow_copy")
            for pool in self._k_pools + self._v_pools:
                pool[new] = pool[old]
            _seqtrace.event(
                seq.seq_id, "cow_copy", block_old=old, block_new=new,
                ms=round((time.perf_counter() - _t) * 1e3, 3))

    def _prefill_chunk(self, seq: Sequence) -> List[Dict[str, Any]]:
        """One prefill chunk for ``seq``: forward the next
        FLAGS_prefill_chunk_tokens positions (everything left when
        chunking is off), attending over the already-cached prefix
        gathered from the pool, and write the fresh K/V rows into the
        sequence's blocks. The final chunk samples the first token."""
        t0 = time.perf_counter()  # before the fault hits: an injected
        # slow chunk (sleep=) must show in this chunk's measured ms
        if seq.ctx_len == seq.cached_tokens:
            # first chunk of this (re)admission: the per-sequence prefill
            # fault point fires here once
            _faults.hit("llm_prefill")
        _faults.hit("llm_chunk_prefill")
        if seq.dispatch_unix is None:
            seq.dispatch_unix = time.time()
        ids = seq.prompt + seq.generated  # re-prefill keeps generated
        t = len(ids)
        c0 = seq.ctx_len
        chunk = self._chunk_tokens(self.block_size)
        n = t - c0 if chunk <= 0 else min(chunk, t - c0)
        # COW before any write: the first uncached position may land in
        # a block still shared with another sequence
        self._make_writable(seq, c0, c0 + n)
        if seq not in self.scheduler.running:
            return []  # preempted itself inside the COW gate
        pos = np.arange(c0, c0 + n)
        blks, offs = (self._dev(a) for a in self._slots(seq, pos))
        cb = co = None
        if c0 > 0:
            cb, co = (self._dev(a)
                      for a in self._slots(seq, np.arange(c0)))

        def attn_fn(i, q, k, v):
            _ts = time.perf_counter()
            self._k_pools[i][blks, offs] = k[0].float()
            self._v_pools[i][blks, offs] = v[0].float()
            self._prof_acc("scatter", (time.perf_counter() - _ts) * 1e3)
            if cb is None:
                return dense_causal_attention(q, k, v)
            # cached prefix (shared blocks / earlier chunks) comes from
            # the pool; queries attend [cached + fresh] at their
            # absolute positions
            kc = self._k_pools[i][cb, co][None]
            vc = self._v_pools[i][cb, co][None]
            return dense_causal_attention(
                q, torch.cat([kc, k.float()], dim=1),
                torch.cat([vc, v.float()], dim=1), q_offset=c0)

        logits = self.model.forward_with_attn(
            self._dev([ids[c0:c0 + n]]), self._dev(pos[None]),
            attn_fn)[0, -1]
        seq.ctx_len = c0 + n
        self.allocator.note_written(seq.seq_id, ids[:seq.ctx_len])
        chunk_ms = (time.perf_counter() - t0) * 1e3
        if obs.enabled():
            obs.histogram("llm_prefill_chunk_ms",
                          "wall time of one prefill chunk "
                          "(FLAGS_prefill_chunk_tokens; whole-prompt "
                          "prefill when chunking is off)",
                          buckets=_m.LATENCY_MS_BUCKETS).observe(
                              chunk_ms)
        # timeline event BEFORE the final chunk's first token, so the
        # chunk lands inside the gap the token anchors
        _seqtrace.event(seq.seq_id, "prefill_chunk",
                        ms=round(chunk_ms, 3), ctx=seq.ctx_len,
                        done=seq.ctx_len >= t)
        if seq.ctx_len < t:
            return []  # mid-prefill: decode keeps ticking meanwhile
        seq.prefill_done = True
        return self._emit(seq, self._sample([seq], logits[None],
                                            [len(seq.generated)])[0])

    def _grow_batch(self, k: int, events: List[Dict[str, Any]]):
        """Grow every decode-ready sequence (oldest first: preemption
        evicts from the young end) by 1 token, or — speculative — by its
        draft window plus 1. Returns (batch, windows, the host ms each
        window's proposal took)."""
        todo = sorted((s for s in self.scheduler.running
                       if s.prefill_done and s.generated),
                      key=lambda s: s.admit_order)
        draft = self._draft() if k > 0 else None
        batch: List[Sequence] = []
        windows: Dict[int, List[int]] = {}
        prop_ms_by: Dict[int, float] = {}
        for seq in todo:
            if seq not in self.scheduler.running:
                continue  # preempted by an older sequence's growth
            _t = time.perf_counter()
            try:
                # the speculative step's point is llm_spec_verify, the
                # plain step's llm_decode (one hit per sequence)
                _faults.hit("llm_spec_verify" if k > 0 else "llm_decode")
                proposal: List[int] = []
                if k > 0:
                    # never propose past the emission budget: a window
                    # emits at most k accepted tokens + 1 bonus token
                    k_eff = max(0, min(k, seq.max_new_tokens
                                       - len(seq.generated) - 1))
                    if k_eff:
                        proposal = self._propose(seq, draft, k_eff)
                need = seq.ctx_len + len(proposal) + 1
                grown = self.scheduler.grow(seq, need)
                if grown:
                    # COW gate over the whole window: a rejected draft
                    # must never scribble a block another sequence
                    # still reads
                    self._make_writable(seq, seq.ctx_len, need)
            except Exception as e:  # noqa: BLE001 — fail ONE sequence
                events.append(self._fail(
                    seq, f"{'speculative' if k > 0 else 'decode'}: {e}"))
                continue
            if k > 0:
                prop_ms = (time.perf_counter() - _t) * 1e3
                self._prof_acc("spec_verify", prop_ms)
                prop_ms_by[seq.seq_id] = prop_ms
            if not grown:
                if seq not in self.scheduler.running:
                    # preempted ITSELF: higher-class residents hold the
                    # pool — it waits for readmission, not death
                    continue
                events.append(self._fail(
                    seq, f"sequence needs {need} tokens of KV cache but "
                         f"the pool holds "
                         f"{self.pool_blocks * self.block_size}"))
                continue
            batch.append(seq)
            windows[seq.seq_id] = proposal
        return ([s for s in batch if s in self.scheduler.running], windows,
                prop_ms_by)

    def _decode(self) -> List[Dict[str, Any]]:
        k = self._spec_k()
        if k > 0:
            return self._decode_speculative(k)
        events: List[Dict[str, Any]] = []
        batch, _, _ = self._grow_batch(0, events)
        if not batch:
            return events
        newpos = np.asarray([s.ctx_len for s in batch])
        slots = [self._slots(s, np.asarray([s.ctx_len])) for s in batch]
        blks = self._dev([s[0][0] for s in slots])
        offs = self._dev([s[1][0] for s in slots])
        tbl = self._block_tables(batch)
        lens = self._dev(newpos + 1, torch.int32)

        def attn_fn(i, q, k, v):
            _ts = time.perf_counter()
            self._k_pools[i][blks, offs] = k[:, 0].float()
            self._v_pools[i][blks, offs] = v[:, 0].float()
            self._prof_acc("scatter", (time.perf_counter() - _ts) * 1e3)
            out = kernels.maybe_paged_attention(
                q[:, 0].float().contiguous(),
                                        self._k_pools[i],
                                        self._v_pools[i], tbl, lens)
            return out[:, None].to(q.dtype)

        try:
            logits = self.model.forward_with_attn(
                self._dev([[s.generated[-1]] for s in batch]),
                self._dev(newpos[:, None]), attn_fn)[:, -1]
            toks = self._sample(batch, logits,
                                [len(s.generated) for s in batch])
        except Exception as e:  # noqa: BLE001
            # a failed batched forward would otherwise strand the whole
            # running set mid-decode: fail every member loudly
            for seq in batch:
                events.append(self._fail(seq, f"decode step: {e}"))
            return events
        if obs.enabled():
            obs.histogram("llm_decode_batch_size",
                          "sequences per continuous-batching decode "
                          "step",
                          buckets=[1.0, 2.0, 4.0, 8.0, 16.0, 32.0]
                          ).observe(float(len(batch)))
        for i, seq in enumerate(batch):
            seq.ctx_len += 1
            self.allocator.note_written(
                seq.seq_id, (seq.prompt + seq.generated)[:seq.ctx_len])
            events += self._emit(seq, toks[i])
        return events

    # -- speculative decoding (FLAGS_speculative_k) ------------------------

    @staticmethod
    def _spec_k() -> int:
        return max(0, int(GLOBAL_FLAGS.get("speculative_k")))

    def _draft(self):
        """The draft model: the one passed at construction, else a small
        GPTLanguageModel built once — the target's geometry with
        FLAGS_speculative_draft_layers layers, sharing the target's
        embeddings (so its tied head) under
        FLAGS_speculative_draft_tie_embeddings."""
        if self._draft_model is not None:
            return self._draft_model
        from ..models.gpt_lm import GPTConfig, GPTLanguageModel
        cfg = self.model.config
        layers = max(1, int(GLOBAL_FLAGS.get("speculative_draft_layers")))
        draft = GPTLanguageModel(GPTConfig(
            vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
            num_layers=layers, num_heads=cfg.num_heads,
            intermediate_size=cfg.intermediate_size,
            max_position_embeddings=cfg.max_position_embeddings,
            layer_norm_epsilon=cfg.layer_norm_epsilon),
            device=self.device)
        if bool(GLOBAL_FLAGS.get("speculative_draft_tie_embeddings")):
            draft.embed = self.model.embed
            draft.pos_embed = self.model.pos_embed
        self._draft_model = draft
        return draft

    def _propose(self, seq: Sequence, draft, k: int) -> List[int]:
        """Draft-propose ``k`` continuation tokens for ``seq`` with a
        dense concat KV cache rebuilt from the full token history (the
        draft stays stateless across the target's preemptions and
        rollbacks). Proposals use the target's position-keyed sampler,
        so a self-drafting engine accepts every token."""
        ids = seq.prompt + seq.generated
        caches: List[Optional[tuple]] = [None] * len(draft.blocks)

        def attn_fn(i, q, kk, vv):
            if caches[i] is not None:
                kk = torch.cat([caches[i][0], kk], dim=1)
                vv = torch.cat([caches[i][1], vv], dim=1)
            caches[i] = (kk, vv)
            return dense_causal_attention(
                q, kk, vv, q_offset=kk.shape[1] - q.shape[1])

        logits = draft.forward_with_attn(
            self._dev([ids]), self._dev(np.arange(len(ids))[None]),
            attn_fn)[0, -1]
        out: List[int] = []
        for j in range(k):
            tok = self._sample([seq], logits[None],
                               [len(seq.generated) + j])[0]
            out.append(tok)
            if j + 1 == k:
                break
            logits = draft.forward_with_attn(
                self._dev([[tok]]), self._dev([[len(ids) + j]]),
                attn_fn)[0, -1]
        return out

    def _decode_speculative(self, k: int) -> List[Dict[str, Any]]:
        """One speculative decode step: the draft proposes up to ``k``
        tokens per sequence, the TARGET verifies every window in ONE
        batched ragged multi-query paged forward, and the longest
        accepted prefix is committed plus the target's bonus token.
        Draft K/V past the accepted point is rolled back through the
        allocator's truncate_to, so the post-step audit sees exactly
        the committed context."""
        events: List[Dict[str, Any]] = []
        batch, windows, prop_ms_by = self._grow_batch(k, events)
        if not batch:
            return events
        b = len(batch)
        self._spec_batch = b
        q_lens = np.asarray([len(windows[s.seq_id]) + 1 for s in batch])
        qmax = int(q_lens.max())
        feed = np.zeros((b, qmax), np.int64)
        newpos = np.zeros((b, qmax), np.int64)
        rows_b, rows_q, blks, offs = [], [], [], []
        for i, s in enumerate(batch):
            win = [s.generated[-1]] + windows[s.seq_id]
            feed[i, :len(win)] = win
            # padded rows clamp to the last valid position (keeps
            # pos_embed in range; their outputs are discarded)
            newpos[i] = np.minimum(np.arange(s.ctx_len, s.ctx_len + qmax),
                                   s.ctx_len + len(win) - 1)
            sb, so = self._slots(s, np.arange(s.ctx_len,
                                              s.ctx_len + len(win)))
            rows_b += [i] * len(win)
            rows_q += list(range(len(win)))
            blks += list(sb)
            offs += list(so)
        row_seqs = [batch[i] for i in rows_b]
        row_index = [len(batch[i].generated) + j
                     for i, j in zip(rows_b, rows_q)]
        # sampled row of window position (i, j): starts[i] + j
        starts = np.cumsum(q_lens) - q_lens
        rows_b, rows_q = self._dev(rows_b), self._dev(rows_q)
        blks, offs = self._dev(blks), self._dev(offs)
        tbl = self._block_tables(batch)
        lens = self._dev(np.asarray([s.ctx_len for s in batch]) + q_lens,
                         torch.int32)
        qlens_d = self._dev(q_lens, torch.int32)

        def attn_fn(i, q, kk, vv):
            _ts = time.perf_counter()
            self._k_pools[i][blks, offs] = kk[rows_b, rows_q].float()
            self._v_pools[i][blks, offs] = vv[rows_b, rows_q].float()
            self._prof_acc("scatter", (time.perf_counter() - _ts) * 1e3)
            out = kernels.maybe_paged_attention_multiquery(
                q.float().contiguous(), qlens_d, self._k_pools[i],
                self._v_pools[i], tbl, lens)
            return out.to(q.dtype)

        t0 = time.perf_counter()
        try:
            logits = self.model.forward_with_attn(
                self._dev(feed), self._dev(newpos), attn_fn)
            toks = self._sample(row_seqs, logits[rows_b, rows_q], row_index)
        except Exception as e:  # noqa: BLE001
            # same stance as the non-speculative batch: a failed verify
            # forward must not strand the running set
            for seq in batch:
                events.append(self._fail(seq, f"verify step: {e}"))
            return events
        verify_ms = (time.perf_counter() - t0) * 1e3
        self._prof_acc("spec_verify", verify_ms)
        self.spec_verify_steps += 1
        self.spec_verify_ms_total += verify_ms
        accepted_step = 0
        # proposed counts only windows that reached the verifier
        proposed_step = int(q_lens.sum()) - b
        self.spec_proposed_total += proposed_step
        for i, seq in enumerate(batch):
            proposal = windows[seq.seq_id]
            emitted: List[int] = []
            m = 0
            for j in range(len(proposal) + 1):
                tok = toks[starts[i] + j]
                emitted.append(tok)
                if j < len(proposal) and tok == proposal[j]:
                    m += 1
                    continue
                break  # first divergence: tok is the bonus token
            accepted_step += m
            self.spec_accepted_total += m
            # window rows 0..m hold K/V for [last, d1..dm], all on the
            # accepted timeline; anything past is a rejected draft and
            # is rolled back before anyone can prefix-match or audit it
            new_ctx = seq.ctx_len + m + 1
            if m < len(proposal):
                self.allocator.truncate_to(seq.seq_id, new_ctx)
            seq.ctx_len = new_ctx
            self.allocator.note_written(
                seq.seq_id, seq.prompt + seq.generated + proposal[:m])
            # recorded before the tokens it produced, so the window lands
            # inside the gap those tokens anchor
            _seqtrace.event(
                seq.seq_id, "spec_window", proposed=len(proposal),
                accepted=m, rollback=len(proposal) - m,
                ms=round(prop_ms_by.get(seq.seq_id, 0.0)
                         + verify_ms / b, 3))
            for tok in emitted:
                events += self._emit(seq, tok)
                if seq.seq_id not in self._seqs:
                    break  # eos/length finished the sequence
        self._publish_spec(proposed_step, accepted_step, verify_ms,
                           float(b))
        return events

    def _publish_spec(self, proposed: int, accepted: int,
                      verify_ms: float, batch: float) -> None:
        if not obs.enabled():
            return
        if proposed:
            obs.counter("llm_spec_proposed_tokens_total",
                        "draft tokens proposed to the target verifier "
                        "by speculative decoding "
                        "(FLAGS_speculative_k)").inc(proposed)
        if accepted:
            obs.counter("llm_spec_accepted_tokens_total",
                        "draft tokens accepted by the target's "
                        "longest-prefix verification — each one "
                        "skipped a full target decode step"
                        ).inc(accepted)
        if self.spec_proposed_total:
            obs.gauge("llm_spec_accept_rate",
                      "cumulative accepted/proposed draft-token ratio "
                      "of this engine (1.0 = every draft token "
                      "matched the target)").set(
                          self.spec_accepted_total
                          / self.spec_proposed_total)
        obs.histogram("llm_spec_verify_ms",
                      "wall time of one batched ragged multi-query "
                      "verify forward (speculative decoding)",
                      buckets=_m.LATENCY_MS_BUCKETS).observe(verify_ms)
        obs.histogram("llm_decode_batch_size",
                      "sequences per continuous-batching decode step",
                      buckets=[1.0, 2.0, 4.0, 8.0, 16.0, 32.0]
                      ).observe(batch)

    def _sample(self, seqs: List[Sequence], logits: torch.Tensor,
                indices: List[int]) -> List[int]:
        """Tokens for the rows of ``logits`` ``[N, V]``: row r is the
        token at generated-index ``indices[r]`` of ``seqs[r]``. Argmax at
        temperature 0, else argmax of ``logits / T`` plus the noise of
        position (seed, sample_offset + index) — keyed by position, not
        by call order, so a speculative window draws exactly what
        sequential decode would, and a stream resumed with
        ``sample_offset`` continues the original's draws. All on the
        device; the tokens reach the host in one read (its host time is
        the step record's ``sample`` sub-segment)."""
        _t = time.perf_counter()
        logits = logits.float()
        hot = [r for r, s in enumerate(seqs) if s.temperature > 0.0]
        if hot:
            dev = logits.device
            rows = torch.tensor(hot, device=dev)
            temps = torch.tensor([seqs[r].temperature for r in hot],
                                 device=dev)
            noise = sampling_noise(
                [(seqs[r].seed, seqs[r].sample_offset + indices[r])
                 for r in hot], logits.shape[-1], dev)
            logits = logits.index_copy(
                0, rows, logits[rows] / temps[:, None] + noise)
        tokens = logits.argmax(dim=-1).tolist()
        self._prof_acc("sample", (time.perf_counter() - _t) * 1e3)
        return tokens

    def _emit(self, seq: Sequence, token: int) -> List[Dict[str, Any]]:
        idx = len(seq.generated)
        seq.generated.append(token)
        self.tokens_generated += 1
        events: List[Dict[str, Any]] = [{
            "type": "token", "seq_id": seq.seq_id, "token": token,
            "index": idx, "dispatch_unix": seq.dispatch_unix}]
        _seqtrace.event(seq.seq_id, "token", index=idx)
        reason = None
        if seq.eos_token_id is not None and token == seq.eos_token_id:
            reason = "eos"
        elif len(seq.generated) >= seq.max_new_tokens:
            reason = "length"
        if reason is not None:
            self.scheduler.finish(seq)
            self._seqs.pop(seq.seq_id, None)
            self._projected.pop(seq.seq_id, None)
            events.append({"type": "finished", "seq_id": seq.seq_id,
                           "reason": reason,
                           "tokens": len(seq.generated)})
            _seqtrace.finish(seq.seq_id, "finished", reason=reason,
                             tokens=len(seq.generated))
        return events

    def _fail(self, seq: Sequence, error: str) -> Dict[str, Any]:
        self.scheduler.finish(seq)
        self._seqs.pop(seq.seq_id, None)
        self._projected.pop(seq.seq_id, None)
        _seqtrace.finish(seq.seq_id, "error", error=error[:200],
                         tokens=len(seq.generated))
        return {"type": "error", "seq_id": seq.seq_id, "error": error,
                "tokens": len(seq.generated)}

    # -- watchdog + invariant audit ---------------------------------------

    @staticmethod
    def _stall_factor() -> float:
        return float(GLOBAL_FLAGS.get("llm_stall_factor"))

    def _note_step(self, dt: float) -> None:
        """EWMA stall watchdog: a step that took stall_factor times
        longer than the running average (and past the floor) is a stall
        — forced flight event + counter; health() also reads a step that
        never returns."""
        self._step_end_unix = time.time()
        ewma = self._step_ewma_s
        factor = self._stall_factor()
        if factor > 0 and ewma is not None \
                and dt > max(STALL_MIN_S, factor * ewma):
            self.stalls_total += 1
            _flight.record("llm_engine_stalled", force=True,
                           step_s=round(dt, 4),
                           ewma_s=round(ewma, 4), factor=factor)
            # hang doctor: capture + classify thread stacks for the
            # post-hoc record (the live capture mid-wedge is the hang
            # monitor's job: this path runs after the step returned).
            # Debounced per source inside the doctor; never raises.
            _stacks.doctor().on_stall(
                "serving_step",
                detail={"step_s": round(dt, 4),
                        "ewma_s": round(ewma, 4), "factor": factor})
            if obs.enabled():
                obs.counter("llm_engine_stalled_total",
                            "engine steps flagged by the stall "
                            "watchdog: wall time exceeded "
                            "llm_stall_factor x the EWMA step time"
                            ).inc()
        self._step_ewma_s = dt if ewma is None else 0.8 * ewma + 0.2 * dt

    def _audit(self) -> None:
        """Post-step KV invariant audit: the allocator's accounting must
        be consistent and no decode-phase sequence may hold cache past
        its committed context (a rejected draft window that was not
        rolled back shows up exactly there). Raises AssertionError — a
        serving loop that leaks blocks must fail loudly. The
        ``kv_blocks_*`` gauges must agree with the allocator too."""
        agree = None
        try:
            self.allocator.check()
            for seq in self.scheduler.running:
                if not seq.prefill_done:
                    continue
                held = self.allocator.tokens(seq.seq_id)
                if held != seq.ctx_len:
                    raise AssertionError(
                        f"seq {seq.seq_id} holds cache for {held} tokens "
                        f"but committed ctx_len is {seq.ctx_len} — "
                        f"speculative rollback missed a rejected draft "
                        f"window")
            agree = self.allocator.gauges_agree()
            if agree is False:
                raise AssertionError(
                    "kv_blocks_used/free gauges disagree with the "
                    f"allocator (used={self.allocator.num_used}, "
                    f"free={self.allocator.num_free})")
        except AssertionError:
            self._audit_failed = True
            _flight.record("llm_kv_audit_failed", force=True,
                           used=self.allocator.num_used,
                           free=self.allocator.num_free,
                           gauges_agree=agree)
            if obs.enabled():
                obs.counter("llm_kv_audit_failures_total",
                            "post-step KV invariant audits that "
                            "failed (allocator accounting broken or "
                            "gauges drifted) — the engine reports "
                            "unhealthy on /healthz until restart"
                            ).inc()
            raise

    def health(self) -> Dict[str, Any]:
        """Live health. ``stalled`` is judged from the step stamps, so a
        step wedged right now (or a loop that stopped stepping an
        active engine) reads unhealthy without waiting for it."""
        now = time.time()
        stamps = [x for x in (self._step_begin_unix, self._step_end_unix)
                  if x is not None]
        age = max(0.0, now - max(stamps)) if stamps else None
        factor = self._stall_factor()
        ewma = self._step_ewma_s
        stalled = bool(factor > 0 and self.active() and age is not None
                       and ewma is not None
                       and age > max(STALL_MIN_S, factor * ewma))
        return {"active": self.active(),
                "running": len(self.scheduler.running),
                "prefilling": sum(1 for s in self.scheduler.running
                                  if not s.prefill_done),
                "waiting": len(self.scheduler.waiting),
                "kv_blocks_used": self.allocator.num_used,
                "last_step_age_s": None if age is None else round(age, 3),
                "step_ewma_s": None if ewma is None else round(ewma, 4),
                "stalls_total": self.stalls_total,
                "stalled": stalled,
                "audit_failed": self._audit_failed,
                "speculative": {
                    "k": self._spec_k(),
                    "proposed_tokens": self.spec_proposed_total,
                    "accepted_tokens": self.spec_accepted_total,
                    "accept_rate":
                        round(self.spec_accepted_total
                              / self.spec_proposed_total, 4)
                        if self.spec_proposed_total else None,
                    "verify_ms_mean":
                        round(self.spec_verify_ms_total
                              / self.spec_verify_steps, 3)
                        if self.spec_verify_steps else None}}

    def _publish(self) -> None:
        if not obs.enabled():
            return
        obs.gauge("llm_running_seqs",
                  "sequences in the continuous-batching running set"
                  ).set(float(len(self.scheduler.running)))
        obs.gauge("llm_waiting_seqs",
                  "sequences queued for admission (prefill pending)"
                  ).set(float(len(self.scheduler.waiting)))
        obs.gauge("llm_prefilling_seqs",
                  "admitted sequences still mid-chunked-prefill (not "
                  "yet in the decode batch)").set(float(
                      sum(1 for s in self.scheduler.running
                          if not s.prefill_done)))
        active: Dict[str, int] = {}
        for s in self.scheduler.running:
            lbl = tenancy.tenant_label(s.tenant)
            active[lbl] = active.get(lbl, 0) + 1
        g = obs.gauge("llm_tenant_active",
                      "live sequences (running set) per tenant label "
                      "— the fleet_status.py --tenants active column")
        for lbl, n in active.items():
            g.set(float(n), tenant=lbl)
        # a tenant that just drained must read 0, not its last value
        for lbl in self._tenant_labels_seen - set(active):
            g.set(0.0, tenant=lbl)
        self._tenant_labels_seen |= set(active)
