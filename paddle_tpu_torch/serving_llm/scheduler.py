"""Continuous-batching scheduler for the LLM serving engine.

Counterpart of ``paddle_tpu.serving_llm.scheduler``, the same policy.
Sequences JOIN and LEAVE the decode batch every step instead of
waiting for a static batch to drain. Policy, deliberately simple and
fully tested:

* **Admission** is FCFS off the waiting queue: a prefill is admitted
  when the running set is below ``FLAGS_max_decode_batch`` AND the
  paged allocator can cover its whole prompt (plus any tokens
  generated before a preemption). A short prompt arriving mid-decode
  of a long one is therefore in the batch on the very next step —
  the interleaving property the tests assert. Under
  ``FLAGS_kv_prefix_sharing`` the allocator satisfies the already-
  resident prefix by refcount bumps, so admission passes the token
  timeline and records the shared-token count on the sequence
  (prefill resumes from there).
* **Growth** happens one token per decode step. When the pool is
  exhausted the scheduler preempts a victim in a TOTAL order:
  lowest priority class first, youngest (max admission seq) within a
  class — with every sequence at the default class this is exactly
  preempt-youngest (LIFO), and the total order makes tie-breaks
  deterministic across runs. The victim's blocks are freed and it
  returns to the FRONT of the waiting queue to be re-prefilled later
  (recompute-on-readmit, the vLLM recovery model — generated tokens
  are kept, only the cache is recomputed). Oldest work is protected,
  so progress is monotone and a sequence that fits alone can never
  starve. A grower never evicts a sequence of a HIGHER class than
  its own: when only higher-class victims remain it preempts itself
  back to the queue instead (a bulk stream can stall under premium
  load; a premium stream never loses blocks to bulk).
* **Fair share** (``FLAGS_tenant_fair_share``): admission stops
  being globally FCFS and becomes weighted fair queueing over the
  per-tenant queue heads — each slot goes to the tenant with the
  lowest weight-normalized token-second service, FCFS *within* the
  tenant (tenancy.py). A tenant whose head cannot allocate is set
  aside for the pass and the next-best tenant is tried, so a bulk
  prompt too big for the current pool never head-of-line-blocks
  premium admission.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

from ..flags import GLOBAL_FLAGS
from . import tenancy
from .kv_cache import KVBlockAllocator

__all__ = ["Sequence", "ContinuousBatchingScheduler"]


@dataclass
class Sequence:
    """One generate request's decoding state. ``prompt`` is the token
    id list; ``generated`` accumulates sampled ids (kept across
    preemptions); ``ctx_len`` counts tokens whose K/V currently sit in
    the pool (0 while waiting). ``cached_tokens`` is the leading-token
    count satisfied by prefix sharing at admission — prefill starts
    there instead of position 0. ``prefill_done`` flips when the last
    prefill chunk lands; only then does the sequence join the decode
    batch (chunked prefill advances one chunk per step).
    ``sample_offset`` shifts the position-keyed sampler: a stream
    resumed after a router failover re-sends prompt+delivered as the
    prompt and sets this to the delivered count, so token ``i`` of the
    resumed stream draws the RNG key of generated-index ``offset + i``
    — bitwise the token the dead backend would have produced next
    (docs/serving_protocol.md, "Stream failover & resume").
    ``trace_id`` is the wire's id of the request (0: untraced).
    ``tenant``/``priority_class`` are the wire identity (tenancy.py):
    fair-share accounting keys on the tenant, victim selection and
    shed order key on the class."""
    seq_id: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_token_id: Optional[int] = None
    temperature: float = 0.0
    seed: int = 0
    trace_id: int = 0
    sample_offset: int = 0
    tenant: str = tenancy.DEFAULT_TENANT
    priority_class: str = tenancy.DEFAULT_CLASS
    generated: List[int] = field(default_factory=list)
    ctx_len: int = 0
    cached_tokens: int = 0
    prefill_done: bool = False
    admit_order: int = -1   # admission stamp; youngest = max
    preemptions: int = 0
    dispatch_unix: Optional[float] = None  # first prefill wall time

    @property
    def total_tokens(self) -> int:
        """Tokens the cache must cover for a (re-)prefill: prompt
        plus everything generated before any preemption reset."""
        return len(self.prompt) + len(self.generated)

    @property
    def class_rank(self) -> int:
        """Preemption/shed order of this sequence's priority class
        (bulk=0 < standard=1 < premium=2)."""
        return tenancy.class_rank(self.priority_class)


class ContinuousBatchingScheduler:
    def __init__(self, allocator: KVBlockAllocator,
                 max_decode_batch: Optional[int] = None):
        self.allocator = allocator
        self._max_decode_batch = max_decode_batch
        self.waiting: Deque[Sequence] = deque()
        self.running: List[Sequence] = []
        self._admit_n = 0
        self.preemptions_total = 0
        # cumulative token-second service per tenant (resident
        # context-length x wall-seconds, charged by the engine step);
        # single-threaded with the engine step loop like every other
        # scheduler field
        self._service: Dict[str, float] = {}
        # monotonic WFQ virtual clock: tracks the lowest weight-
        # normalized service among running tenants as they charge.
        # Idle tenants re-enter floored to it, so a tenant that ran
        # alone earlier doesn't carry "debt" into a later contention
        # (and an idle one doesn't bank credit)
        self._vclock = 0.0

    def max_decode_batch(self) -> int:
        if self._max_decode_batch is not None:
            return int(self._max_decode_batch)
        return max(1, int(GLOBAL_FLAGS.get("max_decode_batch")))

    # -- lifecycle --------------------------------------------------------

    def add(self, seq: Sequence) -> None:
        if self._fair_share_on():
            self._floor_service(seq.tenant)
        self.waiting.append(seq)

    def admit(self) -> List[Sequence]:
        """Admission pass: move waiting sequences into the running set
        while there is batch room and the pool covers their prefill
        (+1 headroom is NOT reserved — growth is handled per-step with
        preemption as the backstop). FCFS off the queue by default;
        under ``FLAGS_tenant_fair_share`` each slot goes to the head
        of the least-served tenant queue instead (FCFS within a
        tenant), with allocation-blocked tenants set aside for the
        pass. Returns the newly admitted sequences, which the engine
        must prefill."""
        admitted: List[Sequence] = []
        cap = self.max_decode_batch()
        fair = self._fair_share_on()
        blocked: set = set()  # tenants whose head cannot allocate
        while self.waiting and len(self.running) < cap:
            seq = (self._pick_fair(blocked) if fair
                   else self.waiting[0])
            if seq is None:
                break  # every tenant head is allocation-blocked
            tokens = seq.prompt + seq.generated
            if not self.allocator.allocate(seq.seq_id, len(tokens),
                                           tokens=tokens):
                if not fair:
                    break  # FCFS: never skip the queue head
                # fair share: this tenant's head stays the head (no
                # within-tenant skip) but other tenants may still fit
                blocked.add(seq.tenant)
                continue
            self.waiting.remove(seq)
            # the shared prefix (if any) is already resident: prefill
            # starts at cached_tokens instead of position 0
            seq.cached_tokens = self.allocator.shared_tokens(seq.seq_id)
            seq.ctx_len = seq.cached_tokens
            seq.prefill_done = False
            self._admit_n += 1
            seq.admit_order = self._admit_n
            self.running.append(seq)
            admitted.append(seq)
        return admitted

    @staticmethod
    def _fair_share_on() -> bool:
        return bool(GLOBAL_FLAGS.get("tenant_fair_share"))

    def _pick_fair(self, blocked: set) -> Optional[Sequence]:
        """Weighted fair queueing over the per-tenant queue heads:
        the first waiting sequence of the tenant with the lowest
        weight-normalized token-second service wins; queue position
        breaks ties (equal-service tenants admit FCFS, so a single
        tenant under fair share behaves exactly like FCFS). Weight
        <= 0 sorts last but still admits when nothing weighted wants
        the slot — the starvation floor."""
        best = None
        best_key = None
        seen: set = set()
        for pos, seq in enumerate(self.waiting):
            t = seq.tenant
            if t in seen or t in blocked:
                continue
            seen.add(t)
            w = tenancy.tenant_weight(t)
            norm = (self._service.get(t, 0.0) / w) if w > 0 \
                else float("inf")
            key = (norm, pos)
            if best_key is None or key < best_key:
                best, best_key = seq, key
        return best

    def _floor_service(self, tenant: str) -> None:
        """Idle-tenant re-entry floor, applied when a tenant ARRIVES
        into a new backlogged period (no waiting or running work):
        its service is lifted to the virtual clock so idle time never
        converts into a catch-up monopoly, and a tenant that ran
        alone earlier doesn't drag catch-up debt into a later
        contention (the WFQ virtual-start-time rule:
        start = max(own finish, virtual now)). A tenant with work in
        the system keeps its raw ledger — flooring mid-backlog would
        erase the weight differentiation fair share exists for."""
        if any(s.tenant == tenant for s in self.running) or \
                any(s.tenant == tenant for s in self.waiting):
            return
        w = tenancy.tenant_weight(tenant)
        if w > 0:
            self._service[tenant] = max(
                self._service.get(tenant, 0.0), self._vclock * w)

    def charge(self, dt_s: float) -> None:
        """Accrue token-second service: each resident sequence
        charges its tenant ctx_len x dt. Called once per engine step
        with the measured step duration. Advances the virtual clock
        to the lowest normalized service among the tenants that just
        charged (virtual time moves at the pace of the most-starved
        backlogged flow)."""
        if dt_s <= 0:
            return
        for s in self.running:
            if s.ctx_len > 0:
                self._service[s.tenant] = (
                    self._service.get(s.tenant, 0.0)
                    + s.ctx_len * dt_s)
        norms = []
        for t in {s.tenant for s in self.running}:
            w = tenancy.tenant_weight(t)
            if w > 0:
                norms.append(self._service.get(t, 0.0) / w)
        if norms:
            self._vclock = max(self._vclock, min(norms))

    def service_snapshot(self) -> Dict[str, float]:
        """Per-tenant cumulative token-seconds (fair-share ledger)."""
        return dict(self._service)

    def grow(self, seq: Sequence, n_tokens: int) -> bool:
        """Extend ``seq``'s cache to ``n_tokens`` slots, preempting
        victims one at a time — lowest class first, youngest within a
        class, never a class above ``seq``'s own — if the pool is
        short. When only higher-class victims remain, ``seq`` preempts
        ITSELF back to the waiting queue (check membership after a
        False). False with ``seq`` still running only when the pool
        cannot cover it even with ``seq`` alone (caller should fail
        the request: it can never fit)."""
        while True:
            if self.allocator.extend_to(seq.seq_id, n_tokens):
                return True
            victim = self._victim(exclude=seq)
            if victim is None:
                if any(s is not seq for s in self.running):
                    # residents it may not touch hold the pool: yield
                    # rather than die — readmission recomputes
                    self.preempt(seq)
                return False
            self.preempt(victim)

    def make_writable(self, seq: Sequence, block_idx: int):
        """Copy-on-write backstop: make the block at ``seq``'s table
        position ``block_idx`` private, preempting victims (same
        total order and class gate as ``grow``) if the pool cannot
        supply the copy target. Returns what allocator.make_private
        returns — None (already private), an (old, new) pair the
        engine must copy in-pool, or False when it can never fit;
        as in ``grow``, a False with ``seq`` gone from the running
        set means it preempted itself and will retry after
        readmission. Preempting the very sequence the block is
        shared with drops its refcount to 1, so the retry then needs
        no copy at all."""
        while True:
            r = self.allocator.make_private(seq.seq_id, block_idx)
            if r is not False:
                return r
            victim = self._victim(exclude=seq)
            if victim is None:
                if any(s is not seq for s in self.running):
                    self.preempt(seq)
                return False
            self.preempt(victim)

    def _victim(self, exclude: Sequence) -> Optional[Sequence]:
        """Preemption victim in a TOTAL order: (class rank asc,
        admission seq desc) — deterministic where preempt-youngest
        tied on dict order — restricted to classes at or below the
        grower's (bulk pressure must never evict premium blocks).
        With every sequence at the default class this is exactly
        preempt-youngest."""
        cap = exclude.class_rank
        cands = [s for s in self.running
                 if s is not exclude and s.class_rank <= cap]
        if not cands:
            return None
        return min(cands,
                   key=lambda s: (s.class_rank, -s.admit_order))

    def preempt(self, seq: Sequence) -> None:
        """Evict ``seq`` from the running set back to the FRONT of the
        waiting queue: blocks freed, generated tokens kept, cache
        recomputed at readmission."""
        self.allocator.free(seq.seq_id)
        self.running.remove(seq)
        seq.ctx_len = 0
        seq.cached_tokens = 0
        seq.prefill_done = False
        seq.preemptions += 1
        self.preemptions_total += 1
        self.waiting.appendleft(seq)

    def finish(self, seq: Sequence) -> None:
        self.allocator.free(seq.seq_id)
        if seq in self.running:
            self.running.remove(seq)

    def cancel(self, seq_id: int) -> Optional[Sequence]:
        """Remove a sequence wherever it lives (client disconnect).
        Frees its blocks; returns the sequence or None if unknown."""
        for seq in list(self.running):
            if seq.seq_id == seq_id:
                self.allocator.free(seq_id)
                self.running.remove(seq)
                return seq
        for seq in list(self.waiting):
            if seq.seq_id == seq_id:
                self.allocator.free(seq_id)  # no-op: waiting holds none
                self.waiting.remove(seq)
                return seq
        return None

    def active(self) -> bool:
        return bool(self.waiting or self.running)
