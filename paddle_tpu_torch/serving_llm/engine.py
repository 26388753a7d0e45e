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

Observability and fault-injection hooks of the JAX engine (sequence
timelines, step profiler, metrics, flight recorder, fault points, stall
stack diagnosis) are not part of this package yet.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import kernels
from ..core.place import resolve_device
from ..flags import GLOBAL_FLAGS
from ..models.gpt_lm import dense_causal_attention
from . import tenancy
from .kv_cache import KVBlockAllocator
from .scheduler import ContinuousBatchingScheduler, Sequence

__all__ = ["LLMEngine", "AdmissionRejected"]

# stall watchdog floor: a step (or inter-step gap) must exceed both the
# floor and stall_factor * EWMA before the engine reads as stalled
STALL_MIN_S = 0.5

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
        # speculative decoding (FLAGS_speculative_k): None means the
        # draft is auto-built on first use (FLAGS_speculative_draft_*);
        # draft_model=model self-drafts (accept rate 1.0)
        self._draft_model = draft_model
        self.spec_proposed_total = 0
        self.spec_accepted_total = 0
        self.spec_verify_steps = 0
        self.spec_verify_ms_total = 0.0

    # -- request lifecycle ------------------------------------------------

    def add_request(self, prompt_ids, max_new_tokens: int = 16,
                    eos_token_id: Optional[int] = None,
                    temperature: float = 0.0, seed: int = 0,
                    sample_offset: int = 0,
                    tenant: str = tenancy.DEFAULT_TENANT,
                    priority_class: str = tenancy.DEFAULT_CLASS) -> int:
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
                       sample_offset=int(sample_offset),
                       tenant=tenant, priority_class=priority_class)
        self._seqs[seq.seq_id] = seq
        self._projected[seq.seq_id] = projected
        self.scheduler.add(seq)
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
                self._reject(projected, t_committed, t_budget,
                             "tenant KV budget")
        if watermark > 0:
            budget = watermark * self.pool_blocks
            committed = sum(self._projected.values())
            if committed + projected > budget:
                self._reject(projected, committed, budget,
                             "watermark budget")
        return projected

    def _reject(self, projected: int, committed: float, budget: float,
                what: str) -> None:
        self.admission_rejected_total += 1
        load = len(self.scheduler.running) + len(self.scheduler.waiting)
        retry_after_ms = 50 * (1 + load)
        raise AdmissionRejected(
            f"admission rejected: projected {projected} KV blocks + "
            f"{committed} committed exceeds {what} "
            f"{budget:.1f} of {self.pool_blocks}; "
            f"retry_after_ms={retry_after_ms}", retry_after_ms)

    def cancel(self, seq_id: int) -> bool:
        """Drop a sequence (client disconnect): blocks freed, no further
        events for it. True if it was live."""
        seq = self.scheduler.cancel(seq_id)
        self._seqs.pop(seq_id, None)
        self._projected.pop(seq_id, None)
        return seq is not None

    def active(self) -> bool:
        return self.scheduler.active()

    # -- one engine step --------------------------------------------------

    def step(self) -> List[Dict[str, Any]]:
        """Admit + prefill new sequences, then one decode step for the
        running batch. Returns token/finished/error event dicts in
        emission order. Timed by the stall watchdog (EWMA of step wall
        time, FLAGS_llm_stall_factor) and followed by the KV invariant
        audit, which raises on a leak."""
        self._step_begin_unix = time.time()
        t0 = time.perf_counter()
        events: List[Dict[str, Any]] = []
        try:
            with torch.no_grad():
                events = self._step_inner()
        finally:
            dt = time.perf_counter() - t0
            # fair-share ledger: resident context x step wall time
            self.scheduler.charge(dt)
            self._note_step(dt)
        self._audit()
        return events

    def _step_inner(self) -> List[Dict[str, Any]]:
        events: List[Dict[str, Any]] = []
        try:
            self.scheduler.admit()
        except Exception as e:  # noqa: BLE001 — fail the one request
            # allocate() raised before the head left the waiting queue
            if self.scheduler.waiting:
                seq = self.scheduler.waiting.popleft()
                events.append(self._fail(seq, f"kv allocation: {e}"))
        # chunked prefill tick: every running sequence with unwritten
        # context advances ONE chunk (the whole remainder when chunking
        # is off), newly admitted sequences included
        for seq in [s for s in self.scheduler.running
                    if not s.prefill_done]:
            if seq not in self.scheduler.running:
                continue  # preempted by an earlier sequence's COW
            try:
                events += self._prefill_chunk(seq)
            except Exception as e:  # noqa: BLE001 — fail ONE request
                events.append(self._fail(seq, str(e)))
        events += self._decode()
        return events

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
            for pool in self._k_pools + self._v_pools:
                pool[new] = pool[old]

    def _prefill_chunk(self, seq: Sequence) -> List[Dict[str, Any]]:
        """One prefill chunk for ``seq``: forward the next
        FLAGS_prefill_chunk_tokens positions (everything left when
        chunking is off), attending over the already-cached prefix
        gathered from the pool, and write the fresh K/V rows into the
        sequence's blocks. The final chunk samples the first token."""
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
            self._k_pools[i][blks, offs] = k[0].float()
            self._v_pools[i][blks, offs] = v[0].float()
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
        if seq.ctx_len < t:
            return []  # mid-prefill: decode keeps ticking meanwhile
        seq.prefill_done = True
        return self._emit(seq, self._sample([seq], logits[None],
                                            [len(seq.generated)])[0])

    def _grow_batch(self, k: int, events: List[Dict[str, Any]]):
        """Grow every decode-ready sequence (oldest first: preemption
        evicts from the young end) by 1 token, or — speculative — by its
        draft window plus 1. Returns (batch, windows)."""
        todo = sorted((s for s in self.scheduler.running
                       if s.prefill_done and s.generated),
                      key=lambda s: s.admit_order)
        draft = self._draft() if k > 0 else None
        batch: List[Sequence] = []
        windows: Dict[int, List[int]] = {}
        for seq in todo:
            if seq not in self.scheduler.running:
                continue  # preempted by an older sequence's growth
            try:
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
                events.append(self._fail(seq, f"decode: {e}"))
                continue
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
        return [s for s in batch if s in self.scheduler.running], windows

    def _decode(self) -> List[Dict[str, Any]]:
        k = self._spec_k()
        if k > 0:
            return self._decode_speculative(k)
        events: List[Dict[str, Any]] = []
        batch, _ = self._grow_batch(0, events)
        if not batch:
            return events
        newpos = np.asarray([s.ctx_len for s in batch])
        slots = [self._slots(s, np.asarray([s.ctx_len])) for s in batch]
        blks = self._dev([s[0][0] for s in slots])
        offs = self._dev([s[1][0] for s in slots])
        tbl = self._block_tables(batch)
        lens = self._dev(newpos + 1, torch.int32)

        def attn_fn(i, q, k, v):
            self._k_pools[i][blks, offs] = k[:, 0].float()
            self._v_pools[i][blks, offs] = v[:, 0].float()
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
        batch, windows = self._grow_batch(k, events)
        if not batch:
            return events
        b = len(batch)
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
            self._k_pools[i][blks, offs] = kk[rows_b, rows_q].float()
            self._v_pools[i][blks, offs] = vv[rows_b, rows_q].float()
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
        self.spec_verify_steps += 1
        self.spec_verify_ms_total += (time.perf_counter() - t0) * 1e3
        # proposed counts only windows that reached the verifier
        self.spec_proposed_total += int(q_lens.sum()) - b
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
            for tok in emitted:
                events += self._emit(seq, tok)
                if seq.seq_id not in self._seqs:
                    break  # eos/length finished the sequence
        return events

    @staticmethod
    def _sample(seqs: List[Sequence], logits: torch.Tensor,
                indices: List[int]) -> List[int]:
        """Tokens for the rows of ``logits`` ``[N, V]``: row r is the
        token at generated-index ``indices[r]`` of ``seqs[r]``. Argmax at
        temperature 0, else argmax of ``logits / T`` plus the noise of
        position (seed, sample_offset + index) — keyed by position, not
        by call order, so a speculative window draws exactly what
        sequential decode would, and a stream resumed with
        ``sample_offset`` continues the original's draws. All on the
        device; the tokens reach the host in one read."""
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
        return logits.argmax(dim=-1).tolist()

    def _emit(self, seq: Sequence, token: int) -> List[Dict[str, Any]]:
        idx = len(seq.generated)
        seq.generated.append(token)
        self.tokens_generated += 1
        events: List[Dict[str, Any]] = [{
            "type": "token", "seq_id": seq.seq_id, "token": token,
            "index": idx, "dispatch_unix": seq.dispatch_unix}]
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
        return events

    def _fail(self, seq: Sequence, error: str) -> Dict[str, Any]:
        self.scheduler.finish(seq)
        self._seqs.pop(seq.seq_id, None)
        self._projected.pop(seq.seq_id, None)
        return {"type": "error", "seq_id": seq.seq_id, "error": error,
                "tokens": len(seq.generated)}

    # -- watchdog + invariant audit ---------------------------------------

    @staticmethod
    def _stall_factor() -> float:
        return float(GLOBAL_FLAGS.get("llm_stall_factor"))

    def _note_step(self, dt: float) -> None:
        """EWMA stall watchdog: a step that took stall_factor times
        longer than the running average (and past the floor) counts as
        a stall; health() also reads a step that never returns."""
        self._step_end_unix = time.time()
        ewma = self._step_ewma_s
        factor = self._stall_factor()
        if factor > 0 and ewma is not None \
                and dt > max(STALL_MIN_S, factor * ewma):
            self.stalls_total += 1
        self._step_ewma_s = dt if ewma is None else 0.8 * ewma + 0.2 * dt

    def _audit(self) -> None:
        """Post-step KV invariant audit: the allocator's accounting must
        be consistent and no decode-phase sequence may hold cache past
        its committed context (a rejected draft window that was not
        rolled back shows up exactly there). Raises AssertionError — a
        serving loop that leaks blocks must fail loudly."""
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
            if self.allocator.gauges_agree() is False:
                raise AssertionError("kv_blocks_* gauges disagree with "
                                     "the allocator")
        except AssertionError:
            self._audit_failed = True
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
