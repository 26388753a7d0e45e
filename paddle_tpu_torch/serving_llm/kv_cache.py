"""Paged KV-cache block allocator with copy-on-write prefix sharing.

vLLM-style cache management for the LLM serving subsystem: KV memory
is a preallocated pool of fixed-size token blocks
(``FLAGS_kv_pool_blocks`` blocks of ``FLAGS_kv_block_size`` token
slots), and each running sequence owns a BLOCK TABLE — an ordered list
of pool indices — instead of a contiguous [T_max] cache slab. The
allocator is pure bookkeeping over block INDICES; the tensors
themselves live in LLMEngine's per-layer pools, and the ragged paged
attention kernel consumes the tables directly
(kernels/paged_attention.py).

**Prefix sharing (FLAGS_kv_prefix_sharing):** every physical block
carries a REFCOUNT. ``allocate()`` satisfies the already-resident
prefix of a new sequence's token timeline by bumping refcounts on
another sequence's blocks instead of popping the free list — full
blocks through a hash-of-full-blocks index (token-prefix tuple →
block), plus at most one partial tail block matched against a live
sequence's written timeline. ``free()`` decrements and only returns
refcount-0 blocks to the free list. A shared block is READ-ONLY: the
first divergent write goes through :meth:`make_private` (copy-on-
write — the engine copies the K/V rows in-pool). The decode kernel
needs zero changes; block tables are already indirect.

Counterpart of ``paddle_tpu.serving_llm.kv_cache``, pure bookkeeping
with the same LIFO free order, refcounts and index. ``check()`` audits
refcounts (per-table reference counts must equal the refcount map; no
refcount-0 block outside the free list), and the scheduler's preemption
decisions read ``num_free``. The ``kv_blocks_{used,free,shared}``
gauges and the ``kv_*_total`` counters are published as the JAX
allocator publishes them (with FLAGS_enable_metrics on), and the
``kv_alloc`` fault point fires at the same calls. Single-owner object
(the engine's serving thread); no internal locking.
"""

from __future__ import annotations

import itertools
from collections import Counter
from typing import Dict, List, Optional, Sequence as Seq, Tuple

from .. import observability as obs
from ..flags import GLOBAL_FLAGS
from ..testing import faults as _faults

__all__ = ["KVBlockAllocator"]

# last allocator to publish the kv_blocks_* gauges (engines audit
# gauge-vs-allocator agreement only when their own allocator wrote the
# gauge last — several engines in one process share the registry)
_pub_tokens = itertools.count(1)
_last_pub_token: Optional[int] = None


class KVBlockAllocator:
    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be >= 1")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # LIFO free list: recently-freed blocks are re-issued first,
        # which keeps the hot pool region small
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self._tables: Dict[int, List[int]] = {}
        self._tokens: Dict[int, int] = {}
        # per-block refcount, used blocks only (a block with refcount
        # >= 2 is shared and read-only; COW via make_private)
        # guarded-by: single-owner (engine serving thread)
        self._refs: Dict[int, int] = {}
        # prefix-sharing index: token-prefix tuple (length = a whole
        # number of blocks) -> the physical block holding that
        # prefix's LAST block of K/V rows, plus the reverse map so a
        # freed block drops its entry. Content-addressed by the exact
        # token prefix — block j's K/V rows depend on every token
        # before them, so the key must cover positions [0, (j+1)*bs).
        # guarded-by: single-owner (engine serving thread)
        self._full_index: Dict[Tuple[int, ...], int] = {}
        self._index_key: Dict[int, Tuple[int, ...]] = {}
        # written token timeline per live sequence (only maintained
        # while FLAGS_kv_prefix_sharing is on): the partial-tail match
        # and the full-block registration both read it
        # guarded-by: single-owner (engine serving thread)
        self._timelines: Dict[int, List[int]] = {}
        # leading tokens satisfied by sharing at allocate() time
        self._shared_tokens: Dict[int, int] = {}
        self.allocs_total = 0
        self.freed_total = 0
        self.alloc_failures_total = 0
        self.cow_copies_total = 0
        self.prefix_hit_tokens_total = 0
        self._pub_token = next(_pub_tokens)
        self._publish()

    # -- queries ----------------------------------------------------------

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def num_shared(self) -> int:
        """Blocks referenced by two or more block tables."""
        return sum(1 for r in self._refs.values() if r >= 2)

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` token slots."""
        return -(-max(0, int(n_tokens)) // self.block_size)

    def table(self, seq_id: int) -> List[int]:
        return list(self._tables.get(seq_id, ()))

    def tokens(self, seq_id: int) -> int:
        return self._tokens.get(seq_id, 0)

    def shared_tokens(self, seq_id: int) -> int:
        """Leading tokens of ``seq_id`` whose K/V were already
        resident when it was allocated (prefill may skip them)."""
        return self._shared_tokens.get(seq_id, 0)

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)

    def owners(self) -> List[int]:
        return list(self._tables.keys())

    @staticmethod
    def _sharing() -> bool:
        return bool(GLOBAL_FLAGS.get("kv_prefix_sharing"))

    def _match_prefix(self, tokens: Seq[int],
                      limit: int) -> Tuple[List[int], int]:
        """Longest already-resident prefix of ``tokens`` (at most
        ``limit`` tokens): whole blocks through the hash-of-full-
        blocks index, then at most one partial tail block from a live
        sequence's written timeline. Returns (shared blocks, matched
        token count). The caller caps ``limit`` below len(tokens) so
        a fully-cached prompt still computes its final position."""
        bs = self.block_size
        blocks: List[int] = []
        j = 0
        while (j + 1) * bs <= limit:
            b = self._full_index.get(tuple(tokens[:(j + 1) * bs]))
            if b is None:
                break
            blocks.append(b)
            j += 1
        m = j * bs
        # partial tail: continue into block j of a live sequence whose
        # written timeline extends this prefix (COW on first write)
        best: Optional[Tuple[int, int]] = None
        for sid, tl in self._timelines.items():
            tbl = self._tables.get(sid)
            if tbl is None or len(tbl) <= j or len(tl) <= m:
                continue
            if list(tl[:m]) != list(tokens[:m]):
                continue
            stop = min(limit, m + bs, len(tl))
            extra = 0
            while m + extra < stop and tl[m + extra] == tokens[m + extra]:
                extra += 1
            if extra > 0 and (best is None or extra > best[0]):
                best = (extra, tbl[j])
        if best is not None:
            m += best[0]
            blocks.append(best[1])
        return blocks, m

    def probe_shared_tokens(self, tokens: Seq[int]) -> int:
        """How many leading tokens of ``tokens`` an allocate() issued
        right now would satisfy from resident blocks (0 when sharing
        is off). Read-only — the admission watermark projects
        post-sharing demand with it."""
        if not self._sharing() or not tokens:
            return 0
        return self._match_prefix(list(tokens), len(tokens) - 1)[1]

    # -- mutations --------------------------------------------------------

    def allocate(self, seq_id: int, n_tokens: int,
                 tokens: Optional[Seq[int]] = None) -> bool:
        """Give ``seq_id`` (no existing table) blocks for ``n_tokens``
        token slots. All-or-nothing: on a short pool nothing is
        assigned and the failure is counted. When
        FLAGS_kv_prefix_sharing is on and ``tokens`` (the sequence's
        token timeline, len == n_tokens) is passed, the already-
        resident prefix is satisfied by refcount bumps on shared
        blocks instead of free-list pops; ``shared_tokens()`` then
        reports how many leading tokens prefill may skip."""
        if seq_id in self._tables:
            raise ValueError(f"seq {seq_id} already has a block table")
        _faults.hit("kv_alloc")
        shared: List[int] = []
        m = 0
        sharing = tokens is not None and self._sharing()
        if sharing and len(tokens) > 0:
            # cap below n_tokens: the final position is always
            # recomputed so the engine has logits to sample from
            limit = min(len(tokens), int(n_tokens)) - 1
            if limit > 0:
                shared, m = self._match_prefix(list(tokens), limit)
        need = self.blocks_for(n_tokens) - len(shared)
        if need > len(self._free):
            self.alloc_failures_total += 1
            self._count("kv_alloc_failures_total")
            return False
        for b in shared:
            self._refs[b] += 1
        fresh = [self._free.pop() for _ in range(need)]
        for b in fresh:
            self._refs[b] = 1
        self._tables[seq_id] = shared + fresh
        self._tokens[seq_id] = int(n_tokens)
        self._shared_tokens[seq_id] = m
        if sharing:
            # the shared prefix is already-written content
            self._timelines[seq_id] = list(tokens[:m])
        self.allocs_total += need
        if need:
            self._count("kv_blocks_alloc_total", need)
        if m:
            self.prefix_hit_tokens_total += m
            self._count("kv_prefix_hit_tokens_total", m)
        self._publish()
        return True

    def extend_to(self, seq_id: int, n_tokens: int) -> bool:
        """Grow ``seq_id``'s table to cover ``n_tokens`` total slots
        (typically +1 per decode step; most steps need no new block).
        False — with the table untouched — when the pool is short."""
        if seq_id not in self._tables:
            raise KeyError(f"seq {seq_id} has no block table")
        if n_tokens <= self._tokens[seq_id]:
            return True
        _faults.hit("kv_alloc")
        need = self.blocks_for(n_tokens) - len(self._tables[seq_id])
        if need > len(self._free):
            self.alloc_failures_total += 1
            self._count("kv_alloc_failures_total")
            return False
        if need > 0:
            fresh = [self._free.pop() for _ in range(need)]
            for b in fresh:
                self._refs[b] = 1
            self._tables[seq_id] += fresh
            self.allocs_total += need
            self._count("kv_blocks_alloc_total", need)
        self._tokens[seq_id] = int(n_tokens)
        self._publish()
        return True

    def make_private(self, seq_id: int, block_idx: int):
        """Copy-on-write: make the block at table position
        ``block_idx`` exclusive to ``seq_id`` before a write.
        Returns None when the block is already private (refcount 1 —
        nothing to do), an ``(old, new)`` block pair when a copy
        target was allocated (the CALLER must copy the K/V rows
        old → new in-pool before writing), or False when the free
        list is empty (caller preempts a victim and retries)."""
        table = self._tables[seq_id]
        old = table[block_idx]
        if self._refs.get(old, 0) <= 1:
            return None
        if not self._free:
            self.alloc_failures_total += 1
            self._count("kv_alloc_failures_total")
            return False
        new = self._free.pop()
        self._refs[old] -= 1
        self._refs[new] = 1
        table[block_idx] = new
        self.allocs_total += 1
        self.cow_copies_total += 1
        self._count("kv_blocks_alloc_total", 1)
        self._count("kv_cow_copies_total")
        self._publish()
        return (old, new)

    def note_written(self, seq_id: int, tokens: Seq[int]) -> None:
        """Record the token timeline whose K/V now sit in ``seq_id``'s
        blocks (the engine calls this after each prefill chunk and
        decode write). Full blocks enter the hash-of-full-blocks
        index so later allocations can share them. No-op while
        sharing is off."""
        if seq_id not in self._tables or not self._sharing():
            return
        tl = list(int(t) for t in tokens)
        self._timelines[seq_id] = tl
        table = self._tables[seq_id]
        bs = self.block_size
        for j in range(len(tl) // bs):
            b = table[j]
            if b in self._index_key:
                continue
            key = tuple(tl[:(j + 1) * bs])
            if key not in self._full_index:
                self._full_index[key] = b
                self._index_key[b] = key

    def truncate_to(self, seq_id: int, n_tokens: int) -> int:
        """Rewind ``seq_id``'s table to cover exactly ``n_tokens``
        token slots — the speculative-decode rollback: draft-window
        K/V written past the accepted point must stop being part of
        the sequence's cache. Trailing blocks beyond
        ``blocks_for(n_tokens)`` are dereferenced exactly like
        :meth:`free` (refcount decrement; only refcount-0 blocks
        return to the free list, preserving LIFO order — a block
        still shared with another sequence is never recycled), and
        the written timeline is cut back so the rolled-back tokens
        can no longer be prefix-matched. A retained boundary block
        whose full-block index key extends past ``n_tokens`` drops
        its index entry: once this sequence holds it privately its
        tail rows get scribbled by future writes with no COW gate, so
        the content address would go stale (a co-owner's legitimate
        full block is simply re-registered by its next
        note_written). No-op returning 0 when ``n_tokens`` already
        covers the table. Returns blocks returned to the free list.
        """
        if seq_id not in self._tables:
            raise KeyError(f"seq {seq_id} has no block table")
        n_tokens = max(0, int(n_tokens))
        if n_tokens >= self._tokens[seq_id]:
            return 0
        table = self._tables[seq_id]
        keep = self.blocks_for(n_tokens)
        dropped = table[keep:]
        del table[keep:]
        self._tokens[seq_id] = n_tokens
        if seq_id in self._shared_tokens:
            self._shared_tokens[seq_id] = min(
                self._shared_tokens[seq_id], n_tokens)
        tl = self._timelines.get(seq_id)
        if tl is not None and len(tl) > n_tokens:
            del tl[n_tokens:]
        returned: List[int] = []
        for b in reversed(dropped):
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                key = self._index_key.pop(b, None)
                if key is not None:
                    self._full_index.pop(key, None)
                returned.append(b)
        # the retained boundary block: an index key that now extends
        # past the truncation point is (or can silently become) stale
        # content-addressing — drop it
        if table:
            key = self._index_key.get(table[-1])
            if key is not None and len(key) > n_tokens:
                del self._index_key[table[-1]]
                self._full_index.pop(key, None)
        self._free.extend(returned)
        if returned:
            self.freed_total += len(returned)
            self._count("kv_blocks_freed_total", len(returned))
        self._publish()
        return len(returned)

    def free(self, seq_id: int) -> int:
        """Drop every block reference of ``seq_id`` (finish, cancel,
        or preemption); blocks whose refcount hits 0 return to the
        free list (and leave the prefix index — their content is no
        longer addressable). Unknown ids are a no-op returning 0 so
        teardown paths can free unconditionally. Returns the number
        of blocks actually returned to the free list."""
        blocks = self._tables.pop(seq_id, None)
        self._tokens.pop(seq_id, None)
        self._shared_tokens.pop(seq_id, None)
        self._timelines.pop(seq_id, None)
        if not blocks:
            self._publish()
            return 0
        returned: List[int] = []
        for b in reversed(blocks):
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                key = self._index_key.pop(b, None)
                if key is not None:
                    self._full_index.pop(key, None)
                returned.append(b)
        self._free.extend(returned)
        if returned:
            self.freed_total += len(returned)
            self._count("kv_blocks_freed_total", len(returned))
        self._publish()
        return len(returned)

    # -- accounting -------------------------------------------------------

    def check(self) -> None:
        """Invariant audit (tests + drills): every block is either
        free or referenced by at least one table; the refcount map
        equals the per-table reference counts exactly (so no
        refcount-0 block lives outside the free list, and no free
        block carries a refcount); index entries only point at live
        blocks; every table is exactly sized for its token count and
        no written timeline overhangs it (the truncate/rewind
        contract — rolled-back draft tokens must be gone from BOTH)."""
        counts = Counter(b for t in self._tables.values() for b in t)
        distinct = set(counts)
        free_set = set(self._free)
        if distinct & free_set \
                or len(distinct) + len(self._free) != self.num_blocks \
                or (distinct | free_set) != set(range(self.num_blocks)):
            raise AssertionError(
                f"block accounting broken: {len(self._free)} free + "
                f"{len(distinct)} owned != {self.num_blocks} "
                f"(or duplicates)")
        if dict(counts) != self._refs:
            raise AssertionError(
                f"refcount accounting broken: per-table references "
                f"{dict(counts)} != refcount map {self._refs}")
        stale = [b for b in self._index_key if b not in self._refs]
        if stale:
            raise AssertionError(
                f"prefix index points at free blocks: {stale}")
        for sid, table in self._tables.items():
            if len(table) != self.blocks_for(self._tokens.get(sid, 0)):
                raise AssertionError(
                    f"seq {sid} table holds {len(table)} blocks but "
                    f"covers {self._tokens.get(sid, 0)} tokens "
                    f"(truncate/extend accounting broken)")
            tl = self._timelines.get(sid)
            if tl is not None and len(tl) > self._tokens.get(sid, 0):
                raise AssertionError(
                    f"seq {sid} written timeline ({len(tl)} tokens) "
                    f"overhangs its table "
                    f"({self._tokens.get(sid, 0)} tokens) — "
                    f"rolled-back tokens still prefix-matchable")

    def _count(self, name: str, n: int = 1) -> None:
        if not obs.enabled():
            return
        help_ = {
            "kv_blocks_alloc_total":
                "KV cache blocks handed to sequences by the paged "
                "allocator",
            "kv_blocks_freed_total":
                "KV cache blocks returned to the paged allocator's "
                "free list",
            "kv_alloc_failures_total":
                "KV block allocations refused because the pool was "
                "exhausted (triggers scheduler preemption)",
            "kv_cow_copies_total":
                "copy-on-write block copies: a sequence's first "
                "divergent write to a shared block allocated a "
                "private copy (kv_prefix_sharing)",
            "kv_prefix_hit_tokens_total":
                "prompt tokens satisfied from already-resident "
                "shared blocks at allocate() time — prefill skips "
                "recomputing them (kv_prefix_sharing)",
        }[name]
        obs.counter(name, help_).inc(n)

    def gauges_agree(self) -> Optional[bool]:
        """Do the kv_blocks_* gauges match this allocator's counts?
        None when unjudgeable (metrics off, or another allocator wrote
        the gauges last); the engine's post-step audit consumes this."""
        if not obs.enabled() or _last_pub_token != self._pub_token:
            return None
        used = obs.gauge("kv_blocks_used").value()
        free = obs.gauge("kv_blocks_free").value()
        shared = obs.gauge("kv_blocks_shared").value()
        if used is None or free is None or shared is None:
            return None
        return int(used) == self.num_used \
            and int(free) == self.num_free \
            and int(shared) == self.num_shared

    def _publish(self) -> None:
        global _last_pub_token
        if not obs.enabled():
            return
        _last_pub_token = self._pub_token
        obs.gauge("kv_blocks_used",
                  "KV cache blocks currently owned by sequences "
                  "(paged allocator)").set(float(self.num_used))
        obs.gauge("kv_blocks_free",
                  "KV cache blocks on the paged allocator's free "
                  "list").set(float(self.num_free))
        obs.gauge("kv_blocks_shared",
                  "KV cache blocks referenced by two or more block "
                  "tables (prefix sharing; read-only until "
                  "copy-on-write)").set(float(self.num_shared))
