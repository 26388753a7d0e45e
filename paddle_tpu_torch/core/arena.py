"""Host staging arena: a ring of recycled pinned host blocks for the
host-to-device copies of a feed.

Counterpart of ``paddle_tpu.core.arena``. ``stage()`` copies a batch's
CPU tensors (and numpy arrays) into views of page-aligned blocks, which
are pinned on the card, so the copy to the card is a true asynchronous
DMA (``non_blocking``) and steady-state feeding allocates no host memory.
The caller ``advance()``s once per batch with an event recorded after
the copies that read that batch's views.

Recycling is event-driven, not counted: a non-blocking copy returns
before its DMA ends, so a block goes back to the free list only once
the event of its generation has completed. At most ``depth``
generations wait on their events; staging one more waits for the
oldest. A tensor larger than a block gets a buffer of its own, held
until its event completes and then released. The free list holds no
more blocks than the feed's peak working set. ``stats`` counts what the
arena did.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, List, Tuple

import numpy as np
import torch

__all__ = ["HostStagingArena"]

_ALIGN = 4096  # page alignment for DMA-friendly staging


class _Block:
    __slots__ = ("buf", "offset")

    def __init__(self, nbytes: int, pin: bool) -> None:
        # over-allocate to guarantee a page-aligned window
        raw = torch.empty(nbytes + _ALIGN, dtype=torch.uint8,
                          pin_memory=pin)
        shift = (-raw.data_ptr()) % _ALIGN
        self.buf = raw[shift:shift + nbytes]
        self.offset = 0


class HostStagingArena:
    """``pin`` (default on): page-locked blocks, which need the card; off
    for a host-only arena (its recycling rules are the same)."""

    def __init__(self, block_bytes: int = 64 << 20, depth: int = 3,
                 pin: bool = True) -> None:
        self.block_bytes = int(block_bytes)
        self.depth = max(2, int(depth))
        self.pin = pin
        self._current: List[_Block] = []     # the generation being staged
        self._current_own: List[torch.Tensor] = []  # its oversize buffers
        # retired generations: (blocks, oversize buffers, event)
        self._retired: Deque[Tuple[List[_Block], List[torch.Tensor],
                                   Any]] = deque()
        self._free: List[_Block] = []
        self.stats: Dict[str, int] = {
            "blocks_allocated": 0, "blocks_reused": 0, "bytes_staged": 0,
            "oversize_passthrough": 0, "event_waits": 0}

    def _alloc_view(self, nbytes: int) -> torch.Tensor:
        if nbytes > self.block_bytes:
            # a huge single tensor bypasses the blocks
            self.stats["oversize_passthrough"] += 1
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.pin)
            self._current_own.append(buf)
            return buf
        aligned = -(-nbytes // _ALIGN) * _ALIGN
        for blk in self._current:
            if blk.offset + aligned <= blk.buf.numel():
                view = blk.buf[blk.offset:blk.offset + nbytes]
                blk.offset += aligned
                return view
        self._reclaim(wait=False)
        if self._free:
            blk = self._free.pop()
            blk.offset = 0
            self.stats["blocks_reused"] += 1
        else:
            blk = _Block(self.block_bytes, self.pin)
            self.stats["blocks_allocated"] += 1
        self._current.append(blk)
        view = blk.buf[:nbytes]
        blk.offset = aligned
        return view

    def stage(self, tree: Any) -> Any:
        """``tree`` with every CPU tensor and numpy array copied into an
        arena view (a CPU tensor of the same shape, dtype and values,
        contiguous)."""

        def put(x):
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(np.ascontiguousarray(x))
            if isinstance(x, torch.Tensor) and x.device.type == "cpu":
                nbytes = x.numel() * x.element_size()
                out = self._alloc_view(nbytes).view(x.dtype).view(x.shape)
                out.copy_(x)
                self.stats["bytes_staged"] += nbytes
                return out
            if isinstance(x, dict):
                return {k: put(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(put(v) for v in x)
            return x

        return put(tree)

    def advance(self, event: Any = None) -> None:
        """End of a batch: ``event`` (recorded after the copies that read
        this generation's views; anything with ``query()`` and
        ``synchronize()``, or None when nothing reads them any more)
        decides when its blocks return to the free list."""
        self._retired.append((self._current, self._current_own, event))
        self._current, self._current_own = [], []
        self._reclaim(wait=len(self._retired) > self.depth)

    def _reclaim(self, wait: bool) -> None:
        """Frees the retired generations whose event completed, oldest
        first; with ``wait``, waits for the oldest one's event."""
        while self._retired:
            blocks, _, event = self._retired[0]
            if event is not None and not event.query():
                if not wait:
                    return
                self.stats["event_waits"] += 1
                event.synchronize()
            wait = False
            self._retired.popleft()
            # the blocks are recycled; the oversize buffers are released
            self._free.extend(blocks)
