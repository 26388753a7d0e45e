"""LLM serving: paged KV cache, continuous batching, token events.

Counterpart of ``paddle_tpu.serving_llm`` (the wire server and router
are not ported yet):

* :mod:`.kv_cache` — ``KVBlockAllocator``: fixed-size token blocks in a
  preallocated pool, per-sequence block tables, refcounted COW sharing.
* :mod:`.scheduler` — ``ContinuousBatchingScheduler``: FCFS (or
  weighted fair-share) admission, class-aware preempt-youngest.
* :mod:`.engine` — ``LLMEngine``: per-layer K/V pools on the device,
  prefill through dense causal attention, decode and speculative verify
  through the hand-written paged attention kernels.
"""

from .kv_cache import KVBlockAllocator
from .scheduler import ContinuousBatchingScheduler, Sequence
from .engine import AdmissionRejected, LLMEngine

__all__ = ["KVBlockAllocator", "ContinuousBatchingScheduler", "Sequence",
           "LLMEngine", "AdmissionRejected"]
