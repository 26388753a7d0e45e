"""LLM serving: paged KV cache, continuous batching, token events, and
the streaming wire's engine side and front-door router.

Counterpart of ``paddle_tpu.serving_llm``:

* :mod:`.kv_cache` — ``KVBlockAllocator``: fixed-size token blocks in a
  preallocated pool, per-sequence block tables, refcounted COW sharing.
* :mod:`.scheduler` — ``ContinuousBatchingScheduler``: FCFS (or
  weighted fair-share) admission, class-aware preempt-youngest.
* :mod:`.engine` — ``LLMEngine``: per-layer K/V pools on the device,
  prefill through dense causal attention, decode and speculative verify
  through the hand-written paged attention kernels.
* :mod:`.server` — ``LLMStreamBridge``: engine events to
  ``inference.Server``'s streaming (PTST) reply frames.
* :mod:`.router` — ``Router``: a front door over N backends with
  health-gated rotation, per-backend circuit breakers, deterministic
  mid-stream failover (resumed through the sample offset), retry and
  shed discipline and prefix-affinity placement.
"""

from .kv_cache import KVBlockAllocator
from .scheduler import ContinuousBatchingScheduler, Sequence
from .engine import AdmissionRejected, LLMEngine, health_snapshot
from .server import LLMStreamBridge
from .router import Backend, BackendPool, CircuitBreaker, Router

__all__ = ["KVBlockAllocator", "ContinuousBatchingScheduler", "Sequence",
           "LLMEngine", "LLMStreamBridge", "AdmissionRejected",
           "health_snapshot", "Backend", "BackendPool", "CircuitBreaker", "Router"]
