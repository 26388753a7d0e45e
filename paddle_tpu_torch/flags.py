"""Global flag registry of the PyTorch package.

A typed, env-overridable registry (``FLAGS_<name>`` in the environment
overrides a default at import), settable with ``set_flags`` and read
with ``get_flags``. It holds only the serving flags the paged-KV LLM
engine reads, with the names and defaults of ``paddle_tpu.flags``.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Union

__all__ = ["GLOBAL_FLAGS", "FlagRegistry", "define_flag", "set_flags",
           "get_flags"]


@dataclass
class _FlagSpec:
    name: str
    default: Any
    type: type
    help: str


class FlagRegistry:
    """Thread-safe typed flag registry with env-var overrides."""

    def __init__(self) -> None:
        self._specs: Dict[str, _FlagSpec] = {}
        self._values: Dict[str, Any] = {}
        self._lock = threading.RLock()

    def define(self, name: str, default: Any, help: str = "") -> None:
        with self._lock:
            if name in self._specs:
                raise ValueError(f"flag '{name}' already defined")
            spec = _FlagSpec(name, default, type(default), help)
            self._specs[name] = spec
            env = os.environ.get("FLAGS_" + name)
            self._values[name] = default if env is None \
                else self._parse(spec, env)

    @staticmethod
    def _parse(spec: _FlagSpec, text: str) -> Any:
        if spec.type is bool:
            return text.strip().lower() in ("1", "true", "yes", "on")
        if spec.type is int:
            return int(text)
        if spec.type is float:
            return float(text)
        return text

    def set(self, name: str, value: Any) -> None:
        with self._lock:
            spec = self._specs.get(name)
            if spec is None:
                raise KeyError(f"unknown flag '{name}'")
            if spec.type is not type(value):
                if spec.type is float and isinstance(value, int):
                    value = float(value)
                elif isinstance(value, str):
                    value = self._parse(spec, value)
                else:
                    raise TypeError(
                        f"flag '{name}' expects {spec.type.__name__}, got "
                        f"{type(value).__name__}")
            self._values[name] = value

    def get(self, name: str) -> Any:
        with self._lock:
            if name not in self._values:
                raise KeyError(f"unknown flag '{name}'")
            return self._values[name]


GLOBAL_FLAGS = FlagRegistry()


def define_flag(name: str, default: Any, help: str = "") -> None:
    GLOBAL_FLAGS.define(name, default, help)


def set_flags(flags: Dict[str, Any]) -> None:
    for k, v in flags.items():
        GLOBAL_FLAGS.set(k, v)


def get_flags(names: Union[str, Iterable[str]]) -> Dict[str, Any]:
    if isinstance(names, str):
        names = [names]
    return {n: GLOBAL_FLAGS.get(n) for n in names}


# ---------------------------------------------------------------------------
# LLM serving (serving_llm)
# ---------------------------------------------------------------------------
define_flag("kv_block_size", 16,
            "Tokens per KV-cache block: the paged allocator's unit and "
            "the paged attention kernel's K/V tile length. Read when an "
            "LLMEngine is constructed.")
define_flag("kv_pool_blocks", 64,
            "Total KV-cache blocks in the per-layer device pools — the "
            "hard capacity of the paged allocator. Read at LLMEngine "
            "construction.")
define_flag("max_decode_batch", 8,
            "Max sequences decoding concurrently; waiting prefills are "
            "admitted only while the running set is below this AND the "
            "pool has blocks for the prompt. Read every scheduler step.")
define_flag("kv_admission_watermark", 0.0,
            "Admission-time KV watermark as a fraction of kv_pool_blocks:"
            " a new sequence whose projected peak block demand plus every"
            " live projection would exceed watermark * pool is rejected "
            "with a retry-after hint. 0 disables the gate.")
define_flag("tenant_fair_share", False,
            "Weighted fair-share admission over per-tenant queue heads "
            "(lowest weight-normalized token-second service first, FCFS "
            "within a tenant). Off: strictly FCFS.")
define_flag("tenant_weights", "",
            "Fair-share weights as 'tenant=weight,...'; unlisted tenants "
            "weigh 1.0, weight 0 runs only when every weighted tenant is "
            "idle.")
define_flag("tenant_kv_budget", "",
            "Per-tenant KV budgets as 'tenant=fraction,...' of "
            "kv_pool_blocks; a tenant at its budget is rejected at "
            "add_request. Unlisted tenants are uncapped.")
define_flag("tenant_label_max", 16,
            "Distinct tenant ids that keep verbatim labels; the rest "
            "share 16 stable crc32 overflow buckets.")
define_flag("kv_prefix_sharing", False,
            "Copy-on-write shared-prefix KV reuse: resident prompt "
            "prefixes are shared by refcount, prefill skips them, and "
            "the first divergent write copies the block in-pool.")
define_flag("prefill_chunk_tokens", 0,
            "Chunked prefill: when > 0, prefill advances this many tokens"
            " (floored to a kv_block_size multiple) per engine step, "
            "interleaved with decode. 0 prefills whole prompts.")
define_flag("llm_stall_factor", 10.0,
            "Engine stall watchdog: a step longer than this factor times "
            "the EWMA step time (floor 0.5 s) counts as a stall. 0 "
            "disables the watchdog.")
define_flag("speculative_k", 0,
            "Speculative decoding: when > 0, a draft model proposes up to"
            " this many tokens per sequence per step and the target "
            "verifies every window in one multi-query paged-attention "
            "forward. 0 disables.")
define_flag("speculative_draft_layers", 1,
            "Layers of the draft model the engine builds itself when "
            "speculative_k > 0 and no draft_model was given.")
define_flag("speculative_draft_tie_embeddings", True,
            "Share the target's token and position embeddings (and so the"
            " tied output head) with the auto-built draft model.")
