"""Global flag registry of the PyTorch package.

A typed, env-overridable registry (``FLAGS_<name>`` in the environment
overrides a default at import), settable with ``set_flags`` and read
with ``get_flags``. It holds the flags the ported paths read (the
paged-KV LLM engine's, the attention routing and train-step flags of
BERT pretraining, and those of the checkpoints and the input pipeline),
with the names and defaults of ``paddle_tpu.flags``.
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

    def snapshot(self) -> tuple:
        """Every flag's value, as sorted (name, value) pairs (hashable)."""
        with self._lock:
            return tuple(sorted(self._values.items()))


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

# ---------------------------------------------------------------------------
# attention routing and training (BERT pretraining)
# ---------------------------------------------------------------------------
define_flag("fused_qkv_projection", False,
            "Compute self-attention q/k/v as one [d, 3d] matmul over the "
            "concatenated q/k/v weights (parameters unchanged).")
define_flag("flash_attention_min_seq", 8192,
            "Key-sequence length at or above which EVAL attention routes "
            "to the flash-attention kernels (kernels.maybe_flash_attention)."
            " Head dims that are not a multiple of 128 keep a fixed 8192 "
            "eval floor this flag does not move.")
define_flag("flash_attention_min_seq_train", 512,
            "Training-mode flash gate (0 = use flash_attention_min_seq). "
            "Also picks the backward route a run exercises: sequences that "
            "fit the fused backward kernel's tile take it, longer ones the "
            "dq and dkv kernels.")
define_flag("skip_nonfinite_steps", True,
            "TrainStep discards the whole update (parameters, optimizer "
            "moments and the step counter) when any gradient is NaN/Inf, "
            "selected on the device without a host sync. Read at "
            "TrainStep construction.")

# ---------------------------------------------------------------------------
# fused loss region and optimizer kernels (BERT pretraining)
# ---------------------------------------------------------------------------
define_flag("use_pallas_adam", False,
            "Route Adam/AdamW updates of fp32 parameters with at least "
            "1024 elements through the flat variant of the CUDA Adam "
            "kernel (csrc/fused_adam.cu: the update in its reciprocal "
            "form m * (1 / (sqrt(v) + eps))), all such leaves of a step in "
            "one multi-tensor launch; smaller leaves keep the unfused "
            "update. The JAX package's name, kept for parity. "
            "fused_adam takes precedence.")
define_flag("fused_adam", False,
            "Route Adam/AdamW updates of fp32 parameters through the "
            "leaf variant of the CUDA Adam kernel (csrc/fused_adam.cu): "
            "every leaf of a step in one multi-tensor launch, bitwise "
            "equal to the unfused update, AdamW's decoupled decay and the "
            "skip-step guard folded in (lr and the guard are read on the "
            "device, so no host sync).")
define_flag("fused_softmax_xent", False,
            "Fuse BERT's masked-LM head (the hidden -> vocab projection) "
            "with its softmax cross-entropy: BertPretrainingHeads returns "
            "MLMHeadOutput and pretraining_loss runs "
            "kernels.maybe_fused_linear_xent, whose CUDA kernels "
            "(csrc/fused_softmax_xent.cu) stream the vocabulary, so the "
            "[N, V] logits and their gradient never exist in device "
            "memory.")

# ---------------------------------------------------------------------------
# optimizer state (mixed-precision training)
# ---------------------------------------------------------------------------
define_flag("optimizer_fused_state", False,
            "Pack the optimizer state (m, v and the fp32 master of every "
            "floating parameter) into flat fp32 vectors: one elementwise "
            "update over 3 buffers instead of 3 buffers PER parameter "
            "(~600 for BERT-base), each parameter then rewritten from "
            "its slice of the flat master. An optimizer's fused_state= "
            "argument overrides it. The JAX package measured it as a "
            "regression on its TPU (the pack/unpack copies cost more "
            "than the per-buffer dispatch they save); on the port's "
            "fused_adam route it is one kernel launch over the flat "
            "master. Per-parameter regularizers and "
            "apply_decay_param_fun need per-parameter updates and raise "
            "under it. Read at optimizer init.")
define_flag("optimizer_moment_dtype", "float32",
            "Storage dtype for Adam-family first/second moments "
            "(float32 | bfloat16; anything else raises at optimizer "
            "init). bfloat16 halves the optimizer state's memory "
            "traffic; the update math still runs in fp32 and the fp32 "
            "master weights are unaffected, so the only loss is ~0.4% "
            "relative rounding on stored m/v. bf16 moments take the "
            "unfused update (the Adam kernel is fp32-only). Read at "
            "optimizer init.")

# ---------------------------------------------------------------------------
# checkpoints and the input pipeline (io, data, core.arena)
# ---------------------------------------------------------------------------
define_flag("checkpoint_verify", True,
            "Verify checkpoint integrity on load: require the COMMIT "
            "marker and check each leaf's recorded CRC32 before "
            "deserializing (io.load / AsyncCheckpointer.restore). Off "
            "skips the CRC pass (size and existence checks stay on — "
            "they are free). Corrupt or uncommitted checkpoints are "
            "skipped by restore with a fallback to the newest intact "
            "one.")
define_flag("allocator_strategy", "xla",
            "Host staging allocator strategy (xla | arena), under the "
            "JAX package's name and default (ref: allocator_strategy "
            "flags.cc, auto_growth_best_fit_allocator.cc). The port reads "
            "neither value: its DeviceLoader always stages a card feed "
            "through core.arena.HostStagingArena (recycled page-aligned "
            "pinned blocks, zero steady-state mallocs), as a copy from "
            "pageable memory is not asynchronous on the card.")
