"""Global flag registry of the PyTorch package.

A typed, env-overridable registry (``FLAGS_<name>`` in the environment
overrides a default at import), settable with ``set_flags`` and read
with ``get_flags``. It holds the flags the ported paths read (the
paged-KV LLM engine's, the serving wire's and the router's, the
attention routing and train-step flags of BERT pretraining, and those
of the checkpoints and the input pipeline, of observability and fault
injection, and of the core: devices, the staging arena, the transformer
layers), with the names and defaults of ``paddle_tpu.flags``: every
JAX flag but four whose readers are not ported yet (``check_nan_inf``,
``matmul_precision``, ``compile_cache_dir``, ``straggler_factor``). The JAX package's TPU-routing switches
(``use_pallas_kernels``, ``use_pallas_layer_norm``, ``flash_block_q``/
``_k``, ``use_fast_rng``) are accepted and read by nothing: the port
routes by the tensor's device and takes no fallback flag.
A flag may carry an ``on_change`` hook, called with the new value by
``set_flags`` (not by an environment override at import, as in the JAX
registry).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional, Union

__all__ = ["GLOBAL_FLAGS", "FlagRegistry", "define_flag", "set_flags",
           "get_flags"]


@dataclass
class _FlagSpec:
    name: str
    default: Any
    type: type
    help: str
    on_change: Optional[Callable[[Any], None]] = None


class FlagRegistry:
    """Thread-safe typed flag registry with env-var overrides."""

    def __init__(self) -> None:
        self._specs: Dict[str, _FlagSpec] = {}
        self._values: Dict[str, Any] = {}
        self._lock = threading.RLock()

    def define(self, name: str, default: Any, help: str = "",
               on_change: Optional[Callable[[Any], None]] = None) -> None:
        with self._lock:
            if name in self._specs:
                raise ValueError(f"flag '{name}' already defined")
            spec = _FlagSpec(name, default, type(default), help, on_change)
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
            if spec.on_change is not None:
                spec.on_change(value)

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


def define_flag(name: str, default: Any, help: str = "",
                on_change: Optional[Callable[[Any], None]] = None) -> None:
    GLOBAL_FLAGS.define(name, default, help, on_change)


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
# the serving wire (inference.Server, serving_llm.router)
# ---------------------------------------------------------------------------
define_flag("serving_queue_deadline_ms", 0,
            "Inference server load shedding: a queued request older "
            "than this many milliseconds when the batcher picks it up "
            "is answered with an error instead of being served "
            "(counted in requests_shed_total and the native "
            "serving.shed_total stat). 0 (default) disables shedding. "
            "Age is measured from when the server first dequeues the "
            "request off the native transport.")
define_flag("serving_drain_deadline_s", 5.0,
            "Graceful drain budget for inference.Server. When a "
            "drain starts (SIGTERM under Server.serve_forever, or "
            "Server.drain()), new requests are refused immediately "
            "(tensor requests error-replied, streams shed with a "
            "terminal frame) and in-flight generations may keep "
            "decoding for up to this many seconds; sequences still "
            "running at the deadline are cancelled with a terminal "
            "negative-status frame so no client is left hanging.")
define_flag("router_failover_budget", 2,
            "Front-door router (serving_llm/router.py): maximum "
            "mid-stream failovers per client stream. A stream that "
            "already delivered tokens is resumed on a surviving "
            "backend (prompt+delivered re-issued with the sample "
            "offset, bitwise-exact continuation) at most this many "
            "times before the router gives up with a terminal error "
            "that names the delivered count. Read per failover "
            "decision.")
define_flag("router_retry_budget", 2,
            "Front-door router: maximum re-sends of an UNSTARTED "
            "(zero tokens delivered) stream or idempotent tensor "
            "request to another backend after a connect/deadline "
            "failure. Started streams never consume this — they fail "
            "over instead (never blind-resent). Read per retry "
            "decision.")
define_flag("router_retry_backoff_s", 0.05,
            "Front-door router: base of the jittered exponential "
            "backoff slept before each unstarted-request retry "
            "(actual sleep is base * 2^(attempt-1) * uniform[0.5,1) "
            "— full-jitter, so N clients retrying a blip don't "
            "stampede the survivor). 0 disables the sleep (tests). "
            "Read per retry.")
define_flag("router_breaker_threshold", 3,
            "Front-door router: consecutive connect/deadline "
            "failures (data path or probe) that trip a backend's "
            "circuit breaker closed -> open. Drain refusals and "
            "admission rejections are NOT failures — they park the "
            "backend as draining/saturated without touching the "
            "breaker. Read lazily per breaker decision.")
define_flag("router_breaker_backoff_s", 0.5,
            "Front-door router: open-state backoff of a freshly "
            "tripped circuit breaker — how long the backend is left "
            "alone before the single half-open probe. Doubles on "
            "every re-open (failed probe) up to "
            "FLAGS_router_breaker_backoff_max_s; any success resets "
            "it. Read lazily per breaker decision.")
define_flag("router_breaker_backoff_max_s", 30.0,
            "Front-door router: cap on the doubling open-state "
            "breaker backoff, bounding how stale a recovered "
            "backend's exile can get. Read lazily per breaker "
            "decision.")
define_flag("router_probe_interval_s", 1.0,
            "Front-door router: period of the backend health-probe "
            "thread (PTSC STATS round trip reading serving.draining, "
            "plus an optional exporter GET /healthz). Probe failures "
            "feed the breaker; a tripped breaker's backend is probed "
            "again only after its backoff (the half-open single "
            "probe). Read per probe cycle.")
define_flag("router_backend_deadline_s", 30.0,
            "Front-door router: per-chunk deadline on router->backend "
            "streams and total deadline on proxied tensor requests. A "
            "backend silent past this is treated as dead: breaker "
            "failure plus retry (unstarted) or deterministic failover "
            "(started). Read per backend attempt.")
define_flag("router_prefix_affinity", False,
            "Front-door router: prefix-affinity pick(). On, the "
            "router hashes each prompt's leading FULL KV blocks "
            "(FLAGS_kv_block_size tokens each) and routes to the "
            "backend that most recently served the longest matching "
            "prefix (LRU placement memory, longest match wins), so "
            "shared-prefix traffic lands where its blocks are "
            "already hot and FLAGS_kv_prefix_sharing hits multiply "
            "fleet-wide (kv_prefix_hit_tokens_total). No affinity "
            "match falls back to least-loaded by live stream count "
            "(round-robin order breaking ties). Off (default) keeps "
            "pure round-robin. Read per stream dispatch.")

# ---------------------------------------------------------------------------
# runtime, devices and the host pipeline (core.place, core.arena)
# ---------------------------------------------------------------------------


def _deterministic_changed(value) -> None:
    import torch
    torch.backends.cudnn.deterministic = bool(value)


define_flag("deterministic", False,
            "Ask for deterministic kernel choices (ref: "
            "FLAGS_cudnn_deterministic): sets "
            "torch.backends.cudnn.deterministic, so cuDNN's convolutions "
            "(the ResNet path) take algorithms without atomics and a "
            "step repeats bit for bit; set_flags applies it at once, a "
            "FLAGS_deterministic environment value at import. The "
            "port's own kernels are bitwise run to run whatever its "
            "value.", on_change=_deterministic_changed)
if os.environ.get("FLAGS_deterministic") is not None:
    # ptlint: disable=flag-freeze -- applies the environment's value to torch once at import, as set_flags applies a later one
    _deterministic_changed(GLOBAL_FLAGS.get("deterministic"))
define_flag("eager_delete_tensor_gb", 0.0,
            "Retained-buffer budget of the host staging arena "
            "(core.arena.HostStagingArena), in GiB: the free list keeps "
            "at least `depth` blocks and releases the rest once it holds "
            "more than this many bytes (ref: FLAGS_eager_delete_tensor_gb)."
            " Read at each advance().")
define_flag("use_pallas_kernels", True,
            "The JAX package's master switch for its TPU kernels, "
            "accepted for parity and read by nothing: the port routes by "
            "the tensor's device (CUDA kernels for CUDA tensors, their "
            "plain versions for CPU ones) and no router takes a flag "
            "that would fall back from a kernel.")
define_flag("use_pallas_layer_norm", True,
            "The JAX package's switch for its TPU LayerNorm kernel, "
            "accepted for parity and read by nothing: LayerNorm on a "
            "CUDA tensor always runs the CUDA kernel "
            "(kernels.maybe_layer_norm).")
define_flag("log_level", 0, "Framework VLOG level (0 = off).")
define_flag("selected_devices", "",
            "Comma-separated CUDA ordinals the process uses (ref: "
            "FLAGS_selected_gpus): core.place.device_count() and "
            "local_devices() count only these, and set_device('gpu:i') "
            "takes the i-th of them. Empty = every visible card.")
define_flag("io_threadpool_size", 4,
            "Worker threads for the host data pipeline "
            "(ref: FLAGS_io_threadpool_size). Defined as in the JAX "
            "package, which has no reader either.")
define_flag("fuse_parameter_groups_size", 32 * 1024 * 1024,
            "Gradient coalescing bucket size in bytes for data-parallel "
            "fusion (ref: FLAGS_fuse_parameter_groups_size). Defined as "
            "in the JAX package, which has no reader either.")
define_flag("use_fast_rng", True,
            "The JAX package's switch to the TPU's hardware PRNG, "
            "accepted for parity and read by nothing: the port's "
            "generators are Philox, counter-based already "
            "(core.random.fast_rng_enabled documents it).")

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
define_flag("attention_bthd_layout", True,
            "MultiHeadAttention hands q/k/v to attention in their native "
            "[B, T, H, D] projection layout. Off: the [B, H, T, D] "
            "layout, which the flash kernels read through strides (no "
            "copy); the same kernels and launches, equal results. Read "
            "per forward.")
define_flag("flash_block_q", 0,
            "The JAX package's flash query-tile sweep lever, accepted "
            "for parity and read by nothing: the port's flash kernels "
            "are compiled per head dim with fixed tiles "
            "(kernels.flash_attention).")
define_flag("flash_block_k", 0,
            "The JAX package's flash key-tile sweep lever, accepted for "
            "parity and read by nothing (see flash_block_q).")
define_flag("transformer_remat", False,
            "Rematerialise each TransformerEncoder layer in the backward "
            "(torch.utils.checkpoint per layer, training only): the "
            "backward recomputes the layer's activations instead of "
            "keeping them. The layer's random draws (dropout masks, the "
            "flash kernels' seeds) are recorded in the forward and "
            "replayed by the recompute (core.random.replay_draws), so a "
            "step equals its run without remat bit for bit. Read per "
            "forward.")
define_flag("resnet_block_remat", False,
            "Rematerialise each ResNet residual block in the backward "
            "(torch.utils.checkpoint per block, training only): the "
            "backward recomputes the block's activations instead of "
            "keeping them. The recompute writes no BatchNorm running "
            "statistics, so they move once a step and a step equals its "
            "run without remat bit for bit (cuDNN deterministic). Read "
            "per forward.")
define_flag("resnet_space_to_depth_stem", False,
            "Compute the ResNet 7x7/stride-2 stem conv as the exact "
            "4x4/stride-1 conv over the 2x2 space-to-depth fold of the "
            "input (12 channels), the weight rearranged at call time "
            "(parameters and checkpoints unchanged). NHWC input with even "
            "height and width only; other inputs take the plain stem. "
            "Read per forward; a model's s2d_stem attribute overrides it.")
define_flag("batch_norm_single_pass", True,
            "Training-mode BatchNorm statistics as E[x^2] - E[x]^2, both "
            "accumulated in fp32 (no fp32 copy of the input is made), "
            "clamped at 0 and cast back to the input's dtype (the two "
            "reductions read one operand), instead of the mean followed "
            "by the biased variance. Read per forward.")
define_flag("skip_nonfinite_steps", True,
            "TrainStep discards the whole update (parameters, optimizer "
            "moments, the step counter and the buffers the forward "
            "updated, such as BatchNorm's statistics) when any gradient "
            "is NaN/Inf, "
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


# ---------------------------------------------------------------------------
# observability and fault injection (observability/, testing/faults.py)
# ---------------------------------------------------------------------------
def _enable_metrics_changed(value) -> None:
    # keeps the metrics module's cached fast-path bool in sync (a lazy
    # import: observability imports this module)
    from .observability import metrics as _obs_metrics
    _obs_metrics.set_enabled(bool(value))


define_flag("enable_metrics", False,
            "Master switch for the observability subsystem: metrics "
            "registry writes, host span tracing, flight-recorder events "
            "and the serving/training probes. Off = one cached boolean "
            "test on every instrumented hot path (capture counts stay "
            "on: they cost nothing per step).",
            on_change=_enable_metrics_changed)
define_flag("anomaly_spike_factor", 10.0,
            "Anomaly sentinel spike threshold: a watched series (loss, "
            "grad norm) whose value exceeds this factor times its "
            "running EWMA (after a short warmup) is counted in "
            "anomalies_total and logged to events.jsonl under "
            "FLAGS_trace_dir. NaN/Inf are always flagged. 0 disables "
            "spike detection (NaN/Inf detection stays on).")
define_flag("divergence_streak", 5,
            "Consecutive anomalous loss samples (NaN/Inf or EWMA spike "
            "per FLAGS_anomaly_spike_factor) before the divergence "
            "watchdog (observability.anomaly.DivergenceWatchdog) trips. "
            "A clean sample resets the streak.")


def _request_ring_changed(value) -> None:
    from .observability import reqtrace as _obs_reqtrace
    _obs_reqtrace.ring().resize(int(value))


define_flag("serving_request_ring", 256,
            "Capacity of the per-request span ring "
            "(observability/reqtrace.py): the last N request trace "
            "records — trace id, the lifecycle timestamps and the "
            "derived serving_*_ms spans.",
            on_change=_request_ring_changed)


def _flight_buffer_changed(value) -> None:
    from .observability import flight as _obs_flight
    _obs_flight.recorder().resize(int(value))


define_flag("flight_buffer_events", 512,
            "Capacity of the crash flight recorder's in-process ring "
            "buffer (observability/flight.py): the last N structured "
            "events (step markers, captures, anomalies, faults) kept "
            "and dumped to flight_<ts>.jsonl under FLAGS_trace_dir on "
            "SIGTERM/uncaught exception/exit.",
            on_change=_flight_buffer_changed)
define_flag("trace_dir", "",
            "If set, observability.export_all() writes the host "
            "chrome-trace (host_trace.json) and the metrics snapshot "
            "(metrics.json, metrics.prom) under this directory; the "
            "anomaly sentinel's events.jsonl and the flight recorder's "
            "dumps land there too.")


def _llm_seqtrace_ring_changed(value) -> None:
    from .observability import seqtrace as _obs_seqtrace
    _obs_seqtrace.ring().resize(int(value))


define_flag("llm_seqtrace_ring", 256,
            "Capacity of the finished per-sequence lifecycle-timeline "
            "ring (observability/seqtrace.py): the last N terminal "
            "sequence timelines — queued/admitted/prefill_chunk/"
            "cow_copy/preempted/spec_window/token events, each "
            "monotonic-stamped, plus the wire trace id. Timelines "
            "ending in error/cancelled/shed are also dumped to the "
            "flight recorder.",
            on_change=_llm_seqtrace_ring_changed)


def _llm_step_ring_changed(value) -> None:
    from .observability import stepprof as _obs_stepprof
    _obs_stepprof.ring().resize(int(value))


define_flag("llm_step_ring", 256,
            "Capacity of the LLM engine step-record ring "
            "(observability/stepprof.py): the last N step profiles — "
            "per-phase durations (admit/prefill/decode/spec_verify plus "
            "sample/scatter sub-segments), batch composition, KV-pool "
            "snapshot, prefix-hit and speculative-accept deltas, stall "
            "verdict — and the live in-flight step.",
            on_change=_llm_step_ring_changed)


def _fault_spec_changed(value) -> None:
    # (re)arms the chaos-injection registry (a lazy import:
    # testing.faults imports this module)
    from .testing import faults as _faults
    _faults.configure(value or None)


define_flag("fault_spec", "",
            "Deterministic chaos-injection spec "
            "(paddle_tpu_torch.testing.faults). Comma-separated entries "
            "'point[:key=value]...', e.g. "
            "'ckpt_write:p=1:at=2,sigterm:step=7,llm_decode:at=3'. "
            "Empty (default) disarms every point — the hit() hook is a "
            "near-free early return.",
            on_change=_fault_spec_changed)
define_flag("rollback_budget", 2,
            "Divergence-watchdog rollback budget for one "
            "hapi.Model.fit(ckpt_dir=...) run: when the watchdog trips "
            "(a NaN/spike streak on the loss, FLAGS_divergence_streak),"
            " fit restores the newest intact checkpoint and replays — "
            "at most this many times; the next trip after the budget "
            "is exhausted raises. 0 disables rollback (the watchdog "
            "still counts anomalies). Rollback needs "
            "FLAGS_enable_metrics (the loss probes feed the watchdog).")
define_flag("rollback_lr_factor", 1.0,
            "Learning-rate multiplier applied on divergence-rollback "
            "re-entry (e.g. 0.5 halves the LR after each rollback): "
            "TrainStep.lr_scale, which reaches the step through its "
            "host_lr tensor, so a rescale reuses the captured graph. "
            "1.0 leaves the LR untouched.")
define_flag("recompile_warn_threshold", 8,
            "Warn (once per function) when one step has been captured "
            "for at least this many distinct input signatures — a "
            "capture storm usually means unpadded/unbucketed input "
            "shapes. 0 disables the warning.")


# ---------------------------------------------------------------------------
# the live observability plane (observability/server.py and what it reads)
# ---------------------------------------------------------------------------
define_flag("metrics_port", 0,
            "TCP port for the live observability HTTP exporter "
            "(observability/server.py). 0 (default) = bind an "
            "EPHEMERAL port — the chosen port is published via the "
            "observability_server_port gauge and one log line, so "
            "parallel runs never collide; a negative value disables "
            "the exporter. When FLAGS_enable_metrics is on, "
            "inference.Server starts (idempotently shares) a "
            "daemon-threaded stdlib HTTP server exposing /metrics "
            "(Prometheus text), /healthz (device liveness + train "
            "heartbeat), /varz (full JSON snapshot incl. program "
            "cards), /trace?ms=N (on-demand chrome-trace window), "
            "/goodput (wall-time ledger) and /flight (event ring "
            "buffer).")
define_flag("program_analytics", True,
            "Build a program card per captured step signature "
            "(observability/xprof.py) while FLAGS_enable_metrics is on: "
            "the FLOPs of the eager warm-up step that precedes each "
            "capture (torch.utils.flop_counter plus the hand-written "
            "kernels' own counts) and the peak allocated bytes around "
            "the warm-up and the capture. A capture-time-only cost, "
            "nothing per replay. Off skips the cards entirely.")
define_flag("fleet_push_interval_s", 2.0,
            "Seconds between fleet-federation snapshot pushes from a "
            "worker's FleetReporter to the rank-0 aggregator "
            "(observability/fleet.py). The reporter starts when the "
            "observability exporter comes up and PT_FLEET_AGGREGATOR "
            "is set; a push is one stdlib HTTP POST and a failed push "
            "is counted (fleet_push_failures_total), never raised.")
define_flag("fleet_stale_after_s", 15.0,
            "The /fleet/health endpoint marks a host stale (and "
            "answers HTTP 503) when its last snapshot push is older "
            "than this many seconds — a SIGKILLed worker flips the "
            "fleet unhealthy while its last snapshot keeps serving in "
            "the merged /fleet view. 0 disables staleness (hosts are "
            "then only unhealthy if they pushed health.ok=false).")


def _tsdb_ring_changed(value) -> None:
    from .observability import tsdb as _obs_tsdb
    _obs_tsdb.ring().resize(int(value))


define_flag("tsdb_ring", 512,
            "Per-series capacity of the in-process time-series ring "
            "(observability/tsdb.py): each watched metric keeps the "
            "last N sampler snapshots (monotonic-stamped) so windowed "
            "rate()/increase()/quantile_over_window() — and therefore "
            "SLO burn-rate evaluation — are answerable locally. "
            "Rotation-style eviction, oldest out first; memory bound "
            "is watched-series count times this.",
            on_change=_tsdb_ring_changed)
define_flag("tsdb_interval_s", 1.0,
            "Seconds between tsdb sampler ticks (observability/"
            "tsdb.py): each tick snapshots every watched metric from "
            "the registry into its ring and re-evaluates the SLO "
            "alert state machines (observability/slo.py). The sampler "
            "thread starts with the observability exporter; the "
            "interval is re-read every tick so live set_flags() "
            "changes apply.")
define_flag("slo_window_scale", 1.0,
            "Multiplier on every SLO burn-rate window "
            "(observability/slo.py): the fast 5m/1h and slow 30m/6h "
            "pairs all scale by this, so tests and chaos drills can "
            "run the production alert arithmetic in seconds (e.g. "
            "0.01 makes the fast pair 3s/36s). 1.0 in production.")
define_flag("health_heartbeat_timeout_s", 300.0,
            "The /healthz endpoint reports unhealthy (HTTP 503) when a "
            "training heartbeat exists but is older than this many "
            "seconds — a wedged training loop reads unhealthy while the "
            "process is still up. 0 disables the staleness check.")


def _stack_sample_hz_changed(value) -> None:
    from .observability import stacks as _obs_stacks
    _obs_stacks.sampler().apply_rate(value)


define_flag("stack_sample_hz", 0.0,
            "Ticks per second of the continuous stack-sampling "
            "profiler (observability/stacks.py): each tick folds "
            "every Python thread's stack into a bounded profile "
            "(collapsed-text + Chrome flame export at /stacks). "
            "0 (the default) disables sampling; the rate is re-read "
            "every tick so live set_flags() changes apply. Measured "
            "self-overhead is exported as "
            "stack_sampler_overhead_ratio.",
            on_change=_stack_sample_hz_changed)
define_flag("stack_profile_max", 512,
            "Cap on distinct folded stacks the sampling profiler "
            "keeps (observability/stacks.py): new stacks past the "
            "cap aggregate into a per-thread [overflow] bucket and "
            "count stack_profile_dropped_total, so a deep-recursion "
            "workload cannot grow the profile unboundedly.")
define_flag("hang_check_interval_s", 1.0,
            "Seconds between hang-monitor ticks (observability/"
            "stacks.py): the monitor watches for a *live* wedge — a "
            "serving engine whose current step is stalled (engine "
            "step stamps) or a training heartbeat past "
            "FLAGS_health_heartbeat_timeout_s — and captures + "
            "classifies all thread stacks while the hang is in "
            "progress, recording a hang_diagnosis flight event "
            "naming the culprit frame. <= 0 disables the monitor.")

# the profiler compat shim's (profiler.py)
define_flag("profile_dir", "",
            "If set, profiler.start_profiler() writes its "
            "torch.profiler chrome traces under this directory.")
define_flag("benchmark", False,
            "Block on each step for accurate timing "
            "(profiler.StepTimer synchronises the card before it "
            "stops).")
