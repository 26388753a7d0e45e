"""Hang doctor: thread-stack forensics for wedged processes.

Counterpart of ``paddle_tpu.observability.stacks``: the same capture,
classification taxonomy, sampler, exports, doctor, monitor, thread
names and flight records. The JAX ``blocked_in_collective`` state's
``block_until_ready`` has its port counterpart in a host blocked on the
card: ``torch.cuda.synchronize``, ``Event.synchronize`` or
``Stream.synchronize`` (a frame named ``synchronize``), which gets the
same state name.

The flight recorder (flight.py), serving flight deck (seqtrace/
stepprof) and SLO engine (slo.py) say *that* a process stalled and
*which phase* it stalled in; this module answers the remaining
question — **what every host Python thread was executing** when it
happened — without gdb, without a rerun, with zero new dependencies:

- :func:`capture` — an instant all-thread dump from
  ``sys._current_frames()``: thread name, daemon flag, top-N frames,
  how long the sampler has seen the same top frame, and a wedge
  classification per thread. Served at ``GET /stacks`` on the
  observability exporter, recorded into the flight ring on fatal
  signals and on SIGUSR2 (``install_signal_dump``).
- :class:`StackSampler` — a continuous low-overhead sampling profiler
  (daemon thread, ``FLAGS_stack_sample_hz``, default off) folding
  stacks into a bounded profile (``FLAGS_stack_profile_max`` keys,
  overflow aggregated + counted). Exports collapsed text
  (``/stacks?format=collapsed``, flamegraph.pl-compatible) and a
  Chrome ``traceEvents`` flame view (``/stacks?format=flame``, the
  tracer.py export shape so Perfetto/trace_agg load it). Its own cost
  is measured every tick and published as the
  ``stack_sampler_overhead_ratio`` gauge.
- :class:`HangDoctor` / :class:`HangMonitor` — when the serving stall
  watchdog (serving_llm/engine.py), the training-heartbeat staleness
  check, or the monitor's own live poll detects a wedge, the doctor
  captures stacks *during* the hang, classifies the wedged thread
  (``blocked_on_lock`` via ``# guarded-by:`` symbol match,
  ``blocked_in_collective``, ``blocked_in_io``), and records a
  ``hang_diagnosis`` flight event naming the culprit frame.

Classification taxonomy (docs/observability.md, "Hang doctor"):

``blocked_on_lock``       innermost frame inside threading.py's
                          acquire/wait family; the first application
                          frame's source line names the lock symbol,
                          matched against ``# guarded-by:`` field
                          annotations in that file.
``blocked_in_collective`` a frame inside the distributed/collective
                          plane or a host wait on the card
                          (``torch.cuda.synchronize``,
                          ``Event``/``Stream.synchronize``; JAX's
                          ``block_until_ready`` too).
``blocked_in_io``         the innermost source line is a sleep /
                          socket / select / subprocess wait.
``running``               none of the above — the thread is on-CPU or
                          indistinguishable from it.

Clock discipline: every age/duration here is monotonic-sourced
(``time.monotonic``/``perf_counter``); wall stamps appear only as
display fields on exported records.
"""

from __future__ import annotations

import linecache
import os
import re
import signal
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..flags import GLOBAL_FLAGS
from . import flight as _flight
from . import metrics as _metrics

__all__ = ["capture", "dump_to_flight", "install_signal_dump",
           "StackSampler", "sampler", "HangDoctor", "doctor",
           "HangMonitor", "monitor", "maybe_start", "reset",
           "collapsed_text", "flame_trace", "stacks_view"]

DEFAULT_TOP_N = 32

# thread names that are expected to sit in a wait forever — never the
# hang culprit (the exporter's accept loop, push/sample loops, us)
_INFRA_THREADS = ("pt-observability-http", "pt-fleet-reporter",
                  "pt-tsdb-sampler", "pt-stack-sampler",
                  "pt-hang-monitor")

_LOCK_FUNCS = {"acquire", "wait", "wait_for", "join",
               "_wait_for_tstate_lock"}
# a host blocked on the card (torch.cuda.synchronize, Event/Stream
# .synchronize) is the port's block_until_ready
_COLLECTIVE_FUNCS = ("block_until_ready", "synchronize", "all_reduce",
                     "all_gather", "psum", "pmean", "broadcast", "barrier",
                     "reduce_scatter")
_IO_LINE_HINTS = ("time.sleep(", ".sleep(", "select.select(",
                  ".select(", ".poll(", ".recv(", ".recv_into(",
                  ".accept(", ".read(", ".readline(", ".readinto(",
                  ".connect(", "urlopen(", ".getresponse(",
                  ".communicate(", ".wait(")

_WITH_LOCK_RE = re.compile(r"with\s+([A-Za-z_][\w.]*)\s*:")
_ACQUIRE_RE = re.compile(r"([A-Za-z_][\w.]*)\.acquire\(")


# the serving engine's module, looked up (never imported) by the monitor
_ENGINE_MODULE = __name__.split(".")[0] + ".serving_llm.engine"


# ------------------------------------------------------------ capture

def _frame_list(frame, top_n: int) -> List[Dict[str, Any]]:
    """Innermost-first frame records, capped at ``top_n``."""
    out: List[Dict[str, Any]] = []
    f = frame
    while f is not None and len(out) < top_n:
        code = f.f_code
        out.append({"file": code.co_filename,
                    "line": f.f_lineno,
                    "func": code.co_name})
        f = f.f_back
    return out


def _src(frame_rec: Dict[str, Any]) -> str:
    return linecache.getline(frame_rec["file"],
                             frame_rec["line"]).strip()


def _where(frame_rec: Dict[str, Any]) -> str:
    return (f"{os.path.basename(frame_rec['file'])}:"
            f"{frame_rec['line']}:{frame_rec['func']}")


def _guarded_fields(path: str, lock_symbol: str) -> List[str]:
    """Field names annotated ``# guarded-by: <lock_symbol>`` in
    ``path`` — the lock-discipline declarations (analysis/
    lock_discipline.py) reused to *name* a contended lock."""
    fields: List[str] = []
    pat = re.compile(r"#\s*guarded-by:\s*" + re.escape(lock_symbol)
                     + r"\s*$")
    field_re = re.compile(r"^\s*(?:self\.)?(_?\w+)\s*[:=]")
    lineno = 1
    while True:
        line = linecache.getline(path, lineno)
        if not line:
            break
        if pat.search(line.rstrip()):
            m = field_re.match(line)
            if m:
                fields.append(m.group(1))
        lineno += 1
    return fields


def classify(frames: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Wedge taxonomy for one thread's stack (innermost-first).
    Returns ``{"state": ..., ...detail}``; see the module docstring
    for the taxonomy."""
    if not frames:
        return {"state": "running"}
    top = frames[0]
    top_file = os.path.basename(top["file"])
    # blocked_on_lock: parked inside threading.py's wait family; the
    # first application frame names the lock being waited on
    if top_file == "threading.py" and top["func"] in _LOCK_FUNCS:
        out: Dict[str, Any] = {"state": "blocked_on_lock"}
        for f in frames[1:]:
            if os.path.basename(f["file"]) == "threading.py":
                continue
            out["frame"] = _where(f)
            line = _src(f)
            m = _WITH_LOCK_RE.search(line) or _ACQUIRE_RE.search(line)
            if m:
                out["lock"] = m.group(1)
                guarded = _guarded_fields(f["file"], m.group(1))
                if guarded:
                    out["guards"] = guarded
            break
        return out
    line = _src(top)
    # plain Lock/RLock acquisition is a C call — a thread blocked on
    # ``with self._lock:`` parks with its innermost *Python* frame at
    # the with-statement itself, not inside threading.py
    m = _WITH_LOCK_RE.search(line) or _ACQUIRE_RE.search(line)
    if m:
        symbol = m.group(1)
        guarded = _guarded_fields(top["file"], symbol)
        if "lock" in symbol.lower() or guarded:
            out = {"state": "blocked_on_lock", "frame": _where(top),
                   "lock": symbol, "source_line": line[:160]}
            if guarded:
                out["guards"] = guarded
            return out
    for f in frames:
        if "/distributed/" in f["file"].replace("\\", "/") \
                or os.path.basename(f["file"]) == "collective.py" \
                or any(h in f["func"] for h in _COLLECTIVE_FUNCS):
            return {"state": "blocked_in_collective",
                    "frame": _where(f)}
    if any(h in line for h in _IO_LINE_HINTS):
        return {"state": "blocked_in_io", "frame": _where(top),
                "source_line": line[:160]}
    return {"state": "running"}


def capture(top_n: int = DEFAULT_TOP_N) -> List[Dict[str, Any]]:
    """Instant all-thread dump: one record per Python thread with its
    top-N frames (innermost first), daemon flag, wedge classification,
    and — when the sampler runs — how long the same top frame has
    been observed (``same_top_s``). Needs no flag: forensics must
    work with metrics off."""
    top_n = max(1, int(top_n))
    threads = {t.ident: t for t in threading.enumerate()}
    seen = sampler().top_seen()
    now_mono = time.monotonic()
    out: List[Dict[str, Any]] = []
    for ident, frame in sys._current_frames().items():
        t = threads.get(ident)
        frames = _frame_list(frame, top_n)
        rec: Dict[str, Any] = {
            "ident": ident,
            "name": t.name if t is not None else f"thread-{ident}",
            "daemon": bool(t.daemon) if t is not None else None,
            "frames": [_where(f) for f in frames],
            "top": _where(frames[0]) if frames else None,
        }
        rec.update(classify(frames))
        rec["_frames_raw"] = frames
        top_key = _fold_frame(frames[0]) if frames else None
        info = seen.get(ident)
        if info is not None and top_key is not None \
                and info[0] == top_key:
            rec["same_top_s"] = round(max(0.0, now_mono - info[1]), 3)
        else:
            rec["same_top_s"] = None
        out.append(rec)
    out.sort(key=lambda r: r["name"])
    return out


def _public(threads: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Strip internal fields before a record leaves the process."""
    return [{k: v for k, v in t.items() if not k.startswith("_")}
            for t in threads]


def stacks_view(top_n: int = DEFAULT_TOP_N) -> Dict[str, Any]:
    """The ``GET /stacks`` JSON body: live capture + sampler status."""
    return {"unix_time": time.time(),  # display stamp only
            "pid": os.getpid(),
            "threads": _public(capture(top_n)),
            "sampler": sampler().status()}


def dump_to_flight(reason: str, top_n: int = DEFAULT_TOP_N) -> None:
    """Record a ``thread_stacks`` event into the flight ring (forced:
    a signal dump must land even with metrics off)."""
    try:
        _flight.record("thread_stacks", force=True, reason=reason,
                       threads=_public(capture(top_n)))
    # ptlint: disable=silent-failure -- called from signal handlers and crash paths; a failed stack capture must never mask the original death
    except Exception:  # noqa: BLE001
        pass


# ----------------------------------------------------------- sampling

def _fold_frame(f: Dict[str, Any]) -> str:
    base = os.path.basename(f["file"])
    if base.endswith(".py"):
        base = base[:-3]
    return f"{base}:{f['func']}"


_OVERFLOW_KEY: Tuple[str, ...] = ("[overflow]",)


class StackSampler:
    """Continuous folded-stack sampling profiler (daemon thread).

    One tick = one ``sys._current_frames()`` sweep folded per thread
    into ``module:func`` frames (root-first) and counted in a bounded
    dict; keys past ``FLAGS_stack_profile_max`` aggregate into an
    ``[overflow]`` bucket (counted by
    ``stack_profile_dropped_total``). The rate flag is re-read every
    tick so live ``set_flags`` changes apply; self-overhead (busy /
    wall, EWMA-free cumulative ratio) is published as the
    ``stack_sampler_overhead_ratio`` gauge.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._profile: Dict[Tuple[str, Tuple[str, ...]], int] = {}  # guarded-by: self._lock
        self._top_seen: Dict[int, Tuple[str, float]] = {}  # guarded-by: self._lock
        self._samples_total = 0  # guarded-by: self._lock
        self._dropped_total = 0  # guarded-by: self._lock
        self._busy_s = 0.0  # guarded-by: self._lock
        self._started_mono: Optional[float] = None  # guarded-by: self._lock
        self._last_tick_mono: Optional[float] = None  # guarded-by: self._lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None  # guarded-by: self._lock

    # -- lifecycle ---------------------------------------------------------

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> bool:
        """Start the sampling thread if ``FLAGS_stack_sample_hz`` > 0
        (idempotent). Returns whether a sampler is running after the
        call."""
        if self._rate_hz() <= 0:
            return self.running()
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return True
            self._stop.clear()
            if self._started_mono is None:
                self._started_mono = time.monotonic()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="pt-stack-sampler")
            self._thread.start()
        return True

    def stop(self) -> None:
        with self._lock:
            thread = self._thread
            self._thread = None
        self._stop.set()
        if thread is not None and thread.is_alive():
            thread.join(timeout=5)

    def apply_rate(self, hz) -> None:
        """FLAGS_stack_sample_hz on_change hook: start on a positive
        rate, stop on zero/negative (the loop itself re-reads the flag
        each tick, so a live rate *change* needs no restart)."""
        if float(hz) > 0:
            self.start()
        else:
            self.stop()

    @staticmethod
    def _rate_hz() -> float:
        return float(GLOBAL_FLAGS.get("stack_sample_hz"))

    @staticmethod
    def _profile_max() -> int:
        return max(8, int(GLOBAL_FLAGS.get("stack_profile_max")))

    # -- the sampling loop -------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            hz = self._rate_hz()
            if hz <= 0:
                return
            period = 1.0 / hz
            t0 = time.perf_counter()
            try:
                self._tick()
            # ptlint: disable=silent-failure -- a profiler tick must never take the process down; the next tick retries
            except Exception:  # noqa: BLE001
                pass
            busy = time.perf_counter() - t0
            with self._lock:
                self._busy_s += busy
                self._last_tick_mono = time.monotonic()
            self._publish_overhead()
            self._stop.wait(max(0.0, period - busy))

    def _tick(self) -> None:
        me = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        now_mono = time.monotonic()
        cap = self._profile_max()
        with self._lock:
            live_idents = set()
            for ident, frame in frames.items():
                if ident == me:
                    continue  # never profile the profiler
                live_idents.add(ident)
                folded = self._fold(frame)
                name = names.get(ident, f"thread-{ident}")
                top = folded[-1] if folded else ""
                prev = self._top_seen.get(ident)
                if prev is None or prev[0] != top:
                    self._top_seen[ident] = (top, now_mono)
                key = (name, tuple(folded))
                if key not in self._profile \
                        and len(self._profile) >= cap:
                    self._dropped_total += 1
                    key = (name, _OVERFLOW_KEY)
                self._profile[key] = self._profile.get(key, 0) + 1
                self._samples_total += 1
            for gone in set(self._top_seen) - live_idents:
                del self._top_seen[gone]
        if _metrics.enabled():
            _metrics.counter(
                "stack_samples_total",
                "thread stacks folded into the sampling profiler's "
                "profile (one per thread per tick)").inc(
                    len(live_idents))

    @staticmethod
    def _fold(frame) -> List[str]:
        """Root-first ``module:func`` fold of one thread's stack."""
        out: List[str] = []
        f = frame
        while f is not None and len(out) < DEFAULT_TOP_N * 2:
            out.append(_fold_frame({"file": f.f_code.co_filename,
                                    "func": f.f_code.co_name}))
            f = f.f_back
        out.reverse()
        return out

    def _publish_overhead(self) -> None:
        ratio = self.overhead_ratio()
        if ratio is None:
            return
        _metrics.gauge(
            "stack_sampler_overhead_ratio",
            "fraction of wall time the stack-sampling profiler spends "
            "sampling (busy seconds / seconds since sampler start) — "
            "the acceptance bar is < 0.02 at the default rate",
            always=True).set(round(ratio, 6))
        with self._lock:
            dropped = self._dropped_total
        if dropped and _metrics.enabled():
            c = _metrics.counter(
                "stack_profile_dropped_total",
                "folded stacks aggregated into the [overflow] bucket "
                "because the profile hit FLAGS_stack_profile_max")
            got = c.value()
            if dropped > got:
                c.inc(dropped - got)

    # -- views -------------------------------------------------------------

    def overhead_ratio(self) -> Optional[float]:
        with self._lock:
            if self._started_mono is None:
                return None
            wall = time.monotonic() - self._started_mono
            busy = self._busy_s
        if wall <= 0:
            return None
        return busy / wall

    def top_seen(self) -> Dict[int, Tuple[str, float]]:
        with self._lock:
            return dict(self._top_seen)

    def profile(self) -> Dict[Tuple[str, Tuple[str, ...]], int]:
        with self._lock:
            return dict(self._profile)

    def status(self) -> Dict[str, Any]:
        with self._lock:
            last = self._last_tick_mono
            out = {"running": self.running(),
                   "rate_hz": self._rate_hz(),
                   "samples_total": self._samples_total,
                   "profile_keys": len(self._profile),
                   "profile_max": self._profile_max(),
                   "dropped_total": self._dropped_total}
        out["overhead_ratio"] = self.overhead_ratio()
        out["last_tick_age_s"] = (
            None if last is None
            else round(max(0.0, time.monotonic() - last), 3))
        return out

    def reset(self) -> None:
        self.stop()
        with self._lock:
            self._profile.clear()
            self._top_seen.clear()
            self._samples_total = 0
            self._dropped_total = 0
            self._busy_s = 0.0
            self._started_mono = None
            self._last_tick_mono = None


_SAMPLER = StackSampler()


def sampler() -> StackSampler:
    return _SAMPLER


# ------------------------------------------------------------ exports

def collapsed_text() -> str:
    """The sampled profile in collapsed/folded form (one
    ``thread;frame;frame count`` line, flamegraph.pl-compatible)."""
    prof = sampler().profile()
    lines = []
    for (name, frames), count in sorted(prof.items(),
                                        key=lambda kv: -kv[1]):
        lines.append(";".join([name] + list(frames)) + f" {count}")
    return "\n".join(lines) + ("\n" if lines else "")


def flame_trace() -> Dict[str, Any]:
    """The sampled profile as Chrome ``traceEvents`` JSON — the same
    export shape as tracer.chrome_trace() so Perfetto and trace_agg
    load it. The timeline is synthetic: each folded stack occupies
    ``count x mean sampling period`` microseconds on its thread's
    track, so span widths read as CPU shares."""
    prof = sampler().profile()
    status = sampler().status()
    pid = os.getpid()
    samples = max(1, int(status["samples_total"]))
    rate = float(status["rate_hz"]) or 0.0
    period_us = (1e6 / rate) if rate > 0 else 1e4
    by_thread: Dict[str, List[Tuple[Tuple[str, ...], int]]] = {}
    for (name, frames), count in prof.items():
        by_thread.setdefault(name, []).append((frames, count))
    meta: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": f"paddle_tpu_torch stack sampler (pid {pid})"}}]
    events: List[Dict[str, Any]] = []
    for tid, name in enumerate(sorted(by_thread), start=1):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": name}})
        cursor = 0.0
        for frames, count in sorted(by_thread[name],
                                    key=lambda kv: -kv[1]):
            dur = count * period_us
            for frame in frames:
                events.append({"name": frame, "ph": "X", "cat": "stack",
                               "ts": cursor, "dur": dur,
                               "pid": pid, "tid": tid,
                               "args": {"samples": count}})
            cursor += dur
    return {"traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "metadata": {"synthetic_timeline": True,
                         "samples_total": samples,
                         "period_us": period_us,
                         "overhead_ratio": status["overhead_ratio"]}}


# -------------------------------------------------------- hang doctor

class HangDoctor:
    """Captures + classifies stacks when a wedge is detected and
    records the ``hang_diagnosis`` flight event naming the culprit
    frame. Per-source debounce so a stall that is noticed every
    watchdog tick produces one diagnosis per episode."""

    DEBOUNCE_S = 10.0

    # a post-hoc source is the after-the-fact record of the same
    # episode a live source already diagnosed mid-wedge: the engine's
    # _note_step files "serving_step" AFTER the slow step returned,
    # when the wedged frame no longer exists. If the monitor's live
    # "serving" diagnosis landed within the debounce window, the
    # post-hoc one adds nothing (its capture shows the doctor itself)
    # and is skipped.
    _POST_HOC_OF = {"serving_step": "serving"}

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._last_mono: Dict[str, float] = {}  # guarded-by: self._lock

    def diagnose(self, source: str, detail: Optional[Dict[str, Any]] = None,
                 force: bool = False) -> Optional[Dict[str, Any]]:
        """Capture stacks now, pick the culprit thread, record the
        ``hang_diagnosis`` flight event. Returns the diagnosis, or
        None when debounced (same source, or the live counterpart of
        a post-hoc source, within DEBOUNCE_S)."""
        now_mono = time.monotonic()
        with self._lock:
            last = self._last_mono.get(source)
            if not force and last is not None \
                    and now_mono - last < self.DEBOUNCE_S:
                return None
            live = self._POST_HOC_OF.get(source)
            if not force and live is not None:
                live_last = self._last_mono.get(live)
                if live_last is not None \
                        and now_mono - live_last < self.DEBOUNCE_S:
                    return None
            self._last_mono[source] = now_mono
        threads = capture()
        culprit = self._pick_culprit(threads, source)
        diag: Dict[str, Any] = {
            "source": source,
            "unix_time": time.time(),  # display stamp only
            "n_threads": len(threads),
            "culprit": None,
        }
        if detail:
            diag["detail"] = detail
        if culprit is not None:
            diag["culprit"] = {
                "thread": culprit["name"],
                "state": culprit["state"],
                "frame": culprit.get("frame") or culprit.get("top"),
                "top": culprit.get("top"),
                "lock": culprit.get("lock"),
                "guards": culprit.get("guards"),
                "same_top_s": culprit.get("same_top_s"),
                "frames": culprit.get("frames", [])[:8],
            }
        _flight.record("hang_diagnosis", force=True, **diag)
        _metrics.counter(
            "hang_diagnoses_total",
            "wedge diagnoses recorded by the hang doctor (stacks "
            "captured + culprit thread classified; source: serving | "
            "serving_step | train_heartbeat | manual)",
            always=True).inc(source=source)
        dump_to_flight(f"hang:{source}")
        return diag

    @staticmethod
    def _pick_culprit(threads: List[Dict[str, Any]],
                      source: str) -> Optional[Dict[str, Any]]:
        """Score threads for blame: blocked beats running, a frame in
        the wedge's subsystem beats one outside it, non-daemon beats
        daemon, and the known always-waiting infra threads are out."""
        hint = "serving_llm" if source.startswith("serving") else "hapi"
        best, best_score = None, float("-inf")
        for t in threads:
            name = t["name"]
            score = 0.0
            if name in _INFRA_THREADS or name.startswith(_INFRA_THREADS):
                score -= 100.0
            if t.get("state", "running") != "running":
                score += 2.0
            if t.get("daemon") is False:
                score += 2.0
            raw = t.get("_frames_raw", [])
            if any(hint in f["file"] for f in raw):
                score += 4.0
            if name == "MainThread":
                score += 1.0
            score += 0.01 * min(len(raw), 20)
            if score > best_score:
                best, best_score = t, score
        return best

    def on_stall(self, source: str,
                 detail: Optional[Dict[str, Any]] = None) -> None:
        """Fire-and-forget entry point for watchdogs (engine
        ``_note_step``, launcher heartbeats): never raises."""
        try:
            self.diagnose(source, detail=detail)
        # ptlint: disable=silent-failure -- diagnosis is a best-effort detour off a watchdog path; the stall event itself is already recorded
        except Exception:  # noqa: BLE001
            pass

    def reset(self) -> None:
        with self._lock:
            self._last_mono.clear()


_DOCTOR = HangDoctor()


def doctor() -> HangDoctor:
    return _DOCTOR


class HangMonitor:
    """Daemon thread that watches for *live* wedges — a serving engine
    whose current step is stalled right now (engine.health() judges
    from the step stamps) or a training heartbeat past its timeout —
    and calls the doctor while the hang is in progress, which is the
    only moment the culprit stack exists. Edge-triggered per source;
    ``FLAGS_hang_check_interval_s`` <= 0 disables."""

    def __init__(self) -> None:
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._was_wedged: Dict[str, bool] = {}

    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    @staticmethod
    def _interval_s() -> float:
        return float(GLOBAL_FLAGS.get("hang_check_interval_s"))

    def start(self) -> bool:
        if self._interval_s() <= 0:
            return self.running()
        if self.running():
            return True
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="pt-hang-monitor")
        self._thread.start()
        return True

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None and t.is_alive():
            t.join(timeout=5)
        self._was_wedged.clear()

    def _loop(self) -> None:
        while not self._stop.is_set():
            interval = self._interval_s()
            if interval <= 0:
                return
            try:
                self._check()
            # ptlint: disable=silent-failure -- the watchdog must outlive any transient health-read error; next tick retries
            except Exception:  # noqa: BLE001
                pass
            self._stop.wait(max(0.05, interval))

    def _check(self) -> None:
        self._check_serving()
        self._check_heartbeat()

    def _check_serving(self) -> None:
        mod = sys.modules.get(_ENGINE_MODULE)
        if mod is None:
            return
        try:
            snap = mod.health_snapshot()
        # ptlint: disable=silent-failure -- health readout raced an engine teardown; nothing to diagnose this tick
        except Exception:  # noqa: BLE001
            return
        stalled = [h for h in snap.get("engines", [])
                   if h.get("stalled")]
        wedged = bool(stalled)
        if wedged and not self._was_wedged.get("serving"):
            doctor().on_stall("serving",
                              detail={"engines": len(stalled),
                                      "last_step_age_s":
                                          stalled[0].get(
                                              "last_step_age_s")})
        self._was_wedged["serving"] = wedged

    def _check_heartbeat(self) -> None:
        from . import server as _server  # lazy: avoid import cycle
        age = _server._heartbeat_age_s()
        timeout = float(GLOBAL_FLAGS.get("health_heartbeat_timeout_s"))
        wedged = bool(age is not None and timeout > 0 and age > timeout)
        if wedged and not self._was_wedged.get("train_heartbeat"):
            doctor().on_stall("train_heartbeat",
                              detail={"heartbeat_age_s": round(age, 3),
                                      "timeout_s": timeout})
        self._was_wedged["train_heartbeat"] = wedged


_MONITOR = HangMonitor()


def monitor() -> HangMonitor:
    return _MONITOR


# ------------------------------------------------------------ signals

_sigusr2_installed = False
_prev_sigusr2 = None


def _on_sigusr2(signum, frame) -> None:
    """SIGUSR2 = dump stacks and keep running (the live-forensics
    poke; a wedged worker gets this from the launcher's heartbeat
    watch). Unlike the fatal-signal path the process survives."""
    dump_to_flight("sigusr2")
    _flight.dump("sigusr2")
    prev = _prev_sigusr2
    if callable(prev):
        try:
            prev(signum, frame)
        # ptlint: disable=silent-failure -- a broken pre-existing handler must not turn a diagnostic poke into a crash
        except Exception:  # noqa: BLE001
            pass


def install_signal_dump() -> bool:
    """Install the SIGUSR2 stacks-dump handler (idempotent; False off
    the main thread, where signal.signal refuses)."""
    global _sigusr2_installed, _prev_sigusr2
    if _sigusr2_installed:
        return True
    if not hasattr(signal, "SIGUSR2"):
        return False
    try:
        _prev_sigusr2 = signal.signal(signal.SIGUSR2, _on_sigusr2)
    except (ValueError, OSError):
        return False
    _sigusr2_installed = True
    return True


def maybe_start() -> None:
    """Flag-driven lifecycle hook, called when the observability
    exporter comes up (server.maybe_start): start the sampler when
    ``FLAGS_stack_sample_hz`` > 0, the hang monitor when
    ``FLAGS_hang_check_interval_s`` > 0, and install the SIGUSR2 dump
    handler."""
    sampler().start()
    monitor().start()
    install_signal_dump()


def reset() -> None:
    """Test/new-run hygiene (observability.reset_all): stop the
    sampler + monitor threads and clear profile/diagnosis state. The
    installed SIGUSR2 handler stays (harmless, idempotent)."""
    sampler().reset()
    monitor().stop()
    doctor().reset()
