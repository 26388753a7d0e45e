"""Multi-process launcher with a failure watch and the control plane.

Counterpart of ``paddle_tpu.distributed.launch`` (the reference's
``distributed/launch.py`` launch: one process per card with
PADDLE_TRAINER_ID/PADDLE_TRAINERS_NUM, the watch loop that tears the job
down when a child dies, ``utils.py`` ``terminate_local_procs``), the same
names, arguments, environment and restart policy:

- one process per rank (``--nproc``, one card each); ranks are numbered
  host by host;
- the launcher hosts the native control plane (``csrc/control_plane.cc``,
  ``native.ControlPlaneServer``) and hands its address to every rank as
  ``PT_CP_ENDPOINT``;
- torch's process group needs a rendezvous store beside it: the launcher
  makes a fresh ``FileStore`` path per gang (``PT_STORE_PATH``, removed
  after), which ``parallel.init_parallel_env`` joins, and sets
  ``LOCAL_WORLD_SIZE`` (the ranks of this host: ``mesh.num_slices``);
- ``launch_procs`` takes a ``timeout_s`` bound on the whole gang (a rank
  stuck in a collective never exits by itself): past it the gang is torn
  down and the call returns 124.
"""

from __future__ import annotations

import os
import random
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

__all__ = ["launch_procs", "launch_elastic", "terminate_local_procs",
           "get_cluster_env", "fleet_observability_env",
           "classify_exit", "spawn"]


def classify_exit(code: int) -> str:
    """Exit-code triage for the restart policy: ``clean`` (0),
    ``preempt`` (died by SIGTERM — the scheduler's preemption signal,
    re-raised by preemption.guard after the graceful checkpoint), or
    ``crash`` (anything else). Accepts both Popen's negative-signal
    convention and the shell's 128+N."""
    if code == 0:
        return "clean"
    if code == -int(signal.SIGTERM) or code == 128 + int(signal.SIGTERM):
        return "preempt"
    return "crash"


def get_cluster_env(rank: int, world: int, cp_endpoint: str) \
        -> Dict[str, str]:
    """Env block for one trainer process (reference names kept for
    drop-in parity + PT_* spellings)."""
    return {
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(world),
        "PT_TRAINER_ID": str(rank),
        "PT_TRAINERS_NUM": str(world),
        "PT_CP_ENDPOINT": cp_endpoint,
    }


def fleet_observability_env(rank: int, env: Dict[str, str]
                            ) -> Dict[str, str]:
    """Per-worker observability wiring (docs/observability.md, "Fleet
    view"). With a positive FLAGS_metrics_port in the job env as the
    *base* port, every worker gets its own exporter port (base + rank
    — N workers on one host no longer collide on one bind) and the
    fleet-federation discovery env: PT_FLEET_AGGREGATOR points every
    worker at rank 0's exporter (the aggregator) and PT_FLEET_HOST
    names the worker in the merged view. The assigned port is both in
    the worker's env and in every snapshot it pushes (fleet.py
    local_snapshot), so /fleet/health lists where each worker serves.
    Base <= 0 (ephemeral/off) leaves everything untouched — federation
    then needs explicit fleet.start_reporter wiring."""
    try:
        base = int(env.get("FLAGS_metrics_port",
                           os.environ.get("FLAGS_metrics_port", "0")))
    except ValueError:
        return {}
    if base <= 0:
        return {}
    return {
        "FLAGS_metrics_port": str(base + rank),
        "PT_FLEET_AGGREGATOR": f"127.0.0.1:{base}",
        "PT_FLEET_HOST": f"{socket.gethostname()}:{rank}",
    }


class _WedgeWatch:
    """Launcher-side hang forensics (the elastic-launch heartbeat
    path of the hang doctor, observability/stacks.py).

    When the fleet wiring is active every worker serves /healthz on
    its assigned exporter port; the watch polls each live child every
    ``POLL_S`` seconds (0.5 s timeout — a wedged worker's exporter
    thread still answers while its step thread hangs) and, on the
    *transition* to wedged (heartbeat stale or a serving engine
    stalled), records a forced ``worker_wedged`` flight event in the
    launcher and sends the child SIGUSR2 — which makes the worker
    dump its own all-thread stacks into its flight file
    (stacks.install_signal_dump). One poke per wedge episode; a
    worker that recovers re-arms."""

    POLL_S = 5.0

    def __init__(self, ports: Dict[int, int]) -> None:
        self.ports = ports
        self._last_mono: Optional[float] = None
        self._wedged: Dict[int, bool] = {}

    @staticmethod
    def _wedged_payload(body: bytes) -> bool:
        import json
        try:
            h = json.loads(body)
        except ValueError:
            return False
        serving = h.get("serving") or {}
        return bool(h.get("wedged")
                    or any(e.get("stalled")
                           for e in serving.get("engines", [])))

    def poll(self, procs: Sequence[subprocess.Popen]) -> None:
        if not self.ports:
            return
        now = time.monotonic()
        if self._last_mono is not None \
                and now - self._last_mono < self.POLL_S:
            return
        self._last_mono = now
        import urllib.error
        import urllib.request
        for rank, port in self.ports.items():
            if rank >= len(procs) or procs[rank].poll() is not None:
                continue
            wedged = False
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz",
                        timeout=0.5) as r:
                    r.read()
            except urllib.error.HTTPError as e:
                wedged = e.code == 503 and self._wedged_payload(
                    e.read())
            # ptlint: disable=silent-failure -- worker still booting or exporter off; liveness is the exit-code watch's job
            except Exception:  # noqa: BLE001
                continue
            if wedged and not self._wedged.get(rank):
                from ..observability import flight as _flight
                _flight.record("worker_wedged", force=True, rank=rank,
                               port=port, action="SIGUSR2")
                try:
                    os.kill(procs[rank].pid, signal.SIGUSR2)
                # ptlint: disable=silent-failure -- raced the worker's death; the worker_wedged flight event above already records the episode and the exit watch owns dead children
                except OSError:
                    pass
            self._wedged[rank] = wedged


def terminate_local_procs(procs: Sequence[subprocess.Popen],
                          grace_s: float = 5.0) -> None:
    """(ref: distributed/utils.py:252)."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.time() + grace_s
    for p in procs:
        while p.poll() is None and time.time() < deadline:
            time.sleep(0.1)
        if p.poll() is None:
            p.kill()


def _gang_env(nproc: int, store_dir: str) -> Dict[str, str]:
    """What the port's ranks need beside the JAX environment: the
    process group's FileStore and the ranks of this host."""
    return {"PT_STORE_PATH": os.path.join(store_dir, "store"),
            "LOCAL_WORLD_SIZE": str(nproc)}


def launch_procs(cmd: Sequence[str], nproc: int,
                 env_extra: Optional[Dict[str, str]] = None,
                 start_control_plane: bool = True,
                 poll_interval: float = 0.5,
                 timeout_s: Optional[float] = None) -> int:
    """Spawn `nproc` copies of cmd with rank env; watch until all exit.

    Any child failing tears the whole job down (reference watch loop
    launch.py:219-226). Returns the first nonzero exit code, or 0; 124
    when ``timeout_s`` passes first (the gang is torn down).
    """
    server = None
    cp_endpoint = ""
    if start_control_plane:
        from .. import native
        server = native.ControlPlaneServer()
        cp_endpoint = f"127.0.0.1:{server.port}"
    procs: List[subprocess.Popen] = []
    worker_ports: Dict[int, int] = {}
    store_dir = tempfile.mkdtemp(prefix="pt_launch_")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        for rank in range(nproc):
            env = dict(os.environ)
            env.update(get_cluster_env(rank, nproc, cp_endpoint))
            env.update(_gang_env(nproc, store_dir))
            if env_extra:
                env.update(env_extra)
            # per-worker exporter port + fleet discovery (base+rank
            # scheme; no-op unless a positive base port is configured)
            fleet_env = fleet_observability_env(rank, env)
            env.update(fleet_env)
            if fleet_env:
                worker_ports[rank] = int(fleet_env["FLAGS_metrics_port"])
            procs.append(subprocess.Popen(list(cmd), env=env))
        exit_code = 0
        wedge_watch = _WedgeWatch(worker_ports)
        while True:
            states = [p.poll() for p in procs]
            if any(s not in (None, 0) for s in states):
                exit_code = next(s for s in states if s not in (None, 0))
                terminate_local_procs(procs)
                break
            if all(s == 0 for s in states):
                break
            if deadline is not None and time.monotonic() > deadline:
                print(f"[launch] gang still running after {timeout_s}s; "
                      f"tearing it down", file=sys.stderr, flush=True)
                exit_code = 124
                break
            wedge_watch.poll(procs)
            time.sleep(poll_interval)
        return exit_code
    finally:
        terminate_local_procs(procs)
        if server is not None:
            server.stop()
        shutil.rmtree(store_dir, ignore_errors=True)


def launch_elastic(cmd: Sequence[str], nproc: int,
                   max_restarts: int = 3,
                   env_extra: Optional[Dict[str, str]] = None,
                   poll_interval: float = 0.5,
                   backoff_s: float = 0.0,
                   backoff_max_s: float = 30.0,
                   restart_budget: int = 0,
                   restart_window_s: float = 60.0,
                   start_control_plane: bool = True) -> int:
    """Gang-restart orchestration: when any worker dies, the whole job
    is torn down (launch_procs's watch loop) and relaunched, up to
    ``max_restarts`` times. Training scripts resume from their last
    checkpoint via incubate.TrainEpochRange / io.AsyncCheckpointer /
    hapi.Model.fit(ckpt_dir=).

    This is the half the reference never implemented — its watch loop
    only detects child exit and tears down
    (the reference's python/paddle/distributed/launch.py:219-226,
    utils.py:252 terminate_local_procs; DistributedStrategy.elastic is
    a stub, distributed_strategy.proto:105). Restart counter rides in
    PT_ELASTIC_ATTEMPT; each attempt gets a fresh control plane.

    Restart policy (docs/fault_tolerance.md): exits are classified by
    :func:`classify_exit`. A *preemption* (SIGTERM death — the worker
    already checkpointed via preemption.guard) respawns immediately and
    never burns the failure budget. A *crash* backs off exponentially
    from ``backoff_s`` (doubling per consecutive crash, capped at
    ``backoff_max_s``, +0-25% jitter so gangs don't thunder) and is
    charged against the failure budget: more than ``restart_budget``
    crashes inside the sliding ``restart_window_s`` window aborts the
    job immediately (``elastic_budget_exhausted_total``) — a
    deterministic crash-loop fails fast instead of burning
    ``max_restarts`` on one bad step. ``restart_budget=0`` disables the
    budget; ``backoff_s=0`` disables backoff.

    Goodput accounting: the launcher counts restarts
    (``elastic_restarts_total``, labeled by exit kind) and hands each
    relaunched gang the cumulative teardown-to-respawn dead time
    (backoff included) via ``PT_RESTART_IDLE_S`` — the child's goodput
    ledger seeds its ``restart_idle`` bucket from it (plus its own
    import-to-resume time, anchored by PT_ELASTIC_ATTEMPT > 0), so
    /goodput on a restarted worker shows what the crash actually cost.
    """
    from ..observability import flight as _flight
    from ..observability import metrics as _metrics

    attempt = 0
    idle_s = 0.0
    consecutive_crashes = 0
    crash_times: deque = deque()
    while True:
        env = dict(env_extra or {})
        env["PT_ELASTIC_ATTEMPT"] = str(attempt)
        env["PT_RESTART_IDLE_S"] = f"{idle_s:.3f}"
        code = launch_procs(cmd, nproc, env_extra=env,
                            poll_interval=poll_interval,
                            start_control_plane=start_control_plane)
        if code == 0:
            return 0
        t_dead = time.monotonic()
        kind = classify_exit(code)
        _metrics.counter(
            "elastic_restarts_total",
            "gang restarts performed by launch_elastic after a worker "
            "failure (kind: preempt | crash)", always=True).inc(kind=kind)
        _flight.record("elastic_restart", force=True, attempt=attempt,
                       exit_code=code, exit_kind=kind)
        if attempt >= max_restarts:
            return code
        if kind == "crash":
            now = time.monotonic()
            crash_times.append(now)
            while crash_times and now - crash_times[0] > restart_window_s:
                crash_times.popleft()
            if restart_budget > 0 and len(crash_times) > restart_budget:
                _metrics.counter(
                    "elastic_budget_exhausted_total",
                    "jobs aborted by launch_elastic's sliding-window "
                    "failure budget (crash-loop fail-fast)",
                    always=True).inc()
                _flight.record("elastic_budget_exhausted", force=True,
                               crashes=len(crash_times),
                               window_s=restart_window_s)
                print(f"[launch] {len(crash_times)} crashes within "
                      f"{restart_window_s:.0f}s exceed the restart "
                      f"budget ({restart_budget}); giving up rc={code}",
                      file=sys.stderr, flush=True)
                return code
            consecutive_crashes += 1
            if backoff_s > 0:
                delay = min(backoff_max_s,
                            backoff_s * 2 ** (consecutive_crashes - 1))
                delay *= 1.0 + random.uniform(0.0, 0.25)
                time.sleep(delay)
        else:  # preemption: the worker already checkpointed — respawn
            consecutive_crashes = 0
        print(f"[launch] job {'preempted' if kind == 'preempt' else 'failed'}"
              f" rc={code}; gang restart {attempt + 1}/{max_restarts}",
              file=sys.stderr, flush=True)
        idle_s += time.monotonic() - t_dead
        attempt += 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI: python -m paddle_tpu_torch.distributed.launch --nproc N
    [--elastic R] script.py args...
    (ref: python -m paddle.distributed.launch)."""
    import argparse
    parser = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch")
    parser.add_argument("--nproc", type=int, default=1)
    parser.add_argument("--elastic", type=int, default=0, metavar="R",
                        help="gang-restart the job up to R times on "
                             "worker failure (resume via checkpoints)")
    parser.add_argument("--backoff", type=float, default=0.0,
                        metavar="S",
                        help="initial crash-restart backoff in seconds "
                             "(doubles per consecutive crash, capped, "
                             "jittered; 0 = immediate respawn)")
    parser.add_argument("--restart-budget", type=int, default=0,
                        metavar="R",
                        help="abort when more than R crash-restarts "
                             "fall inside the sliding window "
                             "(0 = no budget)")
    parser.add_argument("--restart-window", type=float, default=60.0,
                        metavar="S",
                        help="sliding window (seconds) for "
                             "--restart-budget")
    parser.add_argument("script")
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cmd = [sys.executable, args.script] + list(args.script_args)
    if args.elastic > 0:
        return launch_elastic(cmd, args.nproc,
                              max_restarts=args.elastic,
                              backoff_s=args.backoff,
                              restart_budget=args.restart_budget,
                              restart_window_s=args.restart_window)
    return launch_procs(cmd, args.nproc)


def spawn(func, args=(), nprocs: int = 1, join: bool = True,
          timeout: Optional[float] = None):
    """Programmatic multi-process launcher
    (ref: python/paddle/distributed/spawn.py paddle.distributed.spawn —
    run ``func(*args)`` in ``nprocs`` processes with the cluster env
    set, the API equivalent of the ``launch`` CLI).

    ``func`` must be a module-level callable (pickled to workers). Each
    worker gets PT_TRAINER_ID/PT_TRAINERS_NUM/PT_CP_ENDPOINT exactly as
    the CLI would set them; call ``init_parallel_env()`` inside ``func``
    to join the job. With ``join`` (default) blocks until every worker
    exits — ``timeout`` bounds the TOTAL wall-clock — returns exit
    codes, terminating the gang and raising if any worker fails (a
    crashed rank must never deadlock the rest at a barrier). With
    ``join=False`` returns (processes, control_plane_server); the
    caller owns both.
    """
    import multiprocessing as mp

    from ..native import ControlPlaneServer

    ctx = mp.get_context("spawn")  # never fork a process holding CUDA
    server = None
    procs = []
    store_dir = tempfile.mkdtemp(prefix="pt_spawn_")
    try:
        server = ControlPlaneServer()
        endpoint = f"127.0.0.1:{server.port}"
        for rank in range(nprocs):
            env = get_cluster_env(rank, nprocs, endpoint)
            env.update(_gang_env(nprocs, store_dir))
            env.update(fleet_observability_env(rank, env))
            p = ctx.Process(target=_spawn_entry,
                            args=(func, args, env), daemon=False)
            p.start()
            procs.append(p)
        if not join:
            out_procs, out_server = procs, server
            procs, server = [], None  # ownership transferred
            store_dir = ""  # the caller's gang still meets there
            return out_procs, out_server
        # failure watch (launch_procs' poll-loop invariant): any dead
        # worker with a nonzero code tears the gang down immediately
        deadline = None if timeout is None else time.time() + timeout
        while True:
            codes = [p.exitcode for p in procs]
            if any(c not in (None, 0) for c in codes):
                bad = [(i, c) for i, c in enumerate(codes)
                       if c not in (None, 0)]
                raise RuntimeError(
                    f"spawn: workers failed (rank, code): {bad}")
            if all(c == 0 for c in codes):
                return codes
            if deadline is not None and time.time() > deadline:
                raise TimeoutError(
                    f"spawn: workers still running after {timeout}s")
            time.sleep(0.1)
    finally:
        # terminate AND join: terminate() alone leaves zombies (the
        # exit status is never reaped) — mirror terminate_local_procs'
        # bounded grace period, escalating to SIGKILL
        for p in procs:
            if p.is_alive():
                p.terminate()
        grace_deadline = time.monotonic() + 5.0
        for p in procs:
            p.join(max(0.0, grace_deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(1.0)
        if server is not None:
            server.stop()
        if store_dir:
            shutil.rmtree(store_dir, ignore_errors=True)


def _spawn_entry(func, args, env) -> None:
    """Worker bootstrap: install the cluster env BEFORE anything reads
    it (module-level so the spawn context can pickle it)."""
    import os as _os
    _os.environ.update(env)
    func(*args)


if __name__ == "__main__":
    sys.exit(main())
