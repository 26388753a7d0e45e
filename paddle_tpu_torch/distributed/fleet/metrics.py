"""Fleet metrics: statistics aggregated across every trainer process.

Counterpart of ``paddle_tpu.distributed.fleet.metrics`` (the reference's
fleet/metrics/metric.py: ``sum``, ``max``, ``min``, ``acc``, ``mae``,
``mse``, ``rmse``, ``auc``, each reducing local numpy statistics across
the workers). The transport is the native control plane
(``csrc/control_plane.cc``, through ``native.ControlPlaneClient``) that
``distributed.launch`` starts and names in ``PT_CP_ENDPOINT``, so metrics
aggregate in any job the launcher started, with or without a process
group. A single-process job aggregates trivially.

Every worker calls the same functions in the same order (the
reference's collective contract).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["sum", "max", "min", "acc", "mae", "mse", "rmse", "auc"]

_client = None
_round = 0


def _env():
    from ...parallel.env import ParallelEnv
    return ParallelEnv()


def _cp():
    global _client
    if _client is None:
        from ... import native
        ep = os.environ.get("PT_CP_ENDPOINT", "")
        if not ep:
            raise RuntimeError(
                "fleet.metrics needs PT_CP_ENDPOINT (set by "
                "distributed/launch.py) to aggregate across processes")
        host, port = ep.rsplit(":", 1)
        _client = native.ControlPlaneClient(host, int(port))
    return _client


def _allreduce(local: np.ndarray, op: str) -> np.ndarray:
    """Reduce a small numpy array across all trainers.

    Every rank publishes its value, reads all ranks' values, and
    reduces locally — the gloo-allreduce role of the reference
    (metric.py `fleet.util.all_reduce`). Values are tiny (metric
    stats), so O(world²) reads are irrelevant.

    Key usage is BOUNDED (the control plane has no delete): each rank
    double-buffers two fixed keys by round parity, with the round id
    embedded in the value. A slot is only overwritten two rounds later,
    by which time every rank has provably read it (the collective
    contract — all ranks call in the same order — means finishing round
    N+1 required reading everyone's N+1, which required them to have
    finished reading round N).
    """
    import struct
    import time as _time

    global _round
    env = _env()
    world = env.world_size
    if world <= 1:
        return local
    cp = _cp()
    _round += 1
    want = _round
    payload = struct.pack(">Q", want) \
        + np.ascontiguousarray(local).tobytes()
    cp.set(f"__fmetric_{env.rank}_{want % 2}", payload)
    # Peers can legitimately lag minutes behind (kernel builds, data
    # skew): keep waiting up to a 10-minute deadline rather than dying
    # on the client's 30s default get timeout.
    deadline = _time.monotonic() + 600.0
    parts = []
    for r in range(world):
        key = f"__fmetric_{r}_{want % 2}"
        while True:
            try:
                raw = cp.get(key, block=True, timeout_ms=30000)
            except (TimeoutError, KeyError):
                if _time.monotonic() > deadline:
                    raise TimeoutError(
                        f"fleet.metrics: rank {r} never published round "
                        f"{want} within 600s — peer dead or collective "
                        f"call order diverged")
                continue
            (got,) = struct.unpack(">Q", raw[:8])
            if got >= want:
                break
            if _time.monotonic() > deadline:
                raise TimeoutError(
                    f"fleet.metrics: rank {r} stuck at round {got} < "
                    f"{want} after 600s")
            _time.sleep(0.002)
        parts.append(np.frombuffer(raw[8:], local.dtype)
                     .reshape(local.shape))
    stacked = np.stack(parts)
    if op == "sum":
        return stacked.sum(axis=0)
    if op == "max":
        return stacked.max(axis=0)
    if op == "min":
        return stacked.min(axis=0)
    raise ValueError(f"unknown reduce op {op!r}")


def sum(input) -> np.ndarray:  # noqa: A001 — reference name
    """(ref: metric.py sum) global sum of a local stat array/scalar."""
    return _allreduce(np.asarray(input, np.float64), "sum")


def max(input) -> np.ndarray:  # noqa: A001
    return _allreduce(np.asarray(input, np.float64), "max")


def min(input) -> np.ndarray:  # noqa: A001
    return _allreduce(np.asarray(input, np.float64), "min")


def _ratio_of_sums(num, den) -> float:
    """One packed allreduce for numerator+denominator (halves the
    cross-rank latency of acc/mae/mse)."""
    packed = _allreduce(
        np.asarray([float(np.asarray(num).sum()),
                    float(np.asarray(den).sum())], np.float64), "sum")
    return float(packed[0] / np.maximum(packed[1], 1e-12))


def acc(correct, total) -> float:
    """(ref: metric.py acc) global accuracy from local counts."""
    return _ratio_of_sums(correct, total)


def mae(abserr, total_ins_num) -> float:
    return _ratio_of_sums(abserr, total_ins_num)


def mse(sqrerr, total_ins_num) -> float:
    return _ratio_of_sums(sqrerr, total_ins_num)


def rmse(sqrerr, total_ins_num) -> float:
    return float(np.sqrt(mse(sqrerr, total_ins_num)))


def auc(stat_pos, stat_neg) -> float:
    """(ref: metric.py auc) global AUC from per-threshold pos/neg
    histograms (the reference's distributed AUC computes the same
    trapezoid over summed stat buckets)."""
    local_pos = np.asarray(stat_pos, np.float64).ravel()
    local_neg = np.asarray(stat_neg, np.float64).ravel()
    both = _allreduce(np.concatenate([local_pos, local_neg]), "sum")
    pos, neg = both[:len(local_pos)], both[len(local_pos):]
    # walk thresholds high→low accumulating TP/FP (trapezoid area)
    tot_pos = float(pos.sum())
    tot_neg = float(neg.sum())
    if tot_pos == 0.0 or tot_neg == 0.0:
        return 0.5
    area = 0.0
    tp = fp = 0.0
    for i in range(len(pos) - 1, -1, -1):
        new_tp = tp + float(pos[i])
        new_fp = fp + float(neg[i])
        area += (new_fp - fp) * (tp + new_tp) / 2.0
        tp, fp = new_tp, new_fp
    return float(area / (tot_pos * tot_neg))
