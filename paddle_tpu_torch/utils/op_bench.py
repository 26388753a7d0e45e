"""Per-op micro-benchmark harness (the reference's ``op_tester``: run one
op at a configured shape, report ms/op).

Counterpart of ``paddle_tpu.utils.op_bench``. A case is a callable and
its example inputs. ``bench_op`` times the calls on the device given as
``device``, else on that of the first tensor argument, else (a callable
that closes over its tensors) on the card: there with CUDA events around
the timed loop (device time, after a warm-up), on the CPU with the host
clock.

CLI: ``python -m paddle_tpu_torch.utils.op_bench matmul 512x512`` runs a
registered op at the given shape on the card.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Dict, Sequence

import numpy as np
import torch

__all__ = ["bench_op", "registered_ops"]


def _device_of(args, device) -> torch.device:
    from ..core.place import resolve_device
    if device is None:
        for a in args:
            if isinstance(a, torch.Tensor):
                return a.device
    return resolve_device(device)


def bench_op(fn: Callable, *args, iters: int = 50, warmup: int = 5,
             device=None) -> Dict[str, float]:
    """Times ``fn(*args)`` on ``device`` (see the module note); returns
    ``{ms, ops_per_sec}`` per call."""
    dev = _device_of(args, device)
    with torch.no_grad():
        for _ in range(warmup):
            fn(*args)
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3 / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            dt = (time.perf_counter() - t0) / iters
    return {"ms": dt * 1e3, "ops_per_sec": 1.0 / dt}


def _parse_shape(s: str):
    return tuple(int(t) for t in s.split("x"))


def registered_ops(device=None) -> Dict[str, Callable]:
    from ..core.place import resolve_device
    from ..ops import activation as A
    from ..ops import nn_functional as F
    rng = np.random.default_rng(0)

    # the device is resolved when a case is built (None: the card)
    def t(a):
        return torch.tensor(a, dtype=torch.float32,
                            device=resolve_device(device))

    def matmul(shape):
        a = t(rng.normal(0, 1, shape))
        b = t(rng.normal(0, 1, (shape[-1], shape[0])))
        return lambda: bench_op(torch.matmul, a, b)

    def softmax(shape):
        x = t(rng.normal(0, 1, shape))
        return lambda: bench_op(A.softmax, x)

    def layer_norm(shape):
        x = t(rng.normal(0, 1, shape))
        w = t(np.ones((shape[-1],)))
        b = t(np.zeros((shape[-1],)))
        return lambda: bench_op(
            lambda x, w, b: F.layer_norm(x, w, b, 1e-5, x.ndim - 1),
            x, w, b)

    def conv2d(shape):
        x = t(rng.normal(0, 1, (1, 8) + shape))
        w = t(rng.normal(0, 0.1, (16, 8, 3, 3)))
        return lambda: bench_op(lambda x, w: F.conv2d(x, w, None), x, w)

    return {"matmul": matmul, "softmax": softmax,
            "layer_norm": layer_norm, "conv2d": conv2d}


def main(argv: Sequence[str] = None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    ops = registered_ops()
    if not argv or argv[0] not in ops:
        print(f"usage: op_bench <{'|'.join(ops)}> [HxW[xD..]]")
        return 2
    shape = _parse_shape(argv[1]) if len(argv) > 1 else (512, 512)
    res = ops[argv[0]](shape)()
    print(f"{argv[0]} {shape}: {res['ms']:.3f} ms/op "
          f"({res['ops_per_sec']:.1f} ops/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
