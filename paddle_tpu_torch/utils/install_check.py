"""Install verification: the reference's ``run_check`` (train a tiny
linear model, report success or what failed).

Counterpart of ``paddle_tpu.utils.install_check``. It checks (1) that the
device initialises and reports its name, (2) that a ``TrainStep`` runs
and lowers the loss, and (3) when more than one process is in the job,
that the same step runs as a ``ShardedTrainStep`` over a ``dp`` mesh. It
runs on the card unless asked for the CPU (``device="cpu"``).
"""

from __future__ import annotations

__all__ = ["run_check"]


def run_check(verbose: bool = True, device=None) -> bool:
    import numpy as np
    import torch

    def say(msg):
        if verbose:
            print(f"[paddle_tpu_torch] {msg}", flush=True)

    say("Running install check ...")
    try:
        from ..core.place import resolve_device
        dev = resolve_device(device)
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
            else "cpu"
        count = torch.cuda.device_count() if dev.type == "cuda" else 1
        say(f"device={dev} ({name}) devices={count}")
    except Exception as e:  # noqa: BLE001 - the report is the result
        say(f"FAIL: device initialization raised: {e!r}")
        say("Hint: without a CUDA device, pass device='cpu' to check the "
            "CPU path.")
        return False

    from .. import nn
    from ..ops.loss import mse_loss
    from ..optimizer import SGD
    from ..parallel import env as _env
    from ..static import TrainStep

    model = nn.Linear(4, 3, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    step = TrainStep(model, SGD(learning_rate=0.1), mse_loss)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(0, 1, (8, 4)), dtype=torch.float32,
                     device=dev)
    y = torch.tensor(rng.normal(0, 1, (8, 3)), dtype=torch.float32,
                     device=dev)
    try:
        first = float(step(x, labels=y)["loss"])
        for _ in range(10):
            last = float(step(x, labels=y)["loss"])
    except Exception as e:  # noqa: BLE001 - the report is the result
        say(f"FAIL: train step raised: {e!r}")
        return False
    if not (np.isfinite(last) and last < first):
        say(f"FAIL: loss did not decrease ({first} -> {last})")
        return False
    say(f"single-device train step OK (loss {first:.4f} -> {last:.4f})")

    world = _env.get_world_size() if _env.is_initialized() else 1
    if world > 1:
        try:
            from ..parallel import ShardedTrainStep, data_parallel_mesh
            from ..parallel.mesh import P
            mesh = data_parallel_mesh()
            m2 = nn.Linear(4, 3, device=dev, generator=torch.Generator(
                device=dev).manual_seed(0))
            s2 = ShardedTrainStep(m2, SGD(learning_rate=0.1), mse_loss,
                                  mesh=mesh, batch_spec=P("dp"))
            n = mesh.shape["dp"] * 2
            reps = -(-n // len(x))  # ceil-divide: tile to >= n rows
            l0 = float(s2(x.repeat(reps, 1)[:n],
                          labels=y.repeat(reps, 1)[:n])["loss"])
            if not np.isfinite(l0):
                say(f"FAIL: sharded step produced non-finite loss "
                    f"({l0}): miswired collective or placement")
                return False
            say(f"{world}-process sharded step OK (loss {l0:.4f})")
        except Exception as e:  # noqa: BLE001 - the report is the result
            say(f"FAIL: sharded step over {world} processes raised: "
                f"{e!r}")
            return False
    say("paddle_tpu_torch is installed and working.")
    return True
