"""Which cuDNN kernel computes LeNet's convolution weight gradients on the
card, and how far each choice lands from float64.

For LeNet's two convolutions (one input channel 5x5 pad 2 at 28 px, six
channels 5x5 at 14 px; batch 16; an output gradient as sparse as ReLU and
a 2x2 max pool leave it) and for the port's ``models.LeNet`` whole, the
fp32 weight gradient on the card under each cuDNN setting (default,
deterministic, benchmark, both, TF32 allowed, cuDNN off) against a
float64 CPU run: the largest gap over the largest float64 entry, beside
the CPU's fp32 gap, and the names of the device kernels each setting
launched (torch.profiler). TF32 is off except where the setting allows
it. Needs one card:

    chiprun --timeout 300 -- python3 tools/cudnn_wgrad_probe.py
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

SHAPES = {"conv1": ((16, 1, 28, 28), (6, 1, 5, 5), 2),
          "conv2": ((16, 6, 14, 14), (16, 6, 5, 5), 0)}
MODES = {"default": {}, "deterministic": {"deterministic": True},
         "benchmark": {"benchmark": True},
         "benchmark_deterministic": {"benchmark": True,
                                     "deterministic": True},
         "tf32": {"allow_tf32": True}, "no_cudnn": {"enabled": False}}


def gap(g, ref) -> float:
    return float((g.cpu().double() - ref).abs().max() / ref.abs().max())


def with_mode(mode: str, fn):
    b = torch.backends.cudnn
    old = {k: getattr(b, k) for k in ("deterministic", "benchmark",
                                      "allow_tf32", "enabled")}
    for k, v in MODES[mode].items():
        setattr(b, k, v)
    try:
        return fn()
    finally:
        for k, v in old.items():
            setattr(b, k, v)


def profiled(fn):
    """``fn()`` once to warm up, then under the profiler: (its result,
    the device kernels' names)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = sorted({e.name.split("(")[0][:100] for e in prof.events()
                    if e.device_type.name == "CUDA"
                    and not e.name.startswith("Memcpy")})
    return out, names


def conv_rows(rng) -> dict:
    out = {}
    for name, (xs, ws, pad) in SHAPES.items():
        x = torch.from_numpy(rng.standard_normal(xs, dtype=np.float32))
        w = torch.from_numpy(rng.standard_normal(ws, dtype=np.float32) * 0.2)
        ho = xs[2] + 2 * pad - ws[2] + 1
        dy = torch.from_numpy(rng.standard_normal(
            (xs[0], ws[0], ho, ho), dtype=np.float32))
        dy = dy * torch.from_numpy(rng.random(dy.shape) < 0.25)
        ref = torch.nn.grad.conv2d_weight(x.double(), ws, dy.double(),
                                          padding=pad)

        def wgrad(dev):
            ww = w.to(dev).requires_grad_(True)
            y = F.conv2d(x.to(dev), ww, padding=pad)
            return torch.autograd.grad(y, ww, dy.to(dev))[0]

        row = {"cpu_fp32": gap(wgrad("cpu"), ref)}
        for mode in MODES:
            g, names = with_mode(mode, lambda: profiled(
                lambda: wgrad("cuda")))
            row[mode] = {"gap": gap(g, ref), "kernels": names}
        out[name] = row
    return out


def lenet_rows() -> dict:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from paddle_tpu_torch.models import LeNet
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (16, 1, 28, 28), dtype=np.float32))
    lab = torch.arange(16) % 10
    cpu = LeNet(device="cpu", seed=0).double()
    F.cross_entropy(cpu(x.double()), lab).backward()
    ref = {n: p.grad.clone() for n, p in cpu.named_parameters()}
    state = {k: v.float().cuda() for k, v in cpu.state_dict().items()}

    def run():
        net = LeNet(device="cuda", seed=0)
        net.load_state_dict(state)
        F.cross_entropy(net(x.cuda()), lab.cuda()).backward()
        return {n: gap(p.grad, ref[n]) for n, p in net.named_parameters()
                if n.startswith("features")}

    return {mode: with_mode(mode, run) for mode in MODES}


def main() -> int:
    if not torch.cuda.is_available():
        print("cudnn_wgrad_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "cudnn": torch.backends.cudnn.version()}))
    print(json.dumps({"convolutions": conv_rows(np.random.default_rng(0)),
                      "lenet": lenet_rows()}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
