"""Hardware verification of the port, decoupled from any timing.

Counterpart of ``paddle_tpu.verify``. ``run_verification`` runs every
check and writes its own JSON artifact,
``paddle_tpu_torch/_build/VERIFY_CUDA.json`` (beside the built kernels;
never the JAX package's ``VERIFY_TPU.json``), so a run without timings
still leaves a record. Run it as ``python -m paddle_tpu_torch.verify
[artifact path]`` (exit 0 when every check passed).

Checks:

- ``validate_kernels()``: each hand-written CUDA kernel against its plain
  PyTorch version on the card at small shapes, forward and, where the
  kernel has one, backward: LayerNorm (its forward kernel under the
  autograd Function), single-query paged decode, the multi-query verify
  window, flash attention's forward with the dq/dK-dV backward (seq 256)
  and with the fused backward (seq 128), causal and not,
  ``flash_attention_with_lse`` (both cotangents), the fused softmax
  cross-entropy forward and its chunked backward (with ignored rows),
  and the Adam kernel's leaf and flat variants (bitwise). The flash and
  xent checks run each wrapper twice on the same card tensors, with its
  kernels and with their plain stand-ins (``PLAIN_KERNELS``).
- ``train_parity_10steps()``: 10 SGD steps of a 2-layer MLP through
  ``static.TrainStep`` (captured on the card) against a numpy
  re-derivation of the same steps.

Without a CUDA device the kernels cannot be checked: the artifact says
``ok: false`` with the reason "no CUDA device" and the entry point exits
non-zero. ``train_parity_10steps(device="cpu")`` still runs when asked
for directly. The timing checks live in ``chip_smoke.py``.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from typing import Dict, List, Optional

__all__ = ["validate_kernels", "train_parity_10steps", "kernels_source_hash",
           "default_artifact_path", "run_verification"]

_PKG = os.path.dirname(os.path.abspath(__file__))

# kernel against plain version, relative to the largest reference entry:
# fp32 arithmetic summed in another order (the tolerances chip_smoke.py
# holds the kernels to at their paths' shapes)
LN_TOL = 1e-5
PAGED_TOL = 1e-5
FLASH_TOL = 2e-5
FLASH_GRAD_TOL = 5e-5
XENT_TOL = 1e-4
# the numpy MLP re-derivation against the step's losses (the JAX
# package's bound)
PARITY_RTOL = 5e-3


def _log(msg: str) -> None:
    print(f"[verify] {msg}", file=sys.stderr, flush=True)


def _close(what: str, got, want, tol: float) -> float:
    """Raises unless ``max|got - want| <= tol * max(1, max|want|)``;
    returns that relative error."""
    err = float((got.double() - want.double()).abs().max())
    scale = max(1.0, float(want.double().abs().max()))
    if not err <= tol * scale:
        raise AssertionError(f"{what}: max abs err {err:.3e} > "
                             f"{tol:.1e} x {scale:.3g}")
    return err / scale


def _grads(torch, fn, leaves, cotangents):
    """``fn(*leaves)``'s outputs and the gradients of ``sum(out * cot)``
    over ``leaves`` (fresh leaves requiring grad)."""
    xs = [t.detach().clone().requires_grad_(True) for t in leaves]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    total = sum((o * c).sum() for o, c in zip(outs, cotangents))
    return [o.detach() for o in outs], list(torch.autograd.grad(total, xs))


def _check_pair(torch, what, kernel_fn, plain_fn, leaves, cotangents,
                tol, grad_tol) -> None:
    got, g_got = _grads(torch, kernel_fn, leaves, cotangents)
    want, g_want = _grads(torch, plain_fn, leaves, cotangents)
    for i, (a, b) in enumerate(zip(got, want)):
        _close(f"{what} output {i}", a, b, tol)
    for i, (a, b) in enumerate(zip(g_got, g_want)):
        _close(f"{what} gradient {i}", a, b, grad_tol)


def validate_kernels(device: str = "cuda") -> List[str]:
    """Every CUDA kernel against its plain version on ``device`` (a
    card); the list of failures (empty: all passed)."""
    import torch

    from .kernels import flash_attention as fa
    from .kernels import fused_adam as adam
    from .kernels import fused_softmax_xent as fx
    from .kernels import layer_norm as ln
    from .kernels import paged_attention as pa

    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    failures: List[str] = []

    def run(name: str, check) -> None:
        try:
            check()
            _log(f"kernel-validate {name}: OK")
        except Exception as e:  # noqa: BLE001 — recorded as a failure
            failures.append(f"{name}: {type(e).__name__}: {e}")
            _log(f"KERNEL VALIDATION FAILED: {failures[-1]}")

    def layer_norm():
        for rows, cols in ((64, 768), (64, 45)):
            x, w, b = rnd(rows, cols), rnd(cols, scale=0.1) + 1, \
                rnd(cols, scale=0.1)
            _check_pair(torch, f"layer_norm [{rows}, {cols}]",
                        lambda x, w, b: ln.layer_norm(x, w, b, 1e-5),
                        lambda x, w, b: ln.layer_norm_plain(x, w, b, 1e-5),
                        [x, w, b], [rnd(rows, cols)], LN_TOL, LN_TOL)

    def paged_inputs(qmax):
        b, h, d, bs, n_blocks = 4, 2, 64, 16, 64
        lens = torch.tensor([1, 17, 100, 255], dtype=torch.int32)
        max_blocks = -(-int(lens.max()) // bs)
        perm = torch.randperm(n_blocks, generator=gen)[:b * max_blocks]
        tables = perm.reshape(b, max_blocks).to(torch.int32)
        q = rnd(b, h, d) if qmax is None else rnd(b, qmax, h, d)
        return (q, rnd(n_blocks, bs, h, d), rnd(n_blocks, bs, h, d),
                tables.to(device), lens.to(device))

    def paged():
        q, kp, vp, tables, lens = paged_inputs(None)
        _close("paged_attention", pa.paged_attention(q, kp, vp, tables,
                                                     lens),
               pa.paged_attention_plain(q, kp, vp, tables, lens), PAGED_TOL)

    def paged_verify():
        q, kp, vp, tables, lens = paged_inputs(4)
        # a window no longer than its context (as the engine forms it)
        q_lens = torch.tensor([1, 4, 3, 2], dtype=torch.int32,
                              device=device)
        _close("paged_attention_multiquery",
               pa.paged_attention_multiquery(q, q_lens, kp, vp, tables,
                                             lens),
               pa.paged_attention_multiquery_plain(q, q_lens, kp, vp,
                                                   tables, lens),
               PAGED_TOL)

    def flash(seq, route):
        shape = (1, 2, seq, 64)
        if fa.backward_route(seq, seq, 64) != route:
            raise AssertionError(f"seq {seq} takes the "
                                 f"{fa.backward_route(seq, seq, 64)} "
                                 f"backward, not {route}")
        for causal in (False, True):
            _check_pair(
                torch, f"flash_attention seq {seq} causal={causal}",
                lambda q, k, v: fa.flash_attention(q, k, v, causal),
                lambda q, k, v: fa.flash_attention(
                    q, k, v, causal, kernels=fa.PLAIN_KERNELS),
                [rnd(*shape), rnd(*shape), rnd(*shape)], [rnd(*shape)],
                FLASH_TOL, FLASH_GRAD_TOL)

    def flash_lse():
        shape = (1, 2, 256, 64)
        _check_pair(
            torch, "flash_attention_with_lse",
            lambda q, k, v: fa.flash_attention_with_lse(q, k, v, True),
            lambda q, k, v: fa.flash_attention_with_lse(
                q, k, v, True, kernels=fa.PLAIN_KERNELS),
            [rnd(*shape), rnd(*shape), rnd(*shape)],
            [rnd(*shape), rnd(1, 2, 256)], FLASH_TOL, FLASH_GRAD_TOL)

    def xent():
        n, hd, v = 96, 128, 3000
        lab = torch.randint(0, v, (n,), generator=gen)
        lab[::7] = -100
        lab = lab.to(device)
        _check_pair(
            torch, "fused_softmax_xent",
            lambda h, w, b: fx.fused_linear_xent(h, w, b, lab),
            lambda h, w, b: fx.fused_linear_xent(h, w, b, lab,
                                                 kernels=fx.PLAIN_KERNELS),
            [rnd(n, hd), rnd(v, hd, scale=0.05), rnd(v, scale=0.05)],
            [rnd(n)], XENT_TOL, XENT_TOL)

    def adam_variant(variant):
        shapes = [(768, 768), (768,), (1031,), (3, 5)]
        lr_c = torch.tensor([2.34e-5], dtype=torch.float32, device=device)
        ok = torch.tensor([True], device=device)
        leaves = [(rnd(*s), rnd(*s, scale=1e-3), rnd(*s, scale=1e-4),
                   rnd(*s, scale=1e-3) ** 2) for s in shapes]
        decay = [len(s) > 1 for s in shapes]
        outs = []
        for impl in (adam.adam_multi, adam.adam_multi_plain):
            p, m, v = ([leaf[i].clone() for leaf in leaves]
                       for i in (0, 2, 3))
            impl(p, [leaf[1] for leaf in leaves], m, v, decay, lr_c, 0.9,
                 0.999, 1e-8, 1e-6, ok, variant, weight_decay=0.01
                 if variant == "flat" else 0.0)
            outs.append(p + m + v)
        bad = [i for i, (a, b) in enumerate(zip(*outs))
               if not torch.equal(a, b)]
        if bad:
            raise AssertionError(f"adam {variant}: tensors {bad} differ "
                                 f"from the plain version (bitwise)")

    run("layer_norm", layer_norm)
    run("paged_attention", paged)
    run("paged_attention_multiquery", paged_verify)
    run("flash_attention_split_bwd", lambda: flash(256, "split"))
    run("flash_attention_fused_bwd", lambda: flash(128, "fused"))
    run("flash_attention_with_lse", flash_lse)
    run("fused_softmax_xent", xent)
    run("adam_leaf", lambda: adam_variant("leaf"))
    run("adam_flat", lambda: adam_variant("flat"))
    return failures


def train_parity_10steps(device: Optional[str] = None) -> Dict:
    """10 SGD steps (lr 0.1, MSE) of ``Sequential(Linear(8, 32), Tanh,
    Linear(32, 4))`` through ``TrainStep`` on ``device`` (None: the card)
    against a numpy re-derivation; ``{"ok", "max_rel_err", "losses"}``."""
    import numpy as np
    import torch

    from . import nn
    from .core.place import resolve_device
    from .optimizer import SGD
    from .static import TrainStep

    dev = resolve_device(device)
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (16, 8)).astype(np.float32)
    t = rng.normal(0, 1, (16, 4)).astype(np.float32)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = nn.Sequential(nn.Linear(8, 32, device=dev, generator=gen),
                          nn.Tanh(),
                          nn.Linear(32, 4, device=dev, generator=gen))
    sd = {k: v.detach().cpu().numpy().copy()
          for k, v in model.state_dict().items()}
    w1, b1, w2, b2 = (sd[k] for k in ("0.weight", "0.bias", "2.weight",
                                      "2.bias"))
    lr = 0.1
    step = TrainStep(model, SGD(learning_rate=lr),
                     lambda out, y: ((out - y) ** 2).mean())
    xd, td = torch.from_numpy(x).to(dev), torch.from_numpy(t).to(dev)
    losses_fw, losses_np = [], []
    for _ in range(10):
        losses_fw.append(float(step(xd, labels=td)["loss"]))
        a = np.tanh(x @ w1 + b1)
        diff = a @ w2 + b2 - t
        losses_np.append(float((diff ** 2).mean()))
        go = 2.0 * diff / diff.size
        gh = (go @ w2.T) * (1 - a ** 2)
        w2 = w2 - lr * (a.T @ go)
        b2 = b2 - lr * go.sum(0)
        w1 = w1 - lr * (x.T @ gh)
        b1 = b1 - lr * gh.sum(0)
    rel = max(abs(a - b) / max(abs(b), 1e-8)
              for a, b in zip(losses_fw, losses_np))
    ok = rel < PARITY_RTOL and losses_fw[-1] < losses_fw[0]
    _log(f"train-parity 10 steps on {dev}: max_rel_err={rel:.2e} "
         f"loss {losses_fw[0]:.4f}->{losses_fw[-1]:.4f} "
         f"{'OK' if ok else 'FAILED'}")
    return {"ok": bool(ok), "max_rel_err": rel, "device": str(dev),
            "losses": [round(v, 6) for v in losses_fw]}


def kernels_source_hash() -> str:
    """A hash of the kernels' sources (``csrc/*.cu``, ``*.cuh`` and
    ``kernels/*.py``), stamped into the artifact: a verdict holds for
    these bytes only."""
    h = hashlib.sha256()
    for sub, exts in (("csrc", (".cu", ".cuh")), ("kernels", (".py",))):
        d = os.path.join(_PKG, sub)
        for name in sorted(os.listdir(d)):
            if name.endswith(exts):
                with open(os.path.join(d, name), "rb") as f:
                    h.update(name.encode())
                    h.update(f.read())
    return h.hexdigest()[:16]


def default_artifact_path() -> str:
    return os.path.join(_PKG, "_build", "VERIFY_CUDA.json")


def _write(result: Dict, artifact_path: Optional[str]) -> None:
    if not artifact_path:
        return
    os.makedirs(os.path.dirname(os.path.abspath(artifact_path)),
                exist_ok=True)
    with open(artifact_path, "w") as f:
        json.dump(result, f, indent=1)
    _log(f"wrote {artifact_path} (ok={result['ok']})")


def run_verification(artifact_path: Optional[str] = None) -> Dict:
    """Runs every check and writes the artifact (``artifact_path``, None
    for :func:`default_artifact_path`, "" for none); returns the result,
    ``result["ok"]`` the verdict."""
    import torch

    from . import kernels

    if artifact_path is None:
        artifact_path = default_artifact_path()
    if not torch.cuda.is_available():
        result = {"backend": "cpu", "on_accel": False, "kernels_ok": False,
                  "kernel_failures": ["no CUDA device: the kernels were "
                                      "not checked"],
                  "train_parity": {"ok": False, "skipped": "no CUDA device"},
                  "reason": "no CUDA device", "ok": False}
        _write(result, artifact_path)
        return result
    t0 = time.perf_counter()
    before = kernels.launch_counts()
    failures = validate_kernels()
    after = kernels.launch_counts()
    parity = train_parity_10steps()
    result = {
        "backend": "cuda", "device": torch.cuda.get_device_name(0),
        "kernel_hash": kernels_source_hash(), "on_accel": True,
        "kernels_ok": not failures, "kernel_failures": failures,
        "kernel_launches": {k: after[k] - before[k] for k in after},
        "train_parity": parity,
        "ok": not failures and parity["ok"],
        "elapsed_s": round(time.perf_counter() - t0, 1)}
    _write(result, artifact_path)
    return result


if __name__ == "__main__":
    # python -m paddle_tpu_torch.verify [artifact path]
    sys.exit(0 if run_verification(
        sys.argv[1] if len(sys.argv) > 1 else None)["ok"] else 1)
