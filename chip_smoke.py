#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the GPU.

Run from the repository root on a machine with one NVIDIA H100 (or
another Hopper card) and the CUDA toolkit::

    python3 chip_smoke.py

It imports only ``paddle_tpu_torch`` (never JAX or ``paddle_tpu``) and,
in order:

1. requires a CUDA device (exits 2 otherwise), turns TF32 off and prints
   the card's name and power limit as ``nvidia-smi`` reports them;
2. builds every CUDA kernel of the serving path from
   ``paddle_tpu_torch/csrc`` with ``nvcc`` for ``sm_90a`` (one process
   per source, all at once) and prints the build time and ptxas report;
3. holds each kernel against its plain PyTorch version on the card at
   the shapes the serving path gives it, within ``TOL``, and times the
   kernel, the plain version, one PyTorch library call computing the
   same function (a yardstick the port never calls) and the card's
   bound for the work;
4. serves 16 requests through ``LLMEngine`` at GPT-2-small width (random
   weights from a seed; half of the requests join mid-decode) and holds
   every token against the port's dense ``generate()``;
5. repeats four requests with speculative decoding (self-draft) and
   requires the same tokens and an accept rate of 1.0; then serves those
   four at temperature 0.8, plain and speculative, and requires the
   same sampled tokens and an accept rate of 1.0 again;
6. prints one ``{"kernels": [...]}`` line with each kernel's launches,
   error and times, and last one ``{"ok": true, "device": {...}}`` line.
   Launch counts are set to 0 just before each engine run and read just
   after it; the serving run must launch layer norm and paged decode
   attention, the speculative run layer norm and multi-query attention.

Any failure raises, so the exit code is non-zero and no result line is
printed. Every number and message also goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# fp32 kernel vs plain PyTorch: the same arithmetic summed in another
# order; observed differences are ~1e-6 on unit-scale inputs
TOL = 1e-5
# a token that differs from dense generate() is accepted only where the
# dense top-two logits are closer than this (fp32 summation-order noise
# can flip such a near-tie)
NEAR_TIE = 1e-4
SEED = 0
# the sampled runs' temperature
TEMPERATURE = 0.8
# the kernels each path of the main path must launch: plain decode, and
# speculative decode (a self-draft's dense forwards plus the verify)
PATH_KERNELS = {"serving": ("layer_norm", "paged_attention"),
                "speculative": ("layer_norm", "paged_attention_multiquery")}

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and fp32 outside the
# tensor cores, the unit these fp32 kernels run on
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

GPT2_SMALL = dict(vocab_size=50257, hidden_size=768, num_layers=12,
                  num_heads=12, intermediate_size=3072,
                  max_position_embeddings=1024, layer_norm_epsilon=1e-5)

REPORT: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)
    REPORT.setdefault("log", []).append(msg)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Device time of one call, averaged over ``iters`` calls, with the
    50 MB L2 flushed before each (the serving path meets every pool and
    activation cold: twelve layers' pools pass between two calls). The
    1 GiB flush also keeps the card busy for ~0.3 ms while the host
    enqueues the call, so a short kernel's time is not the host's."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(2 ** 28, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, iters: int = 30) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_inputs(torch, rng, b, qmax, h, d, bs, lens, qlens=None):
    """Ragged block tables over a shuffled pool, garbage past each
    sequence's blocks (negative and out-of-pool entries included)."""
    nb = [-(-n // bs) for n in lens]
    n_blocks = sum(nb) + 8
    maxb = max(nb)
    perm = rng.permutation(n_blocks)
    tbl = rng.integers(-5, n_blocks + 5, size=(b, maxb)).astype(np.int32)
    off = 0
    for i, k in enumerate(nb):
        tbl[i, :k] = perm[off:off + k]
        off += k
    shape_q = (b, h, d) if qmax is None else (b, qmax, h, d)
    dev = dict(device="cuda")
    t = {
        "q": torch.from_numpy(rng.standard_normal(shape_q,
                                                  np.float32)).cuda(),
        "k": torch.from_numpy(rng.standard_normal(
            (n_blocks, bs, h, d), np.float32)).cuda(),
        "v": torch.from_numpy(rng.standard_normal(
            (n_blocks, bs, h, d), np.float32)).cuda(),
        "tbl": torch.tensor(tbl, dtype=torch.int32, **dev),
        "lens": torch.tensor(lens, dtype=torch.int32, **dev),
    }
    if qlens is not None:
        t["qlens"] = torch.tensor(qlens, dtype=torch.int32, **dev)
    return t, sum(nb)


def sdpa_inputs(torch, t, bs, qmax):
    """Dense gathered K/V [B, H, T, D] and the boolean mask that give the
    same function through scaled_dot_product_attention."""
    b, maxb = t["tbl"].shape
    idx = t["tbl"].long().clamp(0, t["k"].shape[0] - 1)
    h, d = t["k"].shape[2:]
    kd = t["k"][idx].reshape(b, maxb * bs, h, d).transpose(1, 2).contiguous()
    vd = t["v"][idx].reshape(b, maxb * bs, h, d).transpose(1, 2).contiguous()
    lens = t["lens"].long()
    kpos = torch.arange(maxb * bs, device="cuda")
    if qmax is None:
        q = t["q"][:, :, None]
        mask = (kpos[None, :] < lens[:, None])[:, None, None, :]
    else:
        q = t["q"].transpose(1, 2).contiguous()
        qlens = t["qlens"].long()
        qpos = (lens - qlens)[:, None] + torch.arange(qmax, device="cuda")
        mask = ((kpos[None, None, :] <= qpos[:, :, None])
                & (kpos[None, None, :] < lens[:, None, None]))[:, None]
    return q, kd, vd, mask


def check_kernels(torch, timer):
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.kernels import paged_attention as pa
    F = torch.nn.functional
    rng = np.random.default_rng(SEED)
    results = {}

    # layer norm at the serving shapes: decode [B, 768], prefill [T, 768]
    err = 0.0
    per_shape = {}
    for rows in (8, 16, 512):
        cols = 768
        x = torch.from_numpy(rng.standard_normal((rows, cols),
                                                 np.float32)).cuda()
        w = torch.from_numpy(1 + 0.1 * rng.standard_normal(
            cols, np.float32)).cuda()
        b = torch.from_numpy(0.1 * rng.standard_normal(
            cols, np.float32)).cuda()
        got = ln.layer_norm(x, w, b, 1e-5)
        want = ln.layer_norm_plain(x, w, b, 1e-5)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        err = max(err, e)
        bms, by = bound((2 * rows * cols + 2 * cols) * 4, 8 * rows * cols)
        per_shape[f"[{rows},{cols}]"] = {
            "max_abs_err": e,
            "ms": timer(lambda: ln.layer_norm(x, w, b, 1e-5)),
            "plain_ms": timer(lambda: ln.layer_norm_plain(x, w, b, 1e-5)),
            "library_ms": timer(lambda: F.layer_norm(x, (cols,), w, b,
                                                     1e-5)),
            "bound_ms": bms, "bound_by": by}
        log(f"layer_norm [{rows},{cols}]: {json.dumps(per_shape[f'[{rows},{cols}]'])}")
    if not err <= TOL:
        raise AssertionError(f"layer_norm kernel differs from plain by "
                             f"{err} > {TOL}")
    results["layer_norm"] = dict(per_shape["[16,768]"], max_abs_err=err,
                                 shape="[16,768]",
                                 shapes=per_shape)

    # single-query paged decode: B=16, 12 x 64 heads, bs 16, ragged lens
    # from 1 to 1024 with block remainders
    h, d, bs = 12, 64, 16
    lens = [1, 17, 64, 100, 128, 255, 256, 333, 400, 511, 512, 640, 777,
            900, 1000, 1024]
    t, used_blocks = paged_inputs(torch, rng, len(lens), None, h, d, bs,
                                  lens)
    args = (t["q"], t["k"], t["v"], t["tbl"], t["lens"])
    got = pa.paged_attention(*args)
    want = pa.paged_attention_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not (torch.isfinite(got).all() and err <= TOL):
        raise AssertionError(f"paged_attention kernel differs from plain "
                             f"by {err} > {TOL}")
    ntok = sum(lens)
    b = len(lens)
    bms, by = bound(4 * (2 * b * h * d + 2 * ntok * h * d + used_blocks + b),
                    4 * ntok * h * d)
    q, kd, vd, mask = sdpa_inputs(torch, t, bs, None)
    lib_err = float((F.scaled_dot_product_attention(
        q, kd, vd, attn_mask=mask)[:, :, 0] - want).abs().max())
    results["paged_attention"] = {
        "max_abs_err": err, "shape": f"B={b} H={h} D={d} bs={bs} "
                                     f"lens 1..1024 (sum {ntok})",
        "ms": timer(lambda: pa.paged_attention(*args)),
        "plain_ms": timer(lambda: pa.paged_attention_plain(*args)),
        "library_ms": timer(lambda: F.scaled_dot_product_attention(
            q, kd, vd, attn_mask=mask)),
        "library_max_abs_err": lib_err,
        "bound_ms": bms, "bound_by": by}
    log(f"paged_attention: {json.dumps(results['paged_attention'])}")

    # multi-query verify window: Qmax = 4, ragged q_lens
    # a window never exceeds its context (ctx counts the window)
    qlens = [min(q, n) for q, n in zip([4, 1, 3, 2] * 4, lens)]
    t, used_blocks = paged_inputs(torch, rng, len(lens), 4, h, d, bs, lens,
                                  qlens)
    args = (t["q"], t["qlens"], t["k"], t["v"], t["tbl"], t["lens"])
    got = pa.paged_attention_multiquery(*args)
    want = pa.paged_attention_multiquery_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not (torch.isfinite(got).all() and err <= TOL):
        raise AssertionError(f"paged_attention_multiquery kernel differs "
                             f"from plain by {err} > {TOL}")
    # Qmax == 1 must be bit-identical to the single-query kernel
    one = (t["q"][:, :1].contiguous(), torch.ones_like(t["qlens"]),
           t["k"], t["v"], t["tbl"], t["lens"])
    if not torch.equal(pa.paged_attention_multiquery(*one)[:, 0],
                       pa.paged_attention(one[0][:, 0].contiguous(),
                                          *one[2:])):
        raise AssertionError("multi-query Qmax == 1 is not bit-identical "
                             "to the single-query kernel")
    rows_keys = sum(min(n - ql + qi + 1, n) if qi < ql else n
                    for n, ql in zip(lens, qlens) for qi in range(4))
    bms, by = bound(4 * (2 * b * 4 * h * d + 2 * ntok * h * d + used_blocks
                         + 2 * b), 4 * rows_keys * h * d)
    q, kd, vd, mask = sdpa_inputs(torch, t, bs, 4)
    results["paged_attention_multiquery"] = {
        "max_abs_err": err, "shape": f"B={b} Qmax=4 H={h} D={d} bs={bs} "
                                     f"lens 1..1024",
        "qmax1_bitwise": True,
        "ms": timer(lambda: pa.paged_attention_multiquery(*args)),
        "plain_ms": timer(lambda: pa.paged_attention_multiquery_plain(
            *args)),
        "library_ms": timer(lambda: F.scaled_dot_product_attention(
            q, kd, vd, attn_mask=mask)),
        "bound_ms": bms, "bound_by": by}
    log(f"paged_attention_multiquery: "
        f"{json.dumps(results['paged_attention_multiquery'])}")
    return results


# ---------------------------------------------------------------------------
# phases 4-5: serving through the engine
# ---------------------------------------------------------------------------

def build_model(torch, config: dict, device: str):
    """GPT at ``config`` width with GPT-2's N(0, 0.02) weights from SEED
    (zero biases, unit LayerNorm scale)."""
    from paddle_tpu_torch.models import GPTConfig, GPTLanguageModel
    model = GPTLanguageModel(GPTConfig(**config), device=device, seed=SEED)
    gen = torch.Generator(device=device).manual_seed(SEED)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 2:
                p.normal_(0.0, 0.02, generator=gen)
    return model


def make_prompts(n: int, lo: int, hi: int, vocab: int):
    rng = np.random.default_rng(SEED + 1)
    lengths = np.linspace(lo, hi, n).astype(int)
    rng.shuffle(lengths)
    return [rng.integers(0, vocab, size=int(k)).tolist() for k in lengths]


def serve(torch, engine, prompts, max_new: int, late: int = 0,
          late_after_steps: int = 3, temperature: float = 0.0):
    """Add all but the last ``late`` prompts, step ``late_after_steps``
    times, add the rest (they join mid-decode) and step to quiescence.
    Request i samples with seed SEED + i. Returns (tokens per prompt,
    stats)."""
    sync = torch.cuda.synchronize if engine.device.type == "cuda" \
        else (lambda: None)
    out, added, first = {}, {}, {}
    order = []
    step_ms, decode_step_ms = [], []

    def add(p):
        sid = engine.add_request(p, max_new_tokens=max_new,
                                 temperature=temperature,
                                 seed=SEED + len(order))
        added[sid] = time.perf_counter()
        order.append(sid)

    sync()
    t0 = time.perf_counter()
    for p in prompts[:len(prompts) - late]:
        add(p)
    steps = 0
    while engine.active() or len(order) < len(prompts):
        if steps == late_after_steps:
            for p in prompts[len(prompts) - late:]:
                add(p)
        decode_only = not engine.scheduler.waiting and all(
            s.prefill_done for s in engine.scheduler.running)
        ts = time.perf_counter()
        events = engine.step()
        sync()
        now = time.perf_counter()
        step_ms.append((now - ts) * 1e3)
        if decode_only and engine.scheduler.running:
            decode_step_ms.append((now - ts) * 1e3)
        steps += 1
        if steps > 10_000:
            raise AssertionError("engine did not quiesce")
        for ev in events:
            if ev["type"] == "error":
                raise AssertionError(f"engine error event: {ev}")
            if ev["type"] == "token":
                out.setdefault(ev["seq_id"], []).append(ev["token"])
                first.setdefault(ev["seq_id"], now)
    wall = time.perf_counter() - t0
    tokens = [out.get(sid, []) for sid in order]
    ttft = [(first[sid] - added[sid]) * 1e3 for sid in order]
    stats = {"requests": len(prompts), "steps": steps,
             "tokens": sum(len(t) for t in tokens), "wall_s": wall,
             "tokens_per_s": sum(len(t) for t in tokens) / wall,
             "ttft_ms_p50": float(np.median(ttft)),
             "step_ms_p50": float(np.median(step_ms)),
             "decode_step_ms_p50": float(np.median(decode_step_ms))
             if decode_step_ms else None}
    return tokens, stats


def top2_gap(torch, model, ids, temperature: float = 0.0,
             key=None) -> float:
    """Top-two gap, in logit units, of what the sampler ranks for the
    token after ``ids`` on the dense forward: the logits at temperature
    0, else logits / T plus the noise of position ``key``, times T."""
    from paddle_tpu_torch.serving_llm.engine import sampling_noise
    with torch.no_grad():
        scores = model(torch.tensor([ids], device=model.device))[0, -1]
    scores = scores.float()
    if temperature > 0.0:
        scores = (scores / temperature + sampling_noise(
            [key], scores.shape[-1], model.device)[0]) * temperature
    top = torch.topk(scores, 2).values
    return float(top[0] - top[1])


def hold_against(torch, model, prompts, got, want, what: str,
                 temperature: float = 0.0):
    """Token-for-token parity with a near-tie escape: at the first
    mismatch the top-two scores the sampler ranks on the dense forward
    must differ by < NEAR_TIE logits (the rest of that sequence then
    follows another context and is not compared). Request i sampled
    with seed SEED + i, as ``serve`` sets. Returns the accepted
    near-ties."""
    ties = []
    for i, (p, g, w) in enumerate(zip(prompts, got, want)):
        if len(g) != len(w):
            raise AssertionError(f"{what}: request {i} has {len(g)} "
                                 f"tokens, reference {len(w)}")
        mism = [j for j in range(len(w)) if g[j] != w[j]]
        if not mism:
            continue
        j = mism[0]
        gap = top2_gap(torch, model, p + w[:j], temperature, (SEED + i, j))
        if gap >= NEAR_TIE:
            raise AssertionError(
                f"{what}: request {i} diverges at token {j} "
                f"({g[j]} vs {w[j]}) where the dense top-two gap is "
                f"{gap} >= {NEAR_TIE}")
        ties.append({"request": i, "token": j, "gap": gap})
        log(f"{what}: near-tie accepted at request {i} token {j} "
            f"(gap {gap})")
    return ties


def dense_reference(torch, model, prompts, max_new: int):
    return [model.generate(torch.tensor([p], device=model.device),
                           max_new_tokens=max_new)[0].tolist()
            for p in prompts]


def run_serving(torch, config: dict, device: str, n_req: int, lo: int,
                hi: int, max_new: int, pool_blocks: int, n_spec: int):
    """Phases 4-5 (any device, so it can be rehearsed on the CPU at a
    small config). Returns (report, launch counts of each engine run)."""
    from paddle_tpu_torch import kernels, set_flags
    from paddle_tpu_torch.serving_llm import LLMEngine
    model = build_model(torch, config, device)
    prompts = make_prompts(n_req, lo, hi, config["vocab_size"])
    counts = {}

    def run(name, prompts, k=0, **serve_kw):
        """One engine run with every launch count set to 0 just before
        it and read just after; the pool must drain clean."""
        set_flags({"speculative_k": k})
        try:
            eng = LLMEngine(model, block_size=16, pool_blocks=pool_blocks,
                            max_decode_batch=16,
                            draft_model=model if k else None,
                            device=device)
            kernels.reset_launch_counts()
            tokens, stats = serve(torch, eng, prompts, max_new, **serve_kw)
            counts[name] = kernels.launch_counts()
        finally:
            set_flags({"speculative_k": 0})
        if eng.allocator.num_used != 0:
            raise AssertionError(f"{name}: {eng.allocator.num_used} KV "
                                 f"blocks leaked")
        eng.allocator.check()
        for tk in tokens:
            if len(tk) != max_new or not all(0 <= x < config["vocab_size"]
                                             for x in tk):
                raise AssertionError(f"{name}: output has the wrong shape")
        if k:
            stats.update(proposed=eng.spec_proposed_total,
                         accepted=eng.spec_accepted_total,
                         accept_rate=eng.spec_accepted_total
                         / max(1, eng.spec_proposed_total))
        log(f"{name}: {json.dumps(stats)}")
        return tokens, stats

    few = prompts[:n_spec]
    tokens, stats = run("serving", prompts, late=n_req // 2)
    spec_tokens, spec_stats = run("speculative", few, k=3)
    # sampling at temperature > 0, plain and speculative, same seeds
    hot_tokens, hot_stats = run("sampled", few, temperature=TEMPERATURE)
    hot_spec_tokens, hot_spec_stats = run("sampled_speculative", few, k=3,
                                          temperature=TEMPERATURE)

    dense = dense_reference(torch, model, prompts, max_new)
    ties = hold_against(torch, model, prompts, tokens, dense,
                        "engine vs dense generate")
    spec_ties = hold_against(torch, model, few, spec_tokens,
                             tokens[:n_spec], "speculative vs plain")
    spec_ties += hold_against(torch, model, few, hot_spec_tokens,
                              hot_tokens, "sampled speculative vs plain",
                              temperature=TEMPERATURE)
    for st in (spec_stats, hot_spec_stats):
        if st["proposed"] == 0 or (st["accept_rate"] != 1.0
                                   and not spec_ties):
            raise AssertionError(f"self-draft accept rate "
                                 f"{st['accept_rate']} != 1.0")
    with torch.no_grad():
        logits = model(torch.tensor([prompts[0][:8]], device=device))
    if tuple(logits.shape) != (1, 8, config["vocab_size"]) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError("dense logits not finite or misshapen")
    report = {"serving": stats, "speculative": spec_stats,
              "sampled": hot_stats, "sampled_speculative": hot_spec_stats,
              "near_ties": ties + spec_ties}
    if device == "cuda":
        report["decode_profile"] = profile_decode(torch, model, prompts,
                                                  pool_blocks)
        log(f"decode profile: {json.dumps(report['decode_profile'])}")
    return report, counts


def profile_decode(torch, model, prompts, pool_blocks: int,
                   steps: int = 8) -> dict:
    """Where a decode step's time goes: torch.profiler over ``steps``
    decode steps of a full batch (all prompts prefilled first), device
    time by kernel and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.serving_llm import LLMEngine
    eng = LLMEngine(model, block_size=16, pool_blocks=pool_blocks,
                    max_decode_batch=16, device=model.device)
    for p in prompts:
        eng.add_request(p, max_new_tokens=steps + 4)
    while eng.scheduler.waiting or not all(
            s.prefill_done for s in eng.scheduler.running):
        eng.step()
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = []
    for evt in prof.key_averages():
        # device-side events only: a CPU op's device time repeats its
        # kernels' time
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            rows.append([us / 1e3 / steps, evt.count / steps, evt.key[:90]])
    rows.sort(reverse=True)
    while eng.active():
        eng.step()
    device_ms = sum(r[0] for r in rows)
    return {"steps": steps, "batch": len(prompts),
            "wall_ms_per_step": wall_ms,
            "device_ms_per_step": device_ms if rows else None,
            "device_busy_share": device_ms / wall_ms if rows else None,
            "top_ms_per_step_launches_name": rows[:12]}


def kernel_line(results: dict, counts: dict) -> dict:
    """The kernels JSON line. ``launches`` is the count from the run of
    the kernel's own path; ``launches_by_path`` gives both paths'."""
    meta = {
        "layer_norm": ("serving", "paddle_tpu_torch/csrc/layer_norm.cu",
                       "paddle_tpu/kernels/layer_norm.py:29"),
        "paged_attention": ("serving",
                            "paddle_tpu_torch/csrc/paged_attention.cu",
                            "paddle_tpu/kernels/paged_attention.py:55"),
        "paged_attention_multiquery": (
            "speculative", "paddle_tpu_torch/csrc/paged_attention.cu",
            "paddle_tpu/kernels/paged_attention.py:185"),
    }
    for path, names in PATH_KERNELS.items():
        for name in names:
            if counts[path][name] <= 0:
                raise AssertionError(f"kernel {name} was never launched "
                                     f"on the {path} path")
    line = []
    for name, (path, src, replaces) in meta.items():
        r = results[name]
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "path": path,
                     "launches": counts[path][name],
                     "launches_by_path": {p: counts[p][name]
                                          for p in PATH_KERNELS},
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "shape": r["shape"]})
    return {"kernels": line}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    from paddle_tpu_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for name, text in sorted(_build.build_logs.items()):
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln or "error" in ln:
                log(f"ptxas {name}: {ln.strip()}")

    timer = Timer(torch)
    results = check_kernels(torch, timer)

    serving, counts = run_serving(torch, GPT2_SMALL, "cuda", n_req=16,
                                  lo=16, hi=512, max_new=32,
                                  pool_blocks=1024, n_spec=4)
    log(f"launches per engine run: {json.dumps(counts)}")
    line = kernel_line(results, counts)
    REPORT.update(card=card, kernels=results, launches=counts,
                  total_s=time.perf_counter() - t_start, **serving)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(REPORT, f, indent=1)
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
