"""The rank processes of the distributed checks.

Counterpart of the JAX package's ``tests/dist_trainer.py``: the bodies that
several ranks run, one process each, for the CPU tests (four Gloo ranks)
and for ``chip_smoke.py`` (four Gloo ranks sharing the card). It imports
the port only. A job is started with :func:`run_job`, which writes the
inputs to ``<workdir>/in.npz``, starts the ranks through
``distributed.launch.launch_procs`` (so the control plane is on the path)
with a FileStore under ``workdir`` and a timeout, and returns each rank's
``<workdir>/rank<r>.npz``. A rank runs::

    python -m paddle_tpu_torch.testing.dist_worker <job> <workdir>

with one thread (``OMP_NUM_THREADS=1``, ``torch.set_num_threads(1)``:
four ranks of several test workers share the host's cores), its output
in ``<workdir>/rank<r>.log``. ``PT_WORKER_DEVICE`` (``cpu`` default,
``cuda``) is where the tensors live; ``PT_DIST_BACKEND`` the backend.

The jobs (``JOBS``): ``collective`` (every collective of
``parallel.collective``, with the gradients of the differentiable ones),
``train`` (``ShardedTrainStep`` over :data:`SHARDED_CASES` and
:data:`BERT_CASES`, BatchNorm and
SyncBatchNorm on a small ResNet, ``sync_batch_norm`` itself,
``DataParallel``, ``Model.prepare(mesh=).fit``, the straggler detector),
``long_context`` (ring and Ulysses attention, forward and gradients),
``gshuffle`` (``InMemoryDataset.global_shuffle`` over the control plane)
and ``chip`` (``chip_smoke.py``'s four ranks on one card: ring and Ulysses
attention at BERT-base heads, a 2-layer BERT-base at dp 4 and dp 2 x mp 2,
the straggler drill).
Each case's configuration lives here, so a test builds the JAX side from
the same description.
"""

from __future__ import annotations

import os
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

# the JAX-side description of each sharded-step case: mesh axes, ZeRO
# stage, placement rule, loss, AMP
SHARDED_CASES: Dict[str, Dict[str, Any]] = {
    "zero0": dict(axes={"dp": 4}, zero=0),
    "zero1": dict(axes={"dp": 4}, zero=1),
    "zero3": dict(axes={"dp": 4}, zero=3),
    "tp_rule": dict(axes={"dp": 2, "mp": 2}, rule="test_parallel"),
    "megatron": dict(axes={"dp": 2, "mp": 2}, rule="megatron", zero=1),
    "ignore": dict(axes={"dp": 4}, ignore=True),
    "scaler": dict(axes={"dp": 4}, scaler=True),
    "amp": dict(axes={"dp": 4}, amp="bfloat16"),
    "kwargs": dict(axes={"dp": 4}, kwargs=True),
    # a tail batch of 6 rows that dp 4 does not divide: run whole
    "tail": dict(axes={"dp": 4}, rows=6, zero=1),
}
SHARDED_STEPS = 5
# a small BERT (2 layers, hidden 64, vocab 512, no dropout) at dp 4 and
# at dp 2 x mp 2, unfused and with the fused MLM head, which hands the
# tied word embedding and the decoder bias, whole on every rank, to the
# loss; the batch (BERT_BATCH rows of BERT_SEQ tokens, BERT_MASKED
# masked positions each) has unequal ignored MLM counts per rank
BERT_SMALL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                  num_attention_heads=2, intermediate_size=128,
                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  max_position_embeddings=64)
BERT_CASES: Dict[str, Dict[str, Any]] = {
    "bert": dict(axes={"dp": 4}, zero=1, fused=False),
    "bert_fused": dict(axes={"dp": 4}, zero=1, fused=True),
    "bert_fused_tp": dict(axes={"dp": 2, "mp": 2}, rule="megatron",
                          fused=True),
}
BERT_BATCH, BERT_SEQ, BERT_MASKED = 8, 16, 4
BERT_LR = 1e-3
BN_CASES = {"bn_plain": dict(sync=False, single_pass=False),
            "bn_plain1": dict(sync=False, single_pass=True),
            "bn_sync2": dict(sync=True, single_pass=False),
            "bn_sync1": dict(sync=True, single_pass=True)}
BN_STEPS = 3
LC_CASES = [(kind, causal) for kind in ("ring_fold", "ring_flash",
                                        "ulysses_flash", "ulysses_plain")
            for causal in (False, True)]
STRAGGLER_RANK = 2
STRAGGLER_STEPS = 4
STRAGGLER_BASE_S, STRAGGLER_EXTRA_S = 0.1, 0.3
JOB_TIMEOUT_S = 240.0


def test_parallel_rule(name: str, value):
    """``tests/test_parallel.py``'s tensor-parallel rule for TinyMLP."""
    from ..parallel.mesh import P
    if name == "fc1.weight":
        return P(None, "mp")
    if name == "fc2.weight":
        return P("mp", None)
    return P()


def _device():
    import torch
    return torch.device(os.environ.get("PT_WORKER_DEVICE", "cpu"))


def tiny_mlp(device):
    """fc1 [16, 64] -> GELU -> fc2 [64, 4]; ``scale`` (per row of the
    hidden) and ``shift`` (added to the output) ride as kwargs."""
    from .. import nn

    class TinyMLP(nn.Layer):
        def __init__(self) -> None:
            super().__init__()
            self.fc1 = nn.Linear(16, 64, device=device)
            self.act = nn.GELU()
            self.fc2 = nn.Linear(64, 4, device=device)

        def forward(self, x, scale=None, shift=None):
            h = self.fc1(x)
            if scale is not None:
                h = h * scale
            out = self.fc2(self.act(h))
            return out if shift is None else out + shift

    return TinyMLP()


def _load(model, inputs, prefix: str) -> None:
    from ..convert import load_jax_params
    params = {k[len(prefix):]: v for k, v in inputs.items()
              if k.startswith(prefix)}
    bufs = {k: params.pop(k) for k in list(params)
            if k.endswith("._mean") or k.endswith("._variance")}
    load_jax_params(model, params, bufs or None)


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


# -- collective --------------------------------------------------------------

def job_collective(inputs, rank: int, world: int) -> Dict[str, np.ndarray]:
    import torch

    from .. import observability as obs
    from ..flags import set_flags
    from ..parallel import collective as C
    from ..parallel import create_mesh
    dev = _device()
    out: Dict[str, np.ndarray] = {}
    mesh = create_mesh({"dp": world})
    x = torch.tensor(inputs["x"][rank], device=dev)      # [8, 12]
    pos = torch.tensor(inputs["pos"][rank], device=dev)  # positive
    set_flags({"enable_metrics": True})
    obs.reset_all()
    try:
        with mesh:
            C.new_group("dp", ring_id=0)
            for op in ("sum", "mean", "max", "min"):
                out[f"all_reduce_{op}"] = _np(C.all_reduce(x, op))
            out["all_reduce_prod"] = _np(C.all_reduce(pos, "prod"))
            out["reduce"] = _np(C.reduce(x, 0, "sum"))
            for ax in (0, 1):
                out[f"all_gather_{ax}"] = _np(C.all_gather(x, ax))
                out[f"reduce_scatter_{ax}"] = _np(C.reduce_scatter(x, ax))
            out["broadcast"] = _np(C.broadcast(x, 1))
            out["scatter"] = _np(C.scatter(x, 2))
            out["all_to_all"] = _np(C.all_to_all(x, 0, 1))
            ring = [(i, (i + 1) % world) for i in range(world)]
            out["ppermute"] = _np(C.ppermute(x, ring))
            out["ppermute_partial"] = _np(C.ppermute(x, [(0, 2), (1, 3)]))
            out["rank"] = _np(C.rank())
            out["world_size"] = np.asarray(C.world_size())
            C.barrier()
            snap = obs.registry().snapshot()
            calls = {s["labels"]["op"]: s["value"] for s in
                     snap["collective_calls_total"]["series"]}
            out["calls_ops"] = np.asarray(sorted(calls))
            out["calls_n"] = np.asarray([calls[k] for k in sorted(calls)])
            nbytes = {s["labels"]["op"]: s["value"] for s in
                      snap["collective_bytes_total"]["series"]}
            out["bytes_all_gather"] = np.asarray(nbytes["all_gather"])
            # the gradients of the differentiable ops: d sum(f(x) * w)
            w = {k: torch.tensor(inputs[k], device=dev) for k in
                 ("w_gather", "w_scatter", "w_a2a", "w_perm")}
            fns = {"all_gather": lambda t: (C.all_gather(t, 0)
                                            * w["w_gather"]).sum(),
                   "reduce_scatter": lambda t: (C.reduce_scatter(t, 1)
                                                * w["w_scatter"][rank]).sum(),
                   "all_to_all": lambda t: (C.all_to_all(t, 0, 1)
                                            * w["w_a2a"][rank]).sum(),
                   "ppermute": lambda t: (C.ppermute(t, ring)
                                          * w["w_perm"][rank]).sum(),
                   "all_reduce": lambda t: (C.all_reduce(t, "sum")
                                            * w["w_perm"][rank]).sum()}
            for name, fn in fns.items():
                xr = x.clone().requires_grad_(True)
                (g,) = torch.autograd.grad(fn(xr), [xr])
                out[f"grad_{name}"] = _np(g)
        # a group over one axis of a 2 x 2 mesh
        mesh2 = create_mesh({"dp": 2, "mp": world // 2})
        with mesh2:
            out["mp_sum"] = _np(C.all_reduce(x, "sum", group="mp"))
            g = C.new_group("mp", ring_id=7)
            out["mp_sum_ring7"] = _np(C.all_reduce(x, "sum", group=g))
            assert C.get_group(7) is g
    finally:
        set_flags({"enable_metrics": False})
        obs.reset_all()
    return out


# -- train -------------------------------------------------------------------

def _sharded_case(name: str, spec, inputs, rank: int, world: int,
                  dev) -> Dict[str, np.ndarray]:
    import torch

    from ..amp import GradScaler
    from ..ops import loss as L
    from ..optimizer import Adam
    from ..parallel import (ShardedTrainStep, create_mesh,
                            megatron_param_rule)
    model = tiny_mlp(dev)
    _load(model, inputs, "mlp/")
    mesh = create_mesh(spec["axes"], allow_submesh=True)
    rule = {"test_parallel": test_parallel_rule,
            "megatron": megatron_param_rule()}.get(spec.get("rule"))
    scaler = GradScaler(init_loss_scaling=2.0 ** 10) \
        if spec.get("scaler") else None
    step = ShardedTrainStep(
        model, Adam(1e-2), lambda o, y: L.cross_entropy(o, y), mesh,
        param_rule=rule, zero_stage=spec.get("zero", 0),
        amp_dtype=spec.get("amp"), scaler=scaler)
    rows = spec.get("rows", len(inputs["x"]))
    x = torch.tensor(inputs["x"][:rows], device=dev)
    y = torch.tensor(inputs["y_ignore" if spec.get("ignore") else "y"][
        :rows], device=dev)
    kw = {}
    if spec.get("kwargs"):
        kw = dict(scale=torch.tensor(inputs["scale"], device=dev),
                  shift=torch.tensor(inputs["shift"], device=dev))
    losses = [float(step(x, labels=(y,), **kw)["loss"])
              for _ in range(SHARDED_STEPS)]
    step.sync_to_model()
    out = {f"{name}/loss": np.asarray(losses)}
    for n, p in model.named_parameters():
        out[f"{name}/param/{n}"] = _np(p)
    out[f"{name}/shard_numel"] = np.asarray(
        sum(t.numel() for t in step.shards.values()))
    return out


def _bert_case(name: str, spec, inputs, rank: int, world: int,
               dev) -> Dict[str, np.ndarray]:
    import torch

    from ..flags import set_flags
    from ..models import BertConfig, BertForPretraining, pretraining_loss
    from ..optimizer import AdamW
    from ..parallel import (ShardedTrainStep, create_mesh,
                            megatron_param_rule)
    model = BertForPretraining(BertConfig(**BERT_SMALL), device=dev)
    _load(model, inputs, "bert/")
    rule = megatron_param_rule() if spec.get("rule") == "megatron" \
        else None
    step = ShardedTrainStep(
        model, AdamW(BERT_LR, weight_decay=0.01, fused_state=False),
        pretraining_loss, create_mesh(spec["axes"], allow_submesh=True),
        param_rule=rule, zero_stage=spec.get("zero", 0))
    batch = [torch.tensor(inputs[f"bert_{k}"], device=dev)
             for k in ("ids", "types", "mask", "pos", "mlm", "nsp")]
    set_flags({"fused_softmax_xent": spec["fused"]})
    try:
        losses = [float(step(*batch[:4], labels=tuple(batch[4:]))["loss"])
                  for _ in range(SHARDED_STEPS)]
    finally:
        set_flags({"fused_softmax_xent": False})
    out = {f"{name}/loss": np.asarray(losses)}
    for n, p in model.named_parameters():
        out[f"{name}/param/{n}"] = _np(p)
    return out


def small_resnet(dev):
    from ..models import resnet
    return resnet.ResNet(resnet.BasicBlock, [1, 1, 1, 1], num_classes=10,
                         data_format="NHWC", device=dev)


def _bn_case(name: str, spec, inputs, rank: int, world: int,
             dev) -> Dict[str, np.ndarray]:
    import torch

    from .. import nn
    from ..flags import set_flags
    from ..ops import loss as L
    from ..optimizer import Momentum
    from ..parallel import ShardedTrainStep, create_mesh
    model = small_resnet(dev)
    _load(model, inputs, "resnet/")
    if spec["sync"]:
        nn.SyncBatchNorm.convert_sync_batchnorm(model, "dp")
    set_flags({"batch_norm_single_pass": spec["single_pass"]})
    try:
        step = ShardedTrainStep(model, Momentum(0.1, 0.9),
                                lambda o, y: L.cross_entropy(o, y),
                                create_mesh({"dp": world}))
        x = torch.tensor(inputs["images"], device=dev)
        y = torch.tensor(inputs["classes"], device=dev)
        losses = [float(step(x, labels=(y,))["loss"])
                  for _ in range(BN_STEPS)]
    finally:
        set_flags({"batch_norm_single_pass": True})
    out = {f"{name}/loss": np.asarray(losses)}
    for n, p in model.named_parameters():
        out[f"{name}/param/{n}"] = _np(p)
    for n, b in model.named_buffers():
        out[f"{name}/buffer/{n}"] = _np(b)
    return out


def _sbn_op(inputs, rank: int, world: int, dev) -> Dict[str, np.ndarray]:
    import torch

    from ..flags import set_flags
    from ..ops import nn_functional as F
    from ..parallel import create_mesh
    out = {}
    rows = inputs["sbn_x"].shape[0] // world
    for single in (False, True):
        set_flags({"batch_norm_single_pass": single})
        try:
            x = torch.tensor(inputs["sbn_x"][rank * rows:(rank + 1) * rows],
                             device=dev, requires_grad=True)
            g = torch.tensor(inputs["sbn_g"][rank * rows:(rank + 1) * rows],
                             device=dev)
            rm = torch.zeros(3, device=dev)
            rv = torch.ones(3, device=dev)
            w = torch.tensor(inputs["sbn_w"], device=dev)
            b = torch.tensor(inputs["sbn_b"], device=dev)
            with create_mesh({"dp": world}):
                y, nm, nv = F.sync_batch_norm(x, rm, rv, w, b, True, 0.9,
                                              1e-5, "NCHW", axis_name="dp")
            (dx,) = torch.autograd.grad((y * g).sum(), [x])
        finally:
            set_flags({"batch_norm_single_pass": True})
        tag = "sp" if single else "tp"
        out.update({f"sbn_{tag}/out": _np(y), f"sbn_{tag}/mean": _np(nm),
                    f"sbn_{tag}/var": _np(nv), f"sbn_{tag}/dx": _np(dx)})
    return out


def _data_parallel(inputs, rank: int, world: int, dev):
    import torch

    from ..parallel import DataParallel, create_mesh
    model = tiny_mlp(dev)
    dp = DataParallel(model, mesh=create_mesh({"dp": world}))
    g = {"fc1.weight": torch.full((16, 64), float(rank + 1), device=dev)}
    red = dp.apply_collective_grads(g)
    loss = torch.tensor(3.0)
    assert dp.scale_loss(loss) is loss
    assert set(dp.state_dict()) == set(model.state_dict())
    return {"dp_mean": _np(red["fc1.weight"]),
            "dp_nranks": np.asarray(dp.nranks)}


def _hapi(inputs, rank: int, world: int, dev):
    from .. import hapi
    from ..ops import loss as L
    from ..optimizer import Adam
    from ..parallel import create_mesh
    model = tiny_mlp(dev)
    _load(model, inputs, "mlp/")
    m = hapi.Model(model, loss=lambda o, y: L.cross_entropy(o, y),
                   optimizer=Adam(1e-2))
    m.prepare(mesh=create_mesh({"dp": world}), zero_stage=1)
    batches = [(inputs["x"][i * 8:(i + 1) * 8],
                inputs["y"][i * 8:(i + 1) * 8]) for i in range(2)]
    hist = m.fit(batches, epochs=2, verbose=0)
    out = {"hapi/loss": np.asarray(hist["loss"])}
    for n, p in model.named_parameters():
        out[f"hapi/param/{n}"] = _np(p)
    return out


def _straggler(inputs, rank: int, world: int, dev):
    """Each rank times STRAGGLER_STEPS local steps (no collective inside,
    so a slow rank does not slow the others) and feeds the detector; the
    exchange flags rank STRAGGLER_RANK, which sleeps STRAGGLER_EXTRA_S
    longer a step on purpose. Every step waits STRAGGLER_BASE_S, so that
    the host's load, which stretches a short step by a large factor,
    moves the others' times by a small one."""
    from .. import observability as obs
    from ..flags import set_flags
    from ..observability import goodput
    from ..parallel import create_mesh
    set_flags({"enable_metrics": True, "straggler_factor": 1.5})
    obs.reset_all()
    try:
        det = goodput.StragglerDetector(create_mesh({"dp": world}), "dp",
                                        interval=STRAGGLER_STEPS)
        for i in range(STRAGGLER_STEPS):
            t0 = time.perf_counter()
            np.linalg.svd(np.random.default_rng(i).standard_normal(
                (48, 48)))
            time.sleep(STRAGGLER_BASE_S + (STRAGGLER_EXTRA_S
                                           if rank == STRAGGLER_RANK
                                           else 0.0))
            det.observe(i, time.perf_counter() - t0)
        snap = obs.registry().snapshot()
        series = snap.get("straggler_events_total", {}).get("series", [])
        flagged = sorted(int(s["labels"]["host"]) for s in series
                         for _ in range(int(s["value"])))
        events = [e for e in obs.flight_recorder().events()
                  if e["kind"] == "straggler"]
    finally:
        set_flags({"enable_metrics": False, "straggler_factor": 0.0})
        obs.reset_all()
    return {"straggler/flagged": np.asarray(flagged, dtype=np.int64),
            "straggler/events": np.asarray(len(events))}


def job_train(inputs, rank: int, world: int) -> Dict[str, np.ndarray]:
    dev = _device()
    out: Dict[str, np.ndarray] = {}
    for name, spec in SHARDED_CASES.items():
        out.update(_sharded_case(name, spec, inputs, rank, world, dev))
    for name, spec in BERT_CASES.items():
        out.update(_bert_case(name, spec, inputs, rank, world, dev))
    for name, spec in BN_CASES.items():
        out.update(_bn_case(name, spec, inputs, rank, world, dev))
    out.update(_sbn_op(inputs, rank, world, dev))
    out.update(_data_parallel(inputs, rank, world, dev))
    out.update(_hapi(inputs, rank, world, dev))
    out.update(_straggler(inputs, rank, world, dev))
    return out


# -- long context ------------------------------------------------------------

def job_long_context(inputs, rank: int, world: int) -> Dict[str, np.ndarray]:
    import torch

    from .. import kernels
    from ..parallel import create_mesh, ring_attention, ulysses_attention
    dev = _device()
    mesh = create_mesh({"sp": world})
    t = inputs["q"].shape[2] // world
    sl = slice(rank * t, (rank + 1) * t)
    dtype = getattr(torch, str(inputs.get("dtype", np.asarray("float32"))))
    out: Dict[str, np.ndarray] = {}
    for kind, causal in LC_CASES:
        if str(kind) not in [str(k) for k in inputs["kinds"]]:
            continue
        q, k, v, g = (torch.tensor(inputs[n][:, :, sl], device=dev,
                                   dtype=dtype).requires_grad_(n != "g")
                      for n in ("q", "k", "v", "g"))
        fn = ring_attention if kind.startswith("ring") else \
            ulysses_attention
        use_flash = kind.endswith("flash")
        kernels.reset_launch_counts()
        o = fn(q, k, v, mesh, "sp", causal=causal, use_flash=use_flash)
        dq, dk, dv = torch.autograd.grad((o.float() * g.float()).sum(),
                                         [q, k, v])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        tag = f"{kind}/{'causal' if causal else 'full'}"
        out[f"{tag}/out"] = _np(o)
        for n, gr in (("dq", dq), ("dk", dk), ("dv", dv)):
            out[f"{tag}/{n}"] = _np(gr)
        counts = kernels.launch_counts()
        out[f"{tag}/launch_names"] = np.asarray(sorted(counts))
        out[f"{tag}/launches"] = np.asarray([counts[n]
                                             for n in sorted(counts)])
    try:
        bad = torch.zeros((1, world + 2, 4 * world, 8), device=dev)
        ulysses_attention(bad, bad, bad, mesh, "sp")
        out["heads_error"] = np.asarray("")
    except ValueError as e:
        out["heads_error"] = np.asarray(str(e))
    return out


# -- global shuffle ----------------------------------------------------------

GSHUFFLE_SLOTS = [{"name": "feat", "kind": "dense", "dim": 6,
                   "shape": (2, 3)},
                  ("src", "sparse", 12), ("tgt", "sparse", 9)]


def job_gshuffle(inputs, rank: int, world: int) -> Dict[str, np.ndarray]:
    from .. import native
    from ..data import DatasetFactory
    ds = DatasetFactory().create_dataset("InMemoryDataset")
    ds.set_slots(GSHUFFLE_SLOTS)
    ds.set_batch_size(4)
    ds.set_thread(1)
    ds.set_filelist([str(inputs["files"][rank])])
    ds.load_into_memory()
    host, port = os.environ["PT_CP_ENDPOINT"].split(":")
    with native.ControlPlaneClient(host, int(port)) as cli:
        n = ds.global_shuffle(cli, rank, world)
    out = {"count": np.asarray(n)}
    for i, b in enumerate(ds):
        for k, v in b.items():
            out[f"batch{i}/{k}"] = np.asarray(v)
    return out


# -- the card (chip_smoke.py phase 13c) ---------------------------------------

def attention_inputs(seed: int, b: int, h: int, t: int, d: int):
    """q, k, v and the output cotangent g, [b, h, t, d] fp32 from numpy's
    ``seed``: the global arrays whose sequence blocks the ranks hold."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, d), dtype=np.float32)
            for _ in range(4)]


def bert_batch(seed: int, batch: int, seq: int, masked: int, vocab: int):
    """A global BERT pretraining batch (ids, types, mask, masked
    positions, MLM labels, NSP labels), numpy int64 from ``seed``."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (batch, seq))
    types = (np.arange(seq)[None] >= seq // 2).astype(np.int64).repeat(
        batch, 0)
    mask = np.ones((batch, seq), np.int64)
    pos = np.stack([np.sort(rng.choice(seq, masked, replace=False))
                    for _ in range(batch)]).astype(np.int64)
    mlm = np.take_along_axis(ids, pos, axis=1)
    nsp = rng.integers(0, 2, batch)
    return ids, types, mask, pos, mlm, nsp


def chip_bert(torch, layers: int, seed: int, device):
    """BertForPretraining at BERT-base width, ``layers`` deep, no dropout
    (the ranks' streams differ from one process's), fp32, from ``seed``."""
    from ..models import BertConfig, BertForPretraining
    cfg = BertConfig(num_hidden_layers=layers, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    return BertForPretraining(cfg, device=device, seed=seed)


def _timed(torch, fn):
    """``(fn(), its wall ms)``, the card synchronised around it."""
    sync = torch.cuda.synchronize if _device().type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


# phase 10's fused flags: BERT's fused MLM head (its loss takes the tied
# word embedding and the decoder bias, whole on every rank) and the Adam
# kernel
FUSED_FLAGS = {"fused_softmax_xent": True, "fused_adam": True}
# the 2-layer full-width BERT's runs on the card's four ranks: (name,
# mesh axes, ZeRO stage, fused flags); "mp" takes the Megatron rule
CHIP_BERT_RUNS = (("dp4", {"dp": 4}, 1, False),
                  ("dp2mp2", {"dp": 2, "mp": 2}, 0, False),
                  ("dp4_fused", {"dp": 4}, 1, True),
                  ("dp2mp2_fused", {"dp": 2, "mp": 2}, 0, True))


def job_chip(inputs, rank: int, world: int) -> Dict[str, np.ndarray]:
    """Phase 13c: ring attention (flash route) and Ulysses at BERT-base
    heads over ``inputs["t"]`` tokens, the 2-layer full-width BERT at
    dp 4 and dp 2 x mp 2 (:data:`CHIP_BERT_RUNS`, under the default flags
    and under :data:`FUSED_FLAGS`), and the straggler drill."""
    import torch

    from .. import kernels
    from ..flags import set_flags
    from ..models import pretraining_loss
    from ..optimizer import AdamW
    from ..parallel import (ShardedTrainStep, create_mesh,
                            megatron_param_rule, ring_attention,
                            ulysses_attention)
    dev = _device()
    out: Dict[str, np.ndarray] = {}
    h, t, d = (int(inputs[k]) for k in ("heads", "t", "d"))
    q, k, v, g = attention_inputs(int(inputs["seed"]), 1, h, t, d)
    tl = t // world
    sl = slice(rank * tl, (rank + 1) * tl)
    mesh = create_mesh({"sp": world})
    for kind in ("ring", "ulysses"):
        fn = ring_attention if kind == "ring" else ulysses_attention
        for causal in (False, True):
            tag = f"{kind}/{'causal' if causal else 'full'}"
            qt, kt, vt = (torch.tensor(a[:, :, sl], device=dev
                                       ).requires_grad_(True)
                          for a in (q, k, v))
            gt = torch.tensor(g[:, :, sl], device=dev)
            kernels.reset_launch_counts()

            def run():
                o = fn(qt, kt, vt, mesh, "sp", causal=causal,
                       use_flash=None)
                return o, torch.autograd.grad((o * gt).sum(),
                                              [qt, kt, vt])

            (o, grads), ms = _timed(torch, run)
            counts = kernels.launch_counts()
            out[f"{tag}/out"] = _np(o)
            for n, gr in zip(("dq", "dk", "dv"), grads):
                out[f"{tag}/{n}"] = _np(gr)
            out[f"{tag}/ms"] = np.asarray(ms)
            out[f"{tag}/launch_names"] = np.asarray(sorted(counts))
            out[f"{tag}/launches"] = np.asarray(
                [counts[n] for n in sorted(counts)])
            del qt, kt, vt, gt, o, grads
    torch.cuda.empty_cache()
    batch = [torch.tensor(a, device=dev) for a in bert_batch(
        int(inputs["seed"]) + 1, int(inputs["bert_batch"]),
        int(inputs["bert_seq"]), int(inputs["bert_masked"]), 30522)]
    for name, axes, zero, fused in CHIP_BERT_RUNS:
        model = chip_bert(torch, int(inputs["bert_layers"]),
                          int(inputs["seed"]), dev)
        step = ShardedTrainStep(
            model, AdamW(float(inputs["bert_lr"]), weight_decay=0.01,
                         fused_state=False),
            pretraining_loss, create_mesh(axes),
            param_rule=megatron_param_rule() if "mp" in axes else None,
            zero_stage=zero)
        kernels.reset_launch_counts()
        losses, ms = [], []
        set_flags(FUSED_FLAGS if fused else
                  {k: False for k in FUSED_FLAGS})
        try:
            for _ in range(int(inputs["bert_steps"])):
                m, dt = _timed(torch, lambda: step(
                    *batch[:4], labels=tuple(batch[4:])))
                losses.append(float(m["loss"]))
                ms.append(dt)
        finally:
            set_flags({k: False for k in FUSED_FLAGS})
        counts = kernels.launch_counts()
        out[f"bert_{name}/launch_names"] = np.asarray(sorted(counts))
        out[f"bert_{name}/launches"] = np.asarray(
            [counts[n] for n in sorted(counts)])
        out[f"bert_{name}/loss"] = np.asarray(losses)
        out[f"bert_{name}/ms"] = np.asarray(ms)
        for n, p in model.named_parameters():
            out[f"bert_{name}/param/{n}"] = _np(p)
        out[f"bert_{name}/shard_numel"] = np.asarray(
            sum(x.numel() for x in step.shards.values()))
        del model, step
        torch.cuda.empty_cache()
    out.update(_straggler(inputs, rank, world, dev))
    return out


def spawn_probe(out_dir: str) -> None:
    """A ``distributed.launch.spawn`` target: writes this rank's cluster
    environment to ``<out_dir>/spawn-<rank>``."""
    rank = os.environ["PT_TRAINER_ID"]
    keys = ("PT_TRAINER_ID", "PT_TRAINERS_NUM", "PT_CP_ENDPOINT",
            "PT_STORE_PATH", "LOCAL_WORLD_SIZE")
    with open(os.path.join(out_dir, f"spawn-{rank}"), "w") as f:
        f.write("\n".join(f"{k}={os.environ.get(k, '')}" for k in keys))


JOBS: Dict[str, Callable] = {"collective": job_collective,
                             "train": job_train, "chip": job_chip,
                             "long_context": job_long_context,
                             "gshuffle": job_gshuffle}


# -- the harness -------------------------------------------------------------

def run_job(job: str, workdir, world: int = 4,
            inputs: Optional[Dict[str, np.ndarray]] = None,
            timeout_s: float = JOB_TIMEOUT_S,
            env: Optional[Dict[str, str]] = None) -> List[Dict[str, Any]]:
    """Runs ``job`` on ``world`` ranks (see the module note); returns each
    rank's outputs. Raises RuntimeError with the ranks' log tails when a
    rank fails or the gang outlives ``timeout_s``."""
    from ..distributed.launch import launch_procs
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    np.savez(workdir / "in.npz", **(inputs or {}))
    (workdir / "store").unlink(missing_ok=True)  # a FileStore is one-use
    extra = {"OMP_NUM_THREADS": "1",
             "PT_STORE_PATH": str(workdir / "store"),
             "PYTHONPATH": os.pathsep.join(
                 [str(Path(__file__).resolve().parents[2])]
                 + [p for p in os.environ.get("PYTHONPATH", "").split(
                     os.pathsep) if p])}
    extra.update(env or {})
    rc = launch_procs([sys.executable, "-m",
                       "paddle_tpu_torch.testing.dist_worker", job,
                       str(workdir)], world, env_extra=extra,
                      poll_interval=0.1, timeout_s=timeout_s)
    if rc != 0:
        logs = []
        for r in range(world):
            p = workdir / f"rank{r}.log"
            tail = p.read_text()[-3000:] if p.exists() else "(no log)"
            logs.append(f"--- rank {r} ---\n{tail}")
        raise RuntimeError(f"job {job!r} failed rc={rc}\n" + "\n".join(logs))
    outs = []
    for r in range(world):
        with np.load(workdir / f"rank{r}.npz") as z:
            outs.append({k: z[k] for k in z.files})
    return outs


def main(argv: List[str]) -> int:
    job, workdir = argv[1], Path(argv[2])
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    world = int(os.environ["PADDLE_TRAINERS_NUM"])
    log = open(workdir / f"rank{rank}.log", "w", buffering=1)
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    try:
        import torch
        torch.set_num_threads(1)
        from ..parallel import init_parallel_env
        init_parallel_env()
        if os.environ.get("PT_WORKER_DEVICE", "cpu") == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        with np.load(workdir / "in.npz") as z:
            inputs = {k: z[k] for k in z.files}
        out = JOBS[job](inputs, rank, world)
        np.savez(workdir / f"rank{rank}.npz", **out)
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - the log is the report
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
