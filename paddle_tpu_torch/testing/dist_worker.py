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
``moe`` (``ShardedTrainStep`` with ``moe_param_rule("ep")`` over
:data:`MOE_CASES` at dp 1 x ep 4 and dp 2 x ep 2, and the refused
combinations), ``chip_moe`` (``chip_smoke.py`` phase 18 (b): MoE at
Switch-Base's expert width at dp 1 x ep 4 and dp 2 x ep 2, four Gloo
ranks sharing a card or one NCCL rank a card), ``long_context`` (ring and Ulysses attention, forward and
gradients),
``gshuffle`` (``InMemoryDataset.global_shuffle`` over the control plane),
``pipeline`` (``gpipe`` and ``GPipeTrainStep`` at pp 4), ``dgc_localsgd``
(``LocalSGDStep``, ``DGCTrainStep``, ``dgc_allreduce`` at dp 4), ``fleet``
(``apply_strategy``'s routes and :data:`FLEET_CASES`, ``fleet.metrics``),
``ps`` (two pserver shards and two sync trainers with a sparse table),
``chip`` (``chip_smoke.py`` phase 13 (c)'s four ranks on one card: ring
and Ulysses attention at BERT-base heads, a 2-layer BERT-base at dp 4 and
dp 2 x mp 2, the straggler drill), ``chip14`` (phase 14 (a): GPipe over
BERT-base, TP + ZeRO 3, LocalSGD, DGC, fleet and the PS on the 2-layer
BERT-base) and ``chip_nccl`` (phase 14 (b): ``chip``, phase 13 (a)'s fits
at world 4, ``chip14`` and BERT-base at seq 512 under NCCL, one rank a
card).
Each case's configuration lives here, so a test builds the JAX side from
the same description.
"""

from __future__ import annotations

import os
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

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
    # real partitioning: Megatron blocks with ZeRO 3's dp blocks on top,
    # a tail batch under ZeRO 3, and a global-norm clip over blocks
    "tp_zero3": dict(axes={"dp": 2, "mp": 2}, rule="megatron", zero=3),
    "tail_zero3": dict(axes={"dp": 4}, rows=6, zero=3),
    "tp_clip": dict(axes={"dp": 2, "mp": 2}, rule="megatron", zero=3,
                    clip=0.05),
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
    "bert_fused_zero3": dict(axes={"dp": 4}, zero=3, fused=True),
    "bert_tp_zero3": dict(axes={"dp": 2, "mp": 2}, rule="megatron",
                          zero=3, fused=False),
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
    from ..clip import ClipGradByGlobalNorm
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
    clip = ClipGradByGlobalNorm(spec["clip"]) if spec.get("clip") else None
    step = ShardedTrainStep(
        model, Adam(1e-2, grad_clip=clip),
        lambda o, y: L.cross_entropy(o, y), mesh,
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
    for n, p in step.whole_params().items():
        out[f"{name}/param/{n}"] = _np(p)
    out[f"{name}/shard_numel"] = np.asarray(
        sum(t.numel() for t in step.shards.values()))
    # what the model itself holds between steps, by parameter
    for n, p in model.named_parameters():
        out[f"{name}/held_shape/{n}"] = np.asarray(p.shape)
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
    for n, p in step.whole_params().items():
        out[f"{name}/param/{n}"] = _np(p)
    for n, p in model.named_parameters():
        out[f"{name}/held_shape/{n}"] = np.asarray(p.shape)
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


# param rules whose layout the model lacks: (name, rule); each must raise
# naming the parameter
TP_ERROR_RULES = {
    "no_partner": {"fc1.weight": (None, "mp")},
    "bias_alone": {"fc2.bias": ("mp",)},
    "two_axes": {"fc1.weight": ("dp", "mp"), "fc2.weight": ("mp", None)},
}


def _tp_errors(rank: int, world: int, dev) -> Dict[str, np.ndarray]:
    """The message of each :data:`TP_ERROR_RULES` rule at dp 2 x mp 2 (a
    rank raises before any collective, so every rank does)."""
    from ..optimizer import Adam
    from ..parallel import ShardedTrainStep, create_mesh
    from ..parallel.mesh import P
    out = {}
    mesh = create_mesh({"dp": 2, "mp": world // 2})
    rules = dict(TP_ERROR_RULES)
    # the bias of a row-parallel Linear split with its weight's rows
    rules["row_bias"] = {"fc1.weight": (None, "mp"),
                         "fc2.weight": ("mp", None), "fc2.bias": ("mp",)}
    for tag, table in rules.items():
        try:
            ShardedTrainStep(tiny_mlp(dev), Adam(1e-2), lambda o, y: o,
                             mesh, param_rule=lambda n, v, t=table: P(
                                 *t.get(n, ())))
            out[f"tp_error/{tag}"] = np.asarray("")
        except ValueError as e:
            out[f"tp_error/{tag}"] = np.asarray(str(e))
    return out


def job_train(inputs, rank: int, world: int) -> Dict[str, np.ndarray]:
    dev = _device()
    out: Dict[str, np.ndarray] = {}
    out.update(_tp_errors(rank, world, dev))
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


# -- expert parallelism ------------------------------------------------------

# ``tests/test_moe.py``'s MoENet (d 16, hidden 32, 4 experts, top-2, inputs
# [n, 6, 8], 4 classes) under ``moe_param_rule("ep")``: each case's mesh
# and capacity factor (0.5 drops choices), 5 Adam steps on one global
# batch of MOE_ROWS rows
MOE_CASES: Dict[str, Dict[str, Any]] = {
    "ep4": dict(axes={"dp": 1, "ep": 4}, cf=2.0),
    "dp2_ep2": dict(axes={"dp": 2, "ep": 2}, cf=2.0),
    "ep4_drop": dict(axes={"dp": 1, "ep": 4}, cf=0.5),
    "dp2_ep2_drop": dict(axes={"dp": 2, "ep": 2}, cf=0.5),
    # plain SGD: a gradient's scale moves the weights (Adam's update
    # hardly sees a gradient counted twice)
    "ep4_sgd": dict(axes={"dp": 1, "ep": 4}, cf=2.0, sgd=True),
    "dp2_ep2_sgd": dict(axes={"dp": 2, "ep": 2}, cf=2.0, sgd=True),
    # the net returns the layer's ``aux`` and the loss adds MOE_AUX_W
    # times it: the load-balance term's gradient, under SGD
    "ep4_aux": dict(axes={"dp": 1, "ep": 4}, cf=2.0, sgd=True, aux=True),
    "dp2_ep2_aux": dict(axes={"dp": 2, "ep": 2}, cf=2.0, sgd=True,
                        aux=True),
}
MOE_STEPS, MOE_LR, MOE_SGD_LR, MOE_ROWS = 5, 3e-3, 0.05, 16
MOE_AUX_W = 1.0
# the combinations the port's expert parallelism refuses: the tokens
# split over the expert axis, and ZeRO beside it
MOE_ERRORS = {"batch_over_ep": dict(batch_spec=(("dp", "ep"),)),
              "zero1": dict(zero_stage=1)}


def moe_net(device, d: int = 16, h: int = 32, e: int = 4,
            classes: int = 4, cf: float = 2.0, blocks: int = 1,
            in_dim: int = 8, seed: int = 0, aux: bool = False):
    """``tests/test_moe.py``'s MoENet (``embed`` -> ``h + moe(h)`` ->
    ``head`` of the mean over time); ``blocks`` > 1 stacks that many
    residual MoE blocks (``moes``); with ``aux`` the forward returns
    ``(logits, the sum of the blocks' aux)``."""
    import torch

    from .. import nn

    class MoENet(nn.Layer):
        def __init__(self) -> None:
            super().__init__()
            kw = dict(device=device, generator=torch.Generator(
                device=device).manual_seed(seed))
            self.embed = nn.Linear(in_dim, d, **kw)
            make = [nn.MoELayer(d, h, num_experts=e, top_k=2,
                                capacity_factor=cf, **kw)
                    for _ in range(blocks)]
            if blocks == 1:
                self.moe = make[0]
            else:
                self.moes = nn.LayerList(make)
            self.head = nn.Linear(d, classes, **kw)

        def layers(self):
            return [self.moe] if blocks == 1 else list(self.moes)

        def forward(self, x):
            h = self.embed(x)
            for moe in self.layers():
                h = h + moe(h)
            out = self.head(h.mean(dim=1))
            if aux:
                return out, sum(m.aux for m in self.layers())
            return out

    return MoENet()


def moe_loss(aux: bool):
    """The MoE nets' loss: cross entropy, plus ``MOE_AUX_W`` times the
    returned load-balance term with ``aux``."""
    from ..ops import loss as L
    if aux:
        return lambda o, y: L.cross_entropy(o[0], y) + MOE_AUX_W * o[1]
    return lambda o, y: L.cross_entropy(o, y)


def moe_dropped(model, *args) -> list:
    """The dropped choices of each MoE block of ``model`` (a ``moe_net``)
    on the rows of ``args``, from one no-grad forward: each block's
    ``route`` of its input (on a rank, its rows, inside the step's batch
    group)."""
    import torch
    counts = []

    def count(layer, inputs):
        x = inputs[0]
        keep = layer.route(x.reshape(-1, x.shape[-1])).keep
        counts.append(int((~keep).sum()))

    hooks = [m.register_forward_pre_hook(count) for m in model.layers()]
    try:
        with torch.no_grad():
            model(*args)
    finally:
        for hook in hooks:
            hook.remove()
    return counts


def moe_case(name: str, spec, inputs, dev, steps: int = MOE_STEPS,
             lr: float = MOE_LR, prefix: Optional[str] = "moe/",
             net_kw: Optional[Dict[str, Any]] = None,
             ref: Optional[Dict[str, np.ndarray]] = None
             ) -> Dict[str, np.ndarray]:
    """One expert-parallel case: the first step's routing of this rank's
    rows (which choices are kept), then ``steps`` steps (Adam, or SGD for
    a ``sgd`` case; an ``aux`` case's loss adds the load-balance term,
    ``moe_loss``), each step's loss, ``aux_loss`` (each block's), dropped
    choices (this rank's rows, ``moe_dropped`` on the weights the step
    reads), backend calls, kernel launches and
    (on the card) stream ms; then the whole parameters, or with ``ref``
    (the reference's parameters by name) each one's largest gap to it
    over its largest entry and its largest absolute gap; what the model
    holds and its bytes. The weights come from ``inputs`` under
    ``prefix``, or (``prefix=None``) from ``moe_net``'s seeded draw."""
    import torch

    from .. import kernels
    from ..nn import moe_param_rule
    from ..nn import norm as _norm
    from ..optimizer import SGD, Adam
    from ..parallel import ShardedTrainStep, collective as _c, create_mesh
    aux_on = bool(spec.get("aux"))
    model = moe_net(dev, cf=spec["cf"], aux=aux_on, **(net_kw or {}))
    if prefix is not None:
        _load(model, inputs, prefix)
    mesh = create_mesh(spec["axes"], allow_submesh=True)
    opt = SGD(MOE_SGD_LR) if spec.get("sgd") else Adam(lr)
    step = ShardedTrainStep(model, opt, moe_loss(aux_on), mesh,
                            param_rule=moe_param_rule("ep"))
    x = torch.tensor(inputs["moe_x"], device=dev)
    y = torch.tensor(inputs["moe_y"], device=dev)
    out = {f"{name}/dp_index": np.asarray(mesh.axis_index("dp")),
           f"{name}/ep_index": np.asarray(mesh.axis_index("ep"))}
    dp = mesh.axis_size("dp")
    group = step._batch_group if dp > 1 else None
    rows = step._local(x)
    with torch.no_grad(), mesh, _norm.global_batch(group):
        h = model.embed(rows)
        r = model.layers()[0].route(h.reshape(-1, h.shape[-1]))
    out[f"{name}/keep"] = _np(r.keep)
    out[f"{name}/expert"] = _np(r.expert)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, aux, dropped, calls, ms = [], [], [], [], []
    for _ in range(steps):
        with mesh, _norm.global_batch(group):
            dropped.append(moe_dropped(model, rows))
        _c.reset_backend_calls()
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        loss = step(x, labels=(y,))["loss"]
        if cuda:
            ev[1].record()
            ev[1].synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        losses.append(float(loss))
        calls.append(sum(_c.backend_calls().values()))
        aux.append([float(m.aux_loss) for m in model.layers()])
    counts = kernels.launch_counts()
    out.update({f"{name}/loss": np.asarray(losses),
                f"{name}/aux": np.asarray(aux),
                f"{name}/dropped": np.asarray(dropped),
                f"{name}/backend_calls": np.asarray(calls),
                f"{name}/step_ms": np.asarray(ms),
                f"{name}/captures": np.asarray(step.captures),
                f"{name}/launch_names": np.asarray(sorted(counts)),
                f"{name}/launches": np.asarray(
                    [counts[k] for k in sorted(counts)])})
    if cuda:
        out[f"{name}/peak_gb"] = np.asarray(
            torch.cuda.max_memory_allocated() / 2 ** 30)
    for n, p in step.whole_params().items():
        if ref is None:
            out[f"{name}/param/{n}"] = _np(p)
            continue
        want = torch.from_numpy(ref[n]).to(p.device)
        gap = float((p - want).abs().max())
        out[f"{name}/param_gap/{n}"] = np.asarray(
            [gap / max(float(want.abs().max()), 1e-30), gap])
    for n, p in model.named_parameters():
        out[f"{name}/held_shape/{n}"] = np.asarray(p.shape)
    out[f"{name}/held_bytes"] = np.asarray(sum(
        p.numel() * p.element_size() for p in model.parameters()))
    return out


def _moe_errors(rank: int, world: int, dev) -> Dict[str, np.ndarray]:
    """The message of each :data:`MOE_ERRORS` combination (raised before
    any collective, on every rank)."""
    from ..nn import moe_param_rule
    from ..optimizer import Adam
    from ..parallel import ShardedTrainStep, create_mesh
    from ..parallel.mesh import P
    out = {}
    mesh = create_mesh({"dp": 2, "ep": world // 2})
    for tag, kw in MOE_ERRORS.items():
        kw = dict(kw)
        if "batch_spec" in kw:
            kw["batch_spec"] = P(*kw["batch_spec"])
        try:
            ShardedTrainStep(moe_net(dev), Adam(1e-2), lambda o, y: o, mesh,
                             param_rule=moe_param_rule("ep"), **kw)
            out[f"moe_error/{tag}"] = np.asarray("")
        except ValueError as e:
            out[f"moe_error/{tag}"] = np.asarray(str(e))
    return out


def job_moe(inputs, rank: int, world: int) -> Dict[str, np.ndarray]:
    dev = _device()
    out = _moe_errors(rank, world, dev)
    for name, spec in MOE_CASES.items():
        out.update(moe_case(name, spec, inputs, dev))
    return out


# ``chip_smoke.py`` phase 18 (b)'s meshes (the net's widths and the
# steps come with the inputs); a ``cf`` replaces the net's capacity
# factor (0.5 drops choices), its reference under ``ref<cf>/``
CHIP_MOE_CASES = {"ep4": dict(axes={"dp": 1, "ep": 4}),
                  "dp2_ep2": dict(axes={"dp": 2, "ep": 2}),
                  "dp2_ep2_drop": dict(axes={"dp": 2, "ep": 2}, cf=0.5)}


def job_chip_moe(inputs, rank: int, world: int) -> Dict[str, np.ndarray]:
    """Each case of :data:`CHIP_MOE_CASES`: ``int(inputs["steps"])`` Adam
    steps under ``fused_adam`` from ``moe_net``'s seeded weights (its
    arguments ``net/<name>``), every whole parameter held against the
    one-card reference's at the case's capacity factor
    (``ref<cf>/<name>``)."""
    from ..flags import set_flags
    dev = _device()
    set_flags({"fused_adam": True})
    kw = {k[4:]: v.item() for k, v in inputs.items()
          if k.startswith("net/")}
    net_cf = kw.pop("cf")
    out: Dict[str, np.ndarray] = {}
    for name, spec in CHIP_MOE_CASES.items():
        cf = spec.get("cf", net_cf)
        tag = f"ref{cf}/"
        ref = {k[len(tag):]: v for k, v in inputs.items()
               if k.startswith(tag)}
        out.update(moe_case(name, dict(spec, cf=cf), inputs, dev,
                            steps=int(inputs["steps"]),
                            lr=float(inputs["lr"]), prefix=None,
                            net_kw=kw, ref=ref))
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


# -- pipeline ----------------------------------------------------------------

PIPE_STEPS = 3
PIPE_MICRO = 4


def pipe_parts(dev, widths=(8, 16, 1), n_stages: int = 4):
    """GPipe's parts for the ``pipeline`` job: embed Linear(in, hidden),
    ``n_stages`` stages of Sequential(Linear(hidden, hidden), Tanh), head
    Linear(hidden, out)."""
    from .. import nn
    d_in, hid, d_out = widths
    embed = nn.Linear(d_in, hid, device=dev)
    stages = [nn.Sequential(nn.Linear(hid, hid, device=dev), nn.Tanh())
              for _ in range(n_stages)]
    head = nn.Linear(hid, d_out, device=dev)
    return embed, stages, head


def _load_pipe(inputs, embed, stages, head, prefix: str) -> None:
    _load(embed, inputs, f"{prefix}embed/")
    for i, st in enumerate(stages):
        _load(st, inputs, f"{prefix}stage{i}/")
    _load(head, inputs, f"{prefix}head/")


def job_pipeline(inputs, rank: int, world: int) -> Dict[str, np.ndarray]:
    """``gpipe`` over four stages (the forward and the input's gradient)
    and ``GPipeTrainStep`` (plain, with ``remat_stages``) at pp 4."""
    import torch

    from ..ops import loss as L
    from ..optimizer import Adam
    from ..parallel import create_mesh
    from ..parallel.pipeline import GPipeTrainStep, gpipe, stack_stage_params
    dev = _device()
    mesh = create_mesh({"pp": world})
    out: Dict[str, np.ndarray] = {}
    _, stages, _ = pipe_parts(dev, (16, 16, 16))
    for i, st in enumerate(stages):
        _load(st, inputs, f"seq/stage{i}/")
    template = stages[0]
    x = torch.tensor(inputs["seq_x"], device=dev, requires_grad=True)

    def stage_fn(params, xb):
        return torch.func.functional_call(template, params, (xb,))

    y = gpipe(stage_fn, stack_stage_params(stages), x, PIPE_MICRO, mesh)
    (dx,) = torch.autograd.grad((y * torch.tensor(inputs["seq_g"],
                                                  device=dev)).sum(), [x])
    out["gpipe/y"], out["gpipe/dx"] = _np(y), _np(dx)
    for remat in (False, True):
        embed, stages, head = pipe_parts(dev)
        _load_pipe(inputs, embed, stages, head, "pipe/")
        step = GPipeTrainStep(embed, stages, head, Adam(1e-2),
                              lambda o, t: L.mse_loss(o, t), mesh,
                              num_microbatches=PIPE_MICRO,
                              remat_stages=remat)
        xb = torch.tensor(inputs["pipe_x"], device=dev)
        yb = torch.tensor(inputs["pipe_y"], device=dev)
        tag = "remat" if remat else "plain"
        out[f"{tag}/loss"] = np.asarray(
            [float(step(xb, labels=(yb,))["loss"])
             for _ in range(PIPE_STEPS)])
        for n, p in step.params.items():
            out[f"{tag}/param/{n}"] = _np(p)
        out[f"{tag}/stage_id"] = np.asarray(step.stage_id)
    return out


# -- DGC and LocalSGD ----------------------------------------------------------

LOCALSGD_K = 4
DGC_STEPS = 6
DGC_FEEDBACK_STEPS = 20


def job_dgc_localsgd(inputs, rank: int, world: int) -> Dict[str, np.ndarray]:
    """LocalSGD (k 4, Momentum) through one sync, DGC (Momentum, sparsity
    0.75, rampup 3) through its warm-up and past it, and
    ``dgc_allreduce``'s error feedback over 20 exchanges, at dp 4."""
    import torch

    from .. import nn
    from ..ops import loss as L
    from ..optimizer import Momentum
    from ..parallel import (DGCTrainStep, LocalSGDStep, create_mesh,
                            dgc_allreduce)
    dev = _device()
    mesh = create_mesh({"dp": world})
    out: Dict[str, np.ndarray] = {}

    def mse(o, t):
        return L.mse_loss(o, t)

    model = nn.Linear(8, 4, device=dev)
    _load(model, inputs, "lsgd/")
    step = LocalSGDStep(model, Momentum(0.05, 0.9), mse, mesh,
                        k_steps=LOCALSGD_K)
    x, y = (torch.tensor(inputs[k], device=dev) for k in ("lx", "ly"))
    losses, divs = [], []
    for _ in range(LOCALSGD_K + 1):
        losses.append(float(step(x, labels=(y,))["loss"]))
        divs.append(step.replica_divergence())
    out["lsgd/loss"], out["lsgd/div"] = np.asarray(losses), np.asarray(divs)
    for n, p in step.params.items():
        out[f"lsgd/param/{n}"] = _np(p)
    for n, p in step.averaged_params().items():
        out[f"lsgd/avg/{n}"] = _np(p)
    model = nn.Linear(16, 4, device=dev)
    _load(model, inputs, "dgc/")
    step = DGCTrainStep(model, Momentum(0.05, 0.9), mse, mesh,
                        sparsity=0.75, rampup_steps=3)
    x, y = (torch.tensor(inputs[k], device=dev) for k in ("dx", "dy"))
    out["dgc/loss"] = np.asarray([float(step(x, labels=(y,))["loss"])
                                  for _ in range(DGC_STEPS)])
    for n, p in step.params.items():
        out[f"dgc/param/{n}"] = _np(p)
    g = torch.tensor(inputs["fb_g"], device=dev)
    res = torch.zeros_like(g)
    delivered = []
    with mesh:
        for _ in range(DGC_FEEDBACK_STEPS):
            d, res = dgc_allreduce(g, res, "dp", sparsity=0.9)
            delivered.append(_np(d))
    out["fb/delivered"] = np.stack(delivered)
    out["fb/residual"] = _np(res)
    return out


# -- fleet ---------------------------------------------------------------------

FLEET_STEPS = 3
# strategy toggles of each composed case (held against the JAX
# apply_strategy on the same model and batch)
FLEET_CASES: Dict[str, Dict[str, Any]] = {
    "merge": dict(gradient_merge=True, k=2, avg=True),
    "merge_sum": dict(gradient_merge=True, k=2, avg=False),
    "recompute": dict(recompute=True),
    "zero3": dict(sharding=True, stage=3),
    "tp": dict(tensor_parallel=True, degree=2),
    "hier": dict(hierarchical_allreduce=True),
}


def fleet_strategy(fleet, spec):
    """A DistributedStrategy (of the port's or the JAX package's
    ``fleet``) from a :data:`FLEET_CASES` entry."""
    s = fleet.DistributedStrategy()
    if spec.get("gradient_merge"):
        s.gradient_merge = True
        s.gradient_merge_configs.k_steps = spec["k"]
        s.gradient_merge_configs.avg = spec["avg"]
    if spec.get("recompute"):
        s.recompute = True
    if spec.get("sharding"):
        s.sharding = True
        s.sharding_configs.stage = spec["stage"]
    if spec.get("tensor_parallel"):
        s.tensor_parallel = True
        s.tensor_parallel_configs = {"tensor_parallel_degree":
                                     spec["degree"]}
    if spec.get("hierarchical_allreduce"):
        s.hierarchical_allreduce = True
    return s


def job_fleet(inputs, rank: int, world: int) -> Dict[str, np.ndarray]:
    """``apply_strategy``'s routes and composed steps on the tiny MLP
    (the global batch on every rank), ``fleet`` itself, and
    ``fleet.metrics`` over the control plane (rank ``r`` holds its own
    statistics)."""
    import torch

    from ..distributed import fleet
    from ..ops import loss as L
    from ..optimizer import SGD, Adam, Momentum
    from ..parallel import DGCTrainStep, LocalSGDStep, ShardedTrainStep
    dev = _device()
    out: Dict[str, np.ndarray] = {}

    def xent(o, t):
        return L.cross_entropy(o, t)

    f = fleet.init(is_collective=True)
    out["fleet/worker"] = np.asarray([f.worker_index(), f.worker_num(),
                                      int(f.is_first_worker())])
    x = torch.tensor(inputs["x"], device=dev)
    y = torch.tensor(inputs["y"], device=dev)
    for name, spec in FLEET_CASES.items():
        model = tiny_mlp(dev)
        _load(model, inputs, "mlp/")
        opt = fleet.distributed_optimizer(Adam(1e-2),
                                          fleet_strategy(fleet, spec))
        step = f.build_train_step(model, opt, xent)
        out[f"{name}/type"] = np.asarray(type(step).__name__)
        out[f"{name}/loss"] = np.asarray(
            [float(step(x, labels=(y,))["loss"])
             for _ in range(FLEET_STEPS)])
        for n, p in step.whole_params().items():
            out[f"{name}/param/{n}"] = _np(p)
        out[f"{name}/mesh"] = np.asarray(
            [f"{k}={v}" for k, v in step.mesh.shape.items()])
    routes = {}
    for tag, opt in (("dgc", Momentum(0.01, 0.9)), ("localsgd", SGD(0.01)),
                     ("sharding", Adam(0.01))):
        s = fleet.DistributedStrategy()
        setattr(s, tag, True)
        if tag == "localsgd":
            s.localsgd_configs.k_steps = 3
        step = fleet.apply_strategy(s, tiny_mlp(dev), opt, xent)
        routes[tag] = step
    out["route/dgc"] = np.asarray(isinstance(routes["dgc"], DGCTrainStep))
    out["route/localsgd"] = np.asarray(
        isinstance(routes["localsgd"], LocalSGDStep)
        and routes["localsgd"].k_steps == 3)
    out["route/sharding"] = np.asarray(
        isinstance(routes["sharding"], ShardedTrainStep)
        and any("dp" in str(sp) for sp in routes["sharding"].slot_specs
                .values()))
    s = fleet.DistributedStrategy()
    s.amp, s.dgc = True, True
    try:
        fleet.apply_strategy(s, tiny_mlp(dev), Momentum(0.01), xent)
        out["route/amp_dgc"] = np.asarray("")
    except ValueError as e:
        out["route/amp_dgc"] = np.asarray(str(e))
    m = fleet.metrics
    st = inputs["metric_stats"][rank]  # correct, total, abserr, sqrerr
    out["metrics/values"] = np.asarray([
        float(m.sum(np.array([rank + 1.0]))[0]), float(m.max(rank * 10.0)),
        float(m.min(rank - 1.0)), m.acc(st[0], st[1]), m.mae(st[2], st[1]),
        m.mse(st[3], st[1]), m.rmse(st[3], st[1]),
        m.auc(inputs["auc_pos"][rank], inputs["auc_neg"][rank])])
    f.barrier_worker()
    return out


# -- the parameter server ------------------------------------------------------

PS_STEPS = 5
PS_LR = 0.1


def job_ps(inputs, rank: int, world: int) -> Dict[str, np.ndarray]:
    """Ranks 0 and 1 each run a pserver shard (``run_server``), the other
    ranks are sync trainers of a small regression model over both shards,
    its embedding served as a sparse table (``SparseEmbeddingPS``, looked
    up by the ids of input 0); each trainer feeds its half of the global
    batch. The ports meet through the control plane."""
    import torch

    from .. import native, nn
    from ..distributed.ps import (PSCluster, PSTrainStep, SparseEmbeddingPS,
                                  run_server)
    host, port = os.environ["PT_CP_ENDPOINT"].split(":")
    cp = native.ControlPlaneClient(host, int(port))
    out: Dict[str, np.ndarray] = {}
    n_servers = 2
    trainers = world - n_servers
    if rank < n_servers:
        server = run_server(0, ready_callback=lambda srv: cp.set(
            f"ps/port{rank}", str(srv.port).encode()))
        try:
            cp.barrier("ps/done", world, 120000)
        finally:
            server.stop()
        out["role"] = np.asarray("server")
        return out
    ports = [int(cp.get(f"ps/port{r}")) for r in range(n_servers)]
    cluster = PSCluster([f"127.0.0.1:{p}" for p in ports])
    dev = _device()
    model = nn.Sequential(nn.Embedding(16, 4, device=dev),
                          nn.Flatten(), nn.Linear(8, 1, device=dev))
    _load(model, inputs, "psreg/")
    emb = SparseEmbeddingPS(cluster, "emb", 4, optimizer="sgd", lr=PS_LR,
                            init_scale=0.05)
    step = PSTrainStep(model, lambda o, t: ((o - t) ** 2).mean(), cluster,
                       mode="sync", n_trainers=trainers, optimizer="sgd",
                       lr=PS_LR, sparse_tables={"0.weight": (emb, 0)})
    me = rank - n_servers
    ids, tgt = inputs["ps_ids"], inputs["ps_y"]
    rows = ids.shape[1] // trainers
    losses = []
    for i in range(PS_STEPS):
        sl = slice(me * rows, (me + 1) * rows)
        losses.append(step(torch.tensor(ids[i, sl], device=dev),
                           labels=(torch.tensor(tgt[i, sl], device=dev),)
                           )["loss"])
    out["role"] = np.asarray("trainer")
    out["loss"] = np.asarray(losses)
    for n, v in step.params.items():
        out[f"param/{n}"] = v
    out["emb"] = emb.pull(np.arange(16))
    cluster.close()
    cp.barrier("ps/done", world, 120000)
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


def chip_bert(torch, layers: int, seed: int, device, **widths):
    """BertForPretraining at BERT-base width (``widths`` may shrink it for
    a check on the CPU), ``layers`` deep, no dropout (the ranks' streams
    differ from one process's), fp32, from ``seed``."""
    from ..models import BertConfig, BertForPretraining
    cfg = BertConfig(num_hidden_layers=layers, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0, **widths)
    return BertForPretraining(cfg, device=device, seed=seed)


# the untied BERT's word embedding, the PS runs' sparse table
PS_WORD = "net.bert.embeddings.word_embeddings.weight"


def untied_bert(torch, layers: int, seed: int, device, **widths):
    """:func:`chip_bert` with its MLM decoder untied from the word
    embedding: ``decoder_weight``, a parameter of its own that starts as
    the embedding's copy, so the model reads the word embedding (named
    :data:`PS_WORD`) only at the batch's ids, a lookup a sparse table can
    serve."""
    from torch import nn
    model = chip_bert(torch, layers, seed, device, **widths)

    class Untied(nn.Module):
        def __init__(self, net) -> None:
            super().__init__()
            self.net, self.config = net, net.config
            self.decoder_weight = nn.Parameter(
                net.bert.embeddings.word_embeddings.weight.detach().clone())

        def forward(self, input_ids, token_type_ids=None,
                    attention_mask=None, masked_positions=None):
            seq_out, pooled = self.net.bert(input_ids, token_type_ids,
                                            attention_mask)
            if masked_positions is not None:
                idx = masked_positions.long()[:, :, None].expand(
                    -1, -1, seq_out.shape[-1])
                seq_out = torch.gather(seq_out, 1, idx)
            return self.net.cls(seq_out, pooled, self.decoder_weight)

    return Untied(model)


def chip_widths(inputs) -> Dict[str, int]:
    """The BERT widths a job's inputs ask for (``width/<name>``; none:
    BERT-base's)."""
    return {k[len("width/"):]: int(v) for k, v in inputs.items()
            if k.startswith("width/")}


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
        for n, p in step.whole_params().items():
            out[f"bert_{name}/param/{n}"] = _np(p)
        out[f"bert_{name}/shard_numel"] = np.asarray(
            sum(x.numel() for x in step.shards.values()))
        # what the model holds between steps (its blocks under tensor
        # parallelism)
        out[f"bert_{name}/held_numel"] = np.asarray(
            sum(p.numel() for p in model.parameters()))
        del model, step
        torch.cuda.empty_cache()
    out.update(_straggler(inputs, rank, world, dev))
    return out


# -- the card (chip_smoke.py phase 14) ----------------------------------------

# phase 14 runs its BERT cases under the fused flags with the flash route
# on at seq 128
CHIP14_FLAGS = dict(FUSED_FLAGS, flash_attention_min_seq_train=128)
CHIP14_PS_LR = 0.05
CHIP14_DGC = dict(sparsity=0.99, rampup_steps=1, momentum=0.9, lr=1e-2)
CHIP14_LOCALSGD_K = 2


def bert_stage(layers):
    """A stage of a BERT trunk: encoder layers run in order, with no
    attention mask (the phase's batches are unpadded)."""
    from .. import nn

    class Stage(nn.Layer):
        def __init__(self) -> None:
            super().__init__()
            self.layers = nn.LayerList(list(layers))

        def forward(self, x):
            for layer in self.layers:
                x = layer(x)
            return x

    return Stage()


def bert_head(model):
    """BERT's pooler and pretraining heads as one module over the trunk's
    output, reading the tied word embedding from ``model``'s
    embeddings."""
    from .. import nn

    class _Head(nn.Layer):
        def __init__(self, m) -> None:
            super().__init__()
            self.pooler, self.cls = m.bert.pooler, m.cls
            self.pooler_act = m.bert.pooler_act
            self.word = m.bert.embeddings.word_embeddings

        def forward(self, seq_out):
            pooled = self.pooler_act(self.pooler(seq_out[:, 0]))
            return self.cls(seq_out, pooled, self.word.weight)

    return _Head(model)


def gpipe_bert(torch, layers: int, stages: int, seed: int, device,
               **widths):
    """(embed, stages, head, the whole model) of :func:`chip_bert` cut
    into ``stages`` stages of equal depth."""
    model = chip_bert(torch, layers, seed, device, **widths)
    per = layers // stages
    trunk = model.bert.encoder.layers
    return (model.bert.embeddings,
            [bert_stage(trunk[i * per:(i + 1) * per]) for i in range(stages)],
            bert_head(model), model)


def _counts(kernels) -> Dict[str, np.ndarray]:
    c = kernels.launch_counts()
    return {"launch_names": np.asarray(sorted(c)),
            "launches": np.asarray([c[n] for n in sorted(c)])}


def full_mlm_labels(torch, batch):
    """The batch's MLM labels over every position ([B, T]; -100 where
    nothing is masked), for a head that scores every position."""
    ids, _, _, pos, mlm, _ = batch
    return torch.full_like(ids, -100).scatter_(1, pos, mlm)


def _run_steps(torch, step, batch, steps: int, pipeline: bool = False):
    """(losses, ms of each step) of ``steps`` calls on one batch (a
    pipeline takes the ids alone and the labels of every position)."""
    if pipeline:
        args, labels = (batch[0],), (full_mlm_labels(torch, batch),
                                     batch[5])
    else:
        args, labels = tuple(batch[:4]), (batch[4], batch[5])
    losses, ms = [], []
    for _ in range(steps):
        m, dt = _timed(torch, lambda: step(*args, labels=labels))
        losses.append(float(m["loss"]))
        ms.append(dt)
    return losses, ms


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _reset_memory(torch, dev) -> None:
    """Frees the allocator's cache and restarts its peak (the card)."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _peak_gb(torch, dev) -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 30 \
        if dev.type == "cuda" else 0.0


def _case(torch, kernels, out, tag, fn, params=None):
    """Runs ``fn()`` -> (losses, ms) and records them, the launches, this
    rank's peak memory and the parameters ``params()`` gives."""
    dev = _device()
    _reset_memory(torch, dev)
    kernels.reset_launch_counts()
    losses, ms = fn()
    out[f"{tag}/loss"] = np.asarray(losses)
    out[f"{tag}/ms"] = np.asarray(ms)
    for k, v in _counts(kernels).items():
        out[f"{tag}/{k}"] = v
    out[f"{tag}/peak_gb"] = np.asarray(_peak_gb(torch, dev))
    for n, p in (params() if params else {}).items():
        out[f"{tag}/param/{n}"] = _np(p)


def _dgc_steps(torch, step, batch, steps: int, out):
    """:func:`_run_steps` of a ``DGCTrainStep`` that also records, for
    each step past the warm-up, the entries this rank sent of every leaf
    (``dgc/sent/<step>/<name>``), for the reference to take the same
    ones. ``dgc.topk_sparsify`` is wrapped to keep a clone of each call's
    indices: one call a leaf a step, in the step's leaf order; under a
    captured step the clones of the capture are graph buffers that each
    replay refills, so the last calls' clones hold this step's."""
    from ..parallel import dgc
    chosen = []
    plain = dgc.topk_sparsify

    def recorded(g, k):
        vals, idx, residual = plain(g, k)
        chosen.append(idx.clone())
        return vals, idx, residual

    names = list(step.params)
    losses, ms = [], []
    dgc.topk_sparsify = recorded
    try:
        for i in range(steps):
            loss, dt = _run_steps(torch, step, batch, 1)
            losses += loss
            ms += dt
            if i < step.rampup_steps:
                continue
            for n, idx in zip(names, chosen[-len(names):]):
                k = max(1, int(step.params[n].numel()
                               * (1.0 - step.sparsity)))
                assert idx.numel() == k, (n, idx.numel(), k)
                out[f"dgc/sent/{i}/{n}"] = idx.cpu().numpy()
    finally:
        dgc.topk_sparsify = plain
    return losses, ms


def chip14_batch(torch, inputs, dev, batch: int, seq: int, seed_off: int):
    """A global BERT batch for phase 14 (:func:`bert_batch`), on ``dev``."""
    vocab = chip_widths(inputs).get("vocab_size", 30522)
    return [torch.tensor(a, device=dev) for a in bert_batch(
        int(inputs["seed"]) + seed_off, batch, seq,
        int(inputs["bert_masked"]), vocab)]


def job_chip14(inputs, rank: int, world: int) -> Dict[str, np.ndarray]:
    """Phase 14 (a): GPipe over BERT-base (12 layers in 4 stages of 3),
    then on the 2-layer full-width BERT tensor parallelism with ZeRO 3
    (dp 2 x mp 2), LocalSGD (dp 4, k 2), DGC (dp 4, Momentum, sparsity
    0.99, rampup 1), fleet with sharding (stage 3) and with gradient merge
    (k 2), and sync PS training (ranks 0-1 pserver shards, 2-3 trainers,
    :func:`untied_bert`'s word embedding a sparse table looked up by the
    batch's ids), under :data:`CHIP14_FLAGS`."""
    import torch

    from .. import kernels, native
    from ..distributed import fleet
    from ..distributed.ps import PSCluster, PSTrainStep, SparseEmbeddingPS
    from ..flags import get_flags, set_flags
    from ..models import pretraining_loss
    from ..optimizer import AdamW, Momentum
    from ..parallel import (DGCTrainStep, LocalSGDStep, ShardedTrainStep,
                            create_mesh, megatron_param_rule)
    from ..parallel.pipeline import GPipeTrainStep
    dev = _device()
    out: Dict[str, np.ndarray] = {}
    seed, lr = int(inputs["seed"]), float(inputs["bert_lr"])
    steps, layers = int(inputs["bert_steps"]), int(inputs["bert_layers"])
    widths = chip_widths(inputs)
    before = get_flags(list(CHIP14_FLAGS))
    set_flags(CHIP14_FLAGS)
    try:
        gb = chip14_batch(torch, inputs, dev, int(inputs["gpipe_batch"]),
                          int(inputs["bert_seq"]), 1)
        embed, stages, head, whole = gpipe_bert(
            torch, int(inputs["gpipe_layers"]), world, seed, dev, **widths)
        step = GPipeTrainStep(embed, stages, head,
                              AdamW(lr, weight_decay=0.01,
                                    fused_state=False),
                              pretraining_loss, create_mesh({"pp": world}),
                              num_microbatches=int(inputs["gpipe_micro"]))
        _case(torch, kernels, out, "gpipe",
              lambda: _run_steps(torch, step, gb, steps, pipeline=True),
              lambda: step.params)
        del step, embed, stages, head, whole
        batch = chip14_batch(torch, inputs, dev, int(inputs["bert_batch"]),
                             int(inputs["bert_seq"]), 2)

        def opt():
            return AdamW(lr, weight_decay=0.01, fused_state=False)

        model = chip_bert(torch, layers, seed, dev, **widths)
        step = ShardedTrainStep(model, opt(), pretraining_loss,
                                create_mesh({"dp": 2, "mp": world // 2}),
                                param_rule=megatron_param_rule(),
                                zero_stage=3)
        _case(torch, kernels, out, "tp_zero3",
              lambda: _run_steps(torch, step, batch, steps),
              step.whole_params)
        for n, p in model.named_parameters():
            out[f"tp_zero3/held_numel/{n}"] = np.asarray(p.numel())
        del model, step
        model = chip_bert(torch, layers, seed, dev, **widths)
        step = LocalSGDStep(model, opt(), pretraining_loss,
                            create_mesh({"dp": world}),
                            k_steps=CHIP14_LOCALSGD_K)
        _case(torch, kernels, out, "localsgd",
              lambda: _run_steps(torch, step, batch, 2 * CHIP14_LOCALSGD_K),
              lambda: step.params)
        del model, step
        model = chip_bert(torch, layers, seed, dev, **widths)
        step = DGCTrainStep(model, Momentum(CHIP14_DGC["lr"],
                                            CHIP14_DGC["momentum"]),
                            pretraining_loss, create_mesh({"dp": world}),
                            sparsity=CHIP14_DGC["sparsity"],
                            rampup_steps=CHIP14_DGC["rampup_steps"])
        _case(torch, kernels, out, "dgc",
              lambda: _dgc_steps(torch, step, batch, steps, out),
              lambda: step.params)
        del model, step
        for tag in ("sharding", "merge"):
            s = fleet.DistributedStrategy()
            if tag == "sharding":
                s.sharding, s.sharding_configs.stage = True, 3
            else:
                s.gradient_merge = True
                s.gradient_merge_configs.k_steps = 2
            model = chip_bert(torch, layers, seed, dev, **widths)
            step = fleet.fleet.build_train_step(
                model, fleet.distributed_optimizer(opt(), s),
                pretraining_loss)
            _case(torch, kernels, out, f"fleet_{tag}",
                  lambda: _run_steps(torch, step, batch, steps),
                  step.whole_params)
            del model, step
        # the parameter server: ranks 0 and 1 serve, the others train
        host, port = os.environ["PT_CP_ENDPOINT"].split(":")
        cp = native.ControlPlaneClient(host, int(port))
        if rank < 2:
            server = native.PsServer()
            try:
                cp.set(f"chip14/ps{rank}", str(server.port).encode())
                cp.barrier("chip14/ps_done", world, 600000)
            finally:
                server.stop()
        else:
            ports = [int(cp.get(f"chip14/ps{r}", timeout_ms=120000))
                     for r in range(2)]
            cluster = PSCluster([f"127.0.0.1:{p}" for p in ports])
            model = untied_bert(torch, layers, seed, dev, **widths)
            emb = SparseEmbeddingPS(cluster, "word",
                                    model.config.hidden_size, optimizer="sgd",
                                    lr=CHIP14_PS_LR, init_scale=0.02)
            step = PSTrainStep(model, pretraining_loss, cluster,
                               mode="sync", n_trainers=world - 2,
                               optimizer="sgd", lr=CHIP14_PS_LR,
                               sparse_tables={PS_WORD: (emb, 0)})
            rows = batch[0].shape[0] // (world - 2)
            mine = [t[(rank - 2) * rows:(rank - 1) * rows] for t in batch]
            _case(torch, kernels, out, "ps",
                  lambda: _run_steps(torch, step, mine, steps),
                  lambda: dict(
                      {k: torch.from_numpy(v) for k, v in
                       step.params.items()},
                      **{PS_WORD: torch.from_numpy(emb.pull(np.arange(
                          model.config.vocab_size)))}))
            cluster.close()
            cp.barrier("chip14/ps_done", world, 600000)
        cp.close()
    finally:
        set_flags(before)
    return out


# phase 14 (b)'s BERT-base runs under NCCL, one rank a card: (name, mesh
# axes, ZeRO stage, Megatron rule); bf16, fused flags, captured
CHIP_NCCL_RUNS = (("zero0", {"dp": 4}, 0, False),
                  ("zero3", {"dp": 4}, 3, False),
                  ("tp", {"dp": 2, "mp": 2}, 0, True))


def move_error(torch, end, ref, init) -> Tuple[float, float, str]:
    """How far a run's parameters ``end`` lie from the reference run's
    ``ref``, over how far ``ref`` moved from their common start ``init``
    (name -> tensor): (the L2 ratio over the whole model, the worst leaf's
    ratio, that leaf). A run that changed nothing reads 1."""
    num = den = 0.0
    worst, leaf = 0.0, ""
    for n, r in ref.items():
        e = float(torch.linalg.vector_norm(end[n].float() - r.float()))
        m = float(torch.linalg.vector_norm(r.float() - init[n].float()))
        num, den = num + e * e, den + m * m
        if m > 0 and e / m >= worst:
            worst, leaf = e / m, n
    return (num / den) ** 0.5, worst, leaf


def whole_masters(step) -> Dict[str, Any]:
    """A ZeRO 0/3 or tensor-parallel ``ShardedTrainStep``'s fp32 masters,
    whole (all-gathered: every rank calls this) and on the host: there a
    master is held as its parameter is (an fp32 parameter is its own)."""
    from ..parallel.spmd import _unblock
    assert step.zero_stage in (0, 3), step.zero_stage
    out = {}
    for n, p in step.params.items():
        m = step.state["slots"][n].get("master", p).detach()
        out[n] = (_unblock(m, step._held[n], step.mesh)
                  if step._held[n] else m).to("cpu", copy=True)
    return out


def _host_params(step) -> Dict[str, Any]:
    return {n: p.to("cpu", copy=True)
            for n, p in step.whole_params().items()}


def _fit_world(torch, inputs, dev) -> Dict[str, np.ndarray]:
    """Phase 13 (a) at world 4: BERT-base bf16 under the fused flags
    through ``Model.prepare(mesh=dp 4, zero_stage=z).fit`` (ZeRO 0: the
    flat fused state; 1 and 3: per-leaf), one epoch over the global
    batches every rank is given."""
    from .. import kernels
    from ..amp import cast_model_to_low_precision
    from ..flags import set_flags
    from ..hapi import Callback, Model
    from ..models import pretraining_loss
    from ..optimizer import AdamW
    from ..parallel import create_mesh
    out: Dict[str, np.ndarray] = {}
    widths = chip_widths(inputs)
    n, b = int(inputs["fit_batches"]), int(inputs["fit_batch"])
    data = bert_batch(int(inputs["seed"]) + 5, n * b,
                      int(inputs["nccl_seq"]), int(inputs["fit_masked"]),
                      widths.get("vocab_size", 30522))
    batches = [tuple(a[i * b:(i + 1) * b] for a in data[:4])
               + (np.concatenate([data[4][i * b:(i + 1) * b],
                                  data[5][i * b:(i + 1) * b, None]], 1),)
               for i in range(n)]

    class Rec(Callback):
        def __init__(self) -> None:
            self.losses = []

        def on_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"]))

    set_flags(FUSED_FLAGS)
    init = ref = None
    try:
        for z in (0, 1, 3):
            net = cast_model_to_low_precision(chip_bert(
                torch, int(inputs["nccl_layers"]), int(inputs["seed"]), dev,
                **widths), "bfloat16")
            if init is None:
                init = {n: p.detach().to("cpu", copy=True)
                        for n, p in net.named_parameters()}
            m = Model(net, loss=lambda o, y: pretraining_loss(
                o, y[:, :-1], y[:, -1]), optimizer=AdamW(
                    1e-4, weight_decay=0.01, fused_state=z == 0))
            m.prepare(mesh=create_mesh({"dp": 4}), zero_stage=z)
            rec = Rec()
            _reset_memory(torch, dev)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            m.fit(batches, epochs=1, verbose=0, callbacks=[rec])
            _sync(torch, dev)
            out[f"fit{z}/loss"] = np.asarray(rec.losses)
            out[f"fit{z}/s"] = np.asarray(time.perf_counter() - t0)
            out[f"fit{z}/captures"] = np.asarray(m._train_step.captures)
            out[f"fit{z}/peak_gb"] = np.asarray(_peak_gb(torch, dev))
            end = _host_params(m._train_step)
            if ref is None:
                # bf16 as its bits: the one-card fit is held against them
                ref = end
                for n, p in end.items():
                    out[f"fit0/param/{n}"] = p.view(torch.int16).numpy()
            else:
                out[f"fit{z}/move_err_vs_zero0"] = np.asarray(
                    move_error(torch, end, ref, init)[:2])
            del m, net, rec, end
    finally:
        set_flags({k: False for k in FUSED_FLAGS})
    return out


def _nccl_runs(torch, inputs, dev, rank: int) -> Dict[str, np.ndarray]:
    """Phase 14 (b)'s BERT-base runs (:data:`CHIP_NCCL_RUNS`) at world 4:
    12 layers, bf16, fused flags, one global batch of 4 x ``nccl_batch``
    rows at seq 512, captured; the losses, the steady step ms, the peak
    memory and the bytes a rank holds (parameters and optimizer state).
    First rank 0 runs the same steps alone (``TrainStep``, no collective;
    ``one/loss``), and holds each run's fp32 masters against that run's:
    ``<run>/master_move_err``, :func:`move_error`'s (whole model, worst
    leaf), and ``<run>/master_worst_leaf``."""
    import torch.distributed as dist

    from .. import kernels
    from ..amp import cast_model_to_low_precision
    from ..flags import set_flags
    from ..models import pretraining_loss
    from ..optimizer import AdamW
    from ..parallel import (ShardedTrainStep, create_mesh,
                            megatron_param_rule)
    from ..static import TrainStep
    out: Dict[str, np.ndarray] = {}
    widths = chip_widths(inputs)
    steps = int(inputs["nccl_steps"])

    def bf16_bert():
        return cast_model_to_low_precision(chip_bert(
            torch, int(inputs["nccl_layers"]), int(inputs["seed"]), dev,
            **widths), "bfloat16")

    def opt():
        return AdamW(1e-4, weight_decay=0.01, fused_state=False)

    set_flags(FUSED_FLAGS)
    try:
        batch = chip14_batch(torch, inputs, dev,
                             4 * int(inputs["nccl_batch"]),
                             int(inputs["nccl_seq"]), 7)
        init = ref = None
        if rank == 0:
            net = bf16_bert()
            # the masters start as the bf16 weights
            init = {n: p.detach().to("cpu", torch.float32, copy=True)
                    for n, p in net.named_parameters()}
            step = TrainStep(net, opt(), pretraining_loss)
            out["one/loss"] = np.asarray(_run_steps(torch, step, batch,
                                                    steps)[0])
            ref = {n: step.state["slots"][n].get("master", p).detach().to(
                "cpu", copy=True) for n, p in step.params.items()}
            del net, step
        dist.barrier()
        for name, axes, zero, tp in CHIP_NCCL_RUNS:
            _reset_memory(torch, dev)
            net = bf16_bert()
            step = ShardedTrainStep(
                net, opt(), pretraining_loss, create_mesh(axes),
                param_rule=megatron_param_rule() if tp else None,
                zero_stage=zero)
            kernels.reset_launch_counts()
            losses, ms = _run_steps(torch, step, batch, steps)
            held = sum(p.numel() * p.element_size()
                       for p in net.parameters())
            state = sum(t.numel() * t.element_size()
                        for slots in step.state["slots"].values()
                        for t in slots.values())
            out[f"{name}/loss"] = np.asarray(losses)
            out[f"{name}/ms"] = np.asarray(ms)
            out[f"{name}/param_bytes"] = np.asarray(held)
            out[f"{name}/state_bytes"] = np.asarray(state)
            out[f"{name}/captures"] = np.asarray(step.captures)
            out[f"{name}/peak_gb"] = np.asarray(_peak_gb(torch, dev))
            for k, v in _counts(kernels).items():
                out[f"{name}/{k}"] = v
            end = whole_masters(step)  # after the peak is read
            if rank == 0:
                err, worst, leaf = move_error(torch, end, ref, init)
                out[f"{name}/master_move_err"] = np.asarray([err, worst])
                out[f"{name}/master_worst_leaf"] = np.asarray(leaf)
            del net, step, end
    finally:
        set_flags({k: False for k in FUSED_FLAGS})
    return out


def job_chip_nccl(inputs, rank: int, world: int) -> Dict[str, np.ndarray]:
    """Phase 14 (b), under NCCL with one rank a card: phase 13 (c)'s job
    (:func:`job_chip`), phase 13 (a)'s fits at world 4, phase 14 (a)'s job
    (:func:`job_chip14`) and the BERT-base runs of
    :data:`CHIP_NCCL_RUNS`."""
    import torch
    dev = _device()
    out: Dict[str, np.ndarray] = {}
    parts = (("c", lambda: job_chip(inputs, rank, world)),
             ("a", lambda: _fit_world(torch, inputs, dev)),
             ("14a", lambda: job_chip14(inputs, rank, world)),
             ("14b", lambda: _nccl_runs(torch, inputs, dev, rank)))
    for tag, fn in parts:
        t0 = time.perf_counter()
        for k, v in fn().items():
            out[f"{tag}/{k}"] = v
        out[f"{tag}/s"] = np.asarray(time.perf_counter() - t0)
        _reset_memory(torch, dev)
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
                             "moe": job_moe, "chip_moe": job_chip_moe,
                             "long_context": job_long_context,
                             "gshuffle": job_gshuffle,
                             "pipeline": job_pipeline,
                             "dgc_localsgd": job_dgc_localsgd,
                             "fleet": job_fleet, "ps": job_ps,
                             "chip14": job_chip14,
                             "chip_nccl": job_chip_nccl}


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
