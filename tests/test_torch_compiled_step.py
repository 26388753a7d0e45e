"""PyTorch port: the captured train step, on the CPU.

On the card ``TrainStep`` captures its step as one CUDA graph per input
signature and replays it (``paddle_tpu_torch/static``). A CUDA graph
cannot run here, so these tests hold what the capture depends on:

- (a) every state tensor the step writes stays at its address: the
  optimizer's step counter, moments, fp32 masters and flat fused slots,
  the scaler state and the non-finite counter;
- (b) the body the card captures, run eagerly on its static input
  buffers by a stand-in for the graph backend (``EagerGraphs``: the
  warm-up runs the step, a "replay" runs the captured body), equals the
  eager step bit for bit, with dropout 0.1 drawing from the step's one
  generator, through ``__call__`` and ``run_steps``;
- (c) that body trains as the JAX step does over ten steps;
- (d) each repair: ``compiled=True`` on the CPU raises, a host-driven
  rate reaches the update through ``host_lr``, the step-indexed
  schedulers build their tables once, the fused Adam kernel's leaf
  table is built once per set of pointers (and inside a capture made
  empty and filled after it), and a replay adds its graph's launches to
  the counters.

A small BERT (2 layers, hidden 64, 2 heads, vocab 512, seq 32).
"""

import gc
import weakref

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as pt  # noqa: E402
from paddle_tpu.models import BertConfig as JaxBertConfig  # noqa: E402
from paddle_tpu.models import BertForPretraining as JaxBert  # noqa: E402
from paddle_tpu.models import pretraining_loss as jax_pretraining_loss  # noqa: E402,E501
from paddle_tpu.optimizer import AdamW as JaxAdamW  # noqa: E402
from paddle_tpu.static import TrainStep as JaxTrainStep  # noqa: E402

from paddle_tpu_torch import amp, kernels, set_flags  # noqa: E402
from paddle_tpu_torch import static as port_static  # noqa: E402
from paddle_tpu_torch.convert import load_jax_params  # noqa: E402
from paddle_tpu_torch.kernels import fused_adam  # noqa: E402
from paddle_tpu_torch.models import (BertConfig,  # noqa: E402
                                     BertForPretraining, pretraining_loss)
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402
from paddle_tpu_torch.optimizer import lr as port_lr  # noqa: E402
from paddle_tpu_torch.static import TrainStep  # noqa: E402

SMALL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=128,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             max_position_embeddings=64)
DROPOUT = dict(SMALL, hidden_dropout_prob=0.1,
               attention_probs_dropout_prob=0.1)
B, T, P = 2, 32, 6


def _batch(seed=0, t=T):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (B, t)).astype(np.int32)
    types = rng.integers(0, 2, (B, t)).astype(np.int32)
    mask = np.ones((B, t), np.int32)
    mask[1, t - 8:] = 0
    pos = np.sort(rng.permuted(np.broadcast_to(np.arange(t), (B, t)),
                               axis=1)[:, :P], axis=1).astype(np.int32)
    mlm = rng.integers(0, 512, (B, P)).astype(np.int64)
    mlm[0, 1] = mlm[1, 4] = -100  # ignored positions
    nsp = rng.integers(0, 2, (B,)).astype(np.int64)
    return ids, types, mask, pos, mlm, nsp


def _no_decay(name: str) -> bool:
    return not (name.endswith(".bias") or "norm" in name)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _port_batch(seed=0, t=T):
    ids, types, mask, pos, mlm, nsp = (_t(a) for a in _batch(seed, t))
    return (ids, types, mask, pos), (mlm, nsp)


class _Replayer:
    """Stands in for a CUDA graph: ``replay()`` runs the captured body."""

    def __init__(self, body) -> None:
        self.body = body
        self.replays = 0

    def replay(self) -> None:
        self.replays += 1
        self.body()


class EagerGraphs:
    """Stands in for the step's CUDA graph backend on the CPU: the warm-up
    runs the step as the side stream would, and the capture keeps the
    body without running it (as a capture records and runs nothing);
    ``count`` is added to the kernel counters during the capture, as the
    wrappers count the launches a capture records."""

    def __init__(self, count=None) -> None:
        self.count = count or {}
        self.graphs = []

    def warm_up(self, fn):
        return fn()

    def capture(self, fn, generator, table_rows):
        kernels.add_launch_counts(self.count)
        self.graphs.append(_Replayer(fn))
        return self.graphs[-1], []


def _compiled(step, backend=None):
    """``step`` taking the captured route with the stand-in backend."""
    step.compiled = True
    step._backend = backend or EagerGraphs()
    return step


def _model(cfg=DROPOUT, dtype=None, seed=0):
    model = BertForPretraining(BertConfig(**cfg), device="cpu", seed=seed)
    return amp.cast_model_to_low_precision(model, dtype) if dtype \
        else model


def _twins(cfg=DROPOUT, dtype=None):
    a, b = _model(cfg, dtype), _model(cfg, dtype)
    b.load_state_dict(a.state_dict())
    return a, b


def _state_tensors(step):
    out = {"opt.step": step.state["step"],
           "nonfinite_steps": step.nonfinite_steps,
           "host_lr": step.host_lr}
    for n, slots in step.state["slots"].items():
        out.update({f"opt.{n}.{k}": t for k, t in slots.items()})
    out.update({f"opt.fused.{k}": t
                for k, t in step.state.get("fused", {}).items()})
    out.update({f"scaler.{k}": t
                for k, t in (step.scaler_state or {}).items()})
    out.update({f"param.{n}": p for n, p in step.params.items()})
    return out


# -- (a) state in place -------------------------------------------------

@pytest.mark.parametrize("fused_state", [False, True])
@pytest.mark.parametrize("scaled", [False, True])
def test_state_tensors_stay_in_place(fused_state, scaled):
    if scaled:
        model = _model(SMALL, "float16")
        step = TrainStep(model, AdamW(1e-3, fused_state=fused_state),
                         pretraining_loss, amp_dtype="float16",
                         scaler=amp.GradScaler(init_loss_scaling=8.0))
    else:
        model = _model(SMALL, "bfloat16")
        step = TrainStep(model, AdamW(1e-3, fused_state=fused_state),
                         pretraining_loss)
    before = {k: t.data_ptr() for k, t in _state_tensors(step).items()}
    kinds = {k.split(".")[-1] for k in before}
    assert "master" in kinds and {"m", "v"} <= kinds
    assert ("opt.fused.master" in before) == fused_state
    assert ("scaler.scale" in before) == scaled
    first = None
    for i in range(3):
        args, labels = _port_batch(i)
        step(*args, labels=labels)
        now = {k: t.data_ptr() for k, t in _state_tensors(step).items()}
        assert now == before, [k for k in now if now[k] != before[k]]
        if first is None:
            first = {k: t.clone() for k, t in _state_tensors(step).items()}
    assert int(step.state["step"]) == 3
    moved = [k for k, t in _state_tensors(step).items()
             if k.endswith(("master", ".m")) and not torch.equal(t, first[k])]
    assert moved  # the writes land in the tensors that stayed


# -- (b) the captured body against the eager step -----------------------

def _assert_same_params(a, b):
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n


def test_captured_body_equals_the_eager_step_bitwise():
    eager_model, cap_model = _twins()
    opt = dict(learning_rate=1e-3, weight_decay=0.01)
    eager = TrainStep(eager_model, AdamW(**opt), pretraining_loss, seed=3)
    backend = EagerGraphs()
    cap = _compiled(TrainStep(cap_model, AdamW(**opt), pretraining_loss,
                              seed=3), backend)
    for i in range(10):
        args, labels = _port_batch(i)
        want = eager(*args, labels=labels)
        got = cap(*args, labels=labels)
        assert torch.equal(got["loss"], want["loss"]), i
    _assert_same_params(eager_model, cap_model)
    # one capture after the warm-up step, nine replays of its body on the
    # static buffers; the generator advanced as the eager one did
    assert cap.captures == 1 and backend.graphs[0].replays == 9
    assert cap.calls == eager.calls == 10
    assert torch.equal(cap.generator.get_state(),
                       eager.generator.get_state())
    assert int(cap.state["step"]) == 10


def test_outputs_are_clones_a_later_step_does_not_overwrite():
    step = _compiled(TrainStep(_model(), AdamW(1e-3), pretraining_loss))
    losses = []
    for i in range(4):
        args, labels = _port_batch(i)
        out = step(*args, labels=labels)
        losses.append((out["loss"], out["loss"].clone()))
    graph = next(iter(step._graphs.values()))
    for kept, copy in losses:
        assert torch.equal(kept, copy)
        assert kept is not graph.outputs["loss"]


def test_run_steps_through_the_captured_body_equals_calls():
    calls_model, multi_model = _twins()
    metric = {"nsp_mean": lambda out, mlm, nsp: out[1].mean()}
    calls = TrainStep(calls_model, AdamW(1e-3), pretraining_loss,
                      extra_metrics=metric)
    multi = _compiled(TrainStep(multi_model, AdamW(1e-3), pretraining_loss,
                                extra_metrics=metric))
    batches = [_port_batch(i) for i in range(3)]
    want = [calls(*a, labels=lab) for a, lab in batches]
    args = tuple(torch.stack(p) for p in zip(*[a for a, _ in batches]))
    labels = tuple(torch.stack(p) for p in zip(*[lab for _, lab in batches]))
    got = multi.run_steps(*args, labels=labels)
    for k in ("loss", "nsp_mean"):
        assert torch.equal(got[k], torch.stack([w[k] for w in want])), k
    _assert_same_params(calls_model, multi_model)
    assert multi.captures == 1 and multi.calls == 3


def test_a_new_signature_or_flag_captures_again():
    step = _compiled(TrainStep(_model(), AdamW(1e-3), pretraining_loss))
    for i in range(3):
        args, labels = _port_batch(i)
        step(*args, labels=labels)
    assert step.captures == 1
    args, labels = _port_batch(5, t=16)  # another batch shape
    step(*args, labels=labels)
    step(*args, labels=labels)
    assert step.captures == 2
    set_flags({"fused_softmax_xent": True})
    try:
        step(*args, labels=labels)  # another route: never a stale replay
        step(*args, labels=labels)
    finally:
        set_flags({"fused_softmax_xent": False})
    assert step.captures == 3
    step.model.eval()  # another training mode
    step(*args, labels=labels)
    step.model.train()
    assert step.captures == 4
    step(*args, labels=labels)  # back to a known signature: a replay
    assert step.captures == 4 and len(step._graphs) == 4
    step.reset_from_model()
    assert not step._graphs
    step(*args, labels=labels)
    step(*args, labels=labels)
    step.state = step.optimizer.init(step.params)
    assert not step._graphs and step.captures == 5


class _NoOpGraphs:
    """A backend that keeps nothing of the step (as the card's keeps only
    the graph): a replay runs nothing."""

    def warm_up(self, fn):
        return fn()

    def capture(self, fn, generator, table_rows):
        return _Replayer(lambda: None), []


@pytest.mark.parametrize("flags", [{}, {"fused_adam": True,
                                        "fused_softmax_xent": True}])
def test_a_dropped_step_frees_its_graphs_at_once(flags):
    old = {k: False for k in flags}
    set_flags(flags)
    gc.disable()  # freed by reference counts alone: no cycle holds it
    try:
        step = _compiled(TrainStep(
            _model(SMALL), AdamW(port_lr.ReduceOnPlateau(1e-3),
                                 weight_decay=0.01), pretraining_loss,
            extra_metrics={"nsp": lambda out, mlm, nsp: out[1].mean()}),
            _NoOpGraphs())
        for i in range(3):
            args, labels = _port_batch(i)
            step(*args, labels=labels)
        assert step.captures == 1
        graph = weakref.ref(next(iter(step._graphs.values())))
        alive = weakref.ref(step)
        del step
        assert alive() is None and graph() is None
    finally:
        gc.enable()
        set_flags(old)


# -- (c) the captured body against the JAX step -------------------------

def test_ten_step_trajectory_through_the_captured_body_matches_jax():
    pt.seed(0)
    jm = JaxBert(JaxBertConfig(**SMALL))
    pm = BertForPretraining(BertConfig(**SMALL), device="cpu")
    load_jax_params(pm, {k: np.asarray(v)
                         for k, v in jm.param_dict().items()})
    kw = dict(learning_rate=1e-3, weight_decay=0.01,
              apply_decay_param_fun=_no_decay)
    jstep = JaxTrainStep(jm, JaxAdamW(**kw), lambda out, m, n:
                         jax_pretraining_loss(out, m, n))
    pstep = _compiled(TrainStep(pm, AdamW(**kw), pretraining_loss))
    jl, pl = [], []
    for i in range(10):
        ids, types, mask, pos, mlm, nsp = _batch(seed=i)
        jl.append(float(jstep(jnp.asarray(ids), jnp.asarray(types),
                              jnp.asarray(mask), jnp.asarray(pos),
                              labels=(jnp.asarray(mlm),
                                      jnp.asarray(nsp)))["loss"]))
        pl.append(float(pstep(_t(ids), _t(types), _t(mask), _t(pos),
                              labels=(_t(mlm), _t(nsp)))["loss"]))
    assert pstep.captures == 1
    # test_torch_bert.py's ten-step trajectory, its batches and limits
    # (fp32 noise through ten Adam steps)
    assert np.max(np.abs(np.array(pl) - np.array(jl))) <= 1e-5, (pl, jl)
    jstep.sync_to_model()
    own = dict(pm.named_parameters())
    for name, v in jm.param_dict().items():
        if name.endswith("k_proj.bias"):
            continue  # an exactly-zero gradient: both sides step on noise
        assert np.max(np.abs(own[name].detach().numpy()
                             - np.asarray(v))) <= 1e-5, name


# -- (d) the repairs ----------------------------------------------------

def test_compiled_true_on_the_cpu_raises():
    with pytest.raises(ValueError, match="compiled=True"):
        TrainStep(_model(SMALL), AdamW(1e-3), pretraining_loss,
                  compiled=True)
    assert not TrainStep(_model(SMALL), AdamW(1e-3),
                         pretraining_loss).compiled


def test_host_lr_reaches_the_update_through_its_device_tensor():
    eager_model, cap_model = _twins(SMALL)
    scheds = [port_lr.ReduceOnPlateau(1e-3) for _ in range(2)]
    eager = TrainStep(eager_model, AdamW(scheds[0]), pretraining_loss)
    cap = _compiled(TrainStep(cap_model, AdamW(scheds[1]),
                              pretraining_loss))
    seen = []
    real = cap.optimizer.apply_gradients

    def spy(*a, lr_override=None):
        seen.append(lr_override)
        return real(*a, lr_override=lr_override)
    cap.optimizer.apply_gradients = spy
    ptr = cap.host_lr.data_ptr()
    for i, rate in enumerate([1e-3, 1e-3, 2.5e-4, 2.5e-4]):
        for s in scheds:
            s.current_lr = rate
        args, labels = _port_batch(i)
        eager(*args, labels=labels)
        cap(*args, labels=labels)
        assert float(cap.host_lr) == np.float32(rate)
    # the captured body reads the one tensor, rewritten before each step
    assert cap.captures == 1 and cap.host_lr.data_ptr() == ptr
    assert all(t is cap.host_lr for t in seen)
    _assert_same_params(eager_model, cap_model)
    # and the change moved the update: a run from the same weights held
    # at 1e-3 ends elsewhere
    held_model = _model(SMALL)
    held = TrainStep(held_model, AdamW(1e-3), pretraining_loss)
    for i in range(4):
        args, labels = _port_batch(i)
        held(*args, labels=labels)
    assert not all(torch.equal(p, q) for p, q in zip(
        held_model.parameters(), cap_model.parameters()))


@pytest.mark.parametrize("sched", [
    lambda: port_lr.PiecewiseDecay([3, 6], [0.1, 0.05, 0.01]),
    lambda: port_lr.MultiStepDecay(0.1, milestones=[2, 5], gamma=0.5)])
def test_step_indexed_schedulers_build_their_tables_once(sched,
                                                         monkeypatch):
    s = sched()
    want = [float(s.lr_at(torch.tensor(i, dtype=torch.int32)))
            for i in range(8)]
    built = []
    real = torch.tensor

    def counting(*a, **kw):
        built.append(a)
        return real(*a, **kw)
    monkeypatch.setattr(torch, "tensor", counting)
    fresh = sched()
    step = torch.zeros((), dtype=torch.int32)
    got = []
    for i in range(8):
        step.fill_(i)
        got.append(float(fresh.lr_at(step)))
        if i == 0:
            first = len(built)
    assert first >= 1 and len(built) == first, built
    assert got == want


def _leaves(n=3, sizes=(5, 9000, 17)):
    gen = torch.Generator().manual_seed(0)
    return [[torch.randn(k, generator=gen) for k in sizes]
            for _ in range(4)]


def test_adam_leaf_rows_are_the_kernels_table():
    p, g, m, v = _leaves()
    rows, chunks = fused_adam.leaf_rows(p, g, m, v, [True, False, True])
    assert chunks == 1 + 2 + 1  # 8192 elements a chunk
    assert rows[1] == (p[1].data_ptr(), g[1].data_ptr(), m[1].data_ptr(),
                       v[1].data_ptr(), 9000, 1, 0, 0)
    assert [r[5] for r in rows] == [0, 1, 3]
    with pytest.raises(TypeError, match="contiguous float32"):
        fused_adam.leaf_rows(p, g, m, [t.double() for t in v],
                             [True] * 3)


def test_adam_leaf_table_is_built_once_per_set_of_pointers():
    fused_adam._tables.clear()
    cpu = torch.device("cpu")
    p, g, m, v = _leaves()
    rows, _ = fused_adam.leaf_rows(p, g, m, v, [True] * 3)
    built = fused_adam.table_builds
    table = fused_adam.leaf_table(rows, cpu)
    assert table.tolist() == [list(r) for r in rows]
    for _ in range(3):
        assert fused_adam.leaf_table(rows, cpu) is table
    assert fused_adam.table_builds == built + 1
    # new gradients at new addresses: a new table
    g2 = [t.clone() for t in g]
    rows2, _ = fused_adam.leaf_rows(p, g2, m, v, [True] * 3)
    assert fused_adam.leaf_table(rows2, cpu) is not table
    assert fused_adam.table_builds == built + 2
    # bounded: the oldest go first
    keep = [t.clone() for t in g]
    for i in range(fused_adam.TABLES_KEPT):
        keep[0] = keep[0].clone()
        r, _ = fused_adam.leaf_rows(p, keep, m, v, [True] * 3)
        fused_adam.leaf_table(r, cpu)
    assert len(fused_adam._tables) == fused_adam.TABLES_KEPT
    assert fused_adam.leaf_table(rows, cpu) is not table
    fused_adam._tables.clear()


def test_adam_leaf_tables_made_in_a_capture_are_filled_after_it():
    cpu = torch.device("cpu")
    p, g, m, v = _leaves()
    rows, _ = fused_adam.leaf_rows(p, g, m, v, [True] * 3)
    rows2, _ = fused_adam.leaf_rows(p[:2], g[:2], m[:2], v[:2], [False] * 2)
    built = fused_adam.table_builds
    with fused_adam.captured_tables(6, cpu) as tables:
        # rows of one buffer made before the capture (outside the graph's
        # pool, whose memory a replay reuses), one table after another
        table = fused_adam.leaf_table(rows, cpu)
        table2 = fused_adam.leaf_table(rows2, cpu)
        assert not tables  # filled only once the capture is over
        assert table2.data_ptr() == table.data_ptr() + 3 * 8 * 8
        with pytest.raises(RuntimeError, match="too few rows"):
            fused_adam.leaf_table(rows2, cpu)
    assert tables == [table, table2]
    assert table.tolist() == [list(r) for r in rows]
    assert table2.tolist() == [list(r) for r in rows2]
    # owned by the capture, not kept in the shared cache
    assert fused_adam.table_builds == built
    assert all(t.data_ptr() != table.data_ptr()
               for t in fused_adam._tables.values())


def test_a_replay_adds_its_graphs_launches_once():
    graph = port_static._Graph(((), (), {}))
    graph.graph = _Replayer(lambda: None)
    graph.launches = {"layer_norm": 26, "adam_leaf": 1}
    kernels.reset_launch_counts()
    try:
        for n in range(1, 4):
            graph.replay(((), (), {}))
            counts = kernels.launch_counts()
            assert counts["layer_norm"] == 26 * n
            assert counts["adam_leaf"] == n
            assert sum(counts.values()) == 27 * n
    finally:
        kernels.reset_launch_counts()


def test_the_capture_takes_back_what_it_counted():
    backend = EagerGraphs(count={"layer_norm": 6, "flash_attention_fwd": 2})
    step = _compiled(TrainStep(_model(SMALL), AdamW(1e-3),
                               pretraining_loss), backend)
    kernels.reset_launch_counts()
    try:
        args, labels = _port_batch(0)
        step(*args, labels=labels)  # warm-up (plain versions: 0) + capture
        assert not any(kernels.launch_counts().values())
        graph = next(iter(step._graphs.values()))
        assert graph.launches == {"layer_norm": 6, "flash_attention_fwd": 2}
        for n in range(1, 3):
            step(*args, labels=labels)
            counts = kernels.launch_counts()
            assert counts["layer_norm"] == 6 * n
            assert counts["flash_attention_fwd"] == 2 * n
    finally:
        kernels.reset_launch_counts()
