"""PyTorch port: the static programming model (``static.Scope``,
``Program``, ``Executor``) against the JAX package on the CPU.

``Scope`` lookups and errors (the JAX error class by name), in-place
``set_var``; ``Program.run``/``clone(for_test=True)``; ``Executor.run``
feeds and fetches against the JAX executor on the same program (one
function written with operators both array types have), the captured
program (a stand-in for the CUDA graph backend, as
``test_torch_compiled_step.py`` runs it) against the eager one;
``check_nan_inf``'s message equal to JAX's; ``train_from_dataset``'s
epoch losses against JAX's from the same slot files (a small BERT, 3
steps an epoch, within ``LOSS_TOL``); ``infer_from_dataset``'s dump
text equal to JAX's."""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import contextlib
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as pt  # noqa: E402
from paddle_tpu import data as jdata  # noqa: E402
from paddle_tpu import static as jstatic  # noqa: E402
from paddle_tpu.models import BertConfig as JaxBertConfig  # noqa: E402
from paddle_tpu.models import BertForPretraining as JaxBert  # noqa: E402
from paddle_tpu.models import pretraining_loss as j_loss  # noqa: E402
from paddle_tpu.optimizer import Adam as JaxAdam  # noqa: E402

from paddle_tpu_torch import data as pdata  # noqa: E402
from paddle_tpu_torch import errors, set_flags, static  # noqa: E402
from paddle_tpu_torch.convert import load_jax_params  # noqa: E402
from paddle_tpu_torch.models import (BertConfig,  # noqa: E402
                                     BertForPretraining, pretraining_loss)
from paddle_tpu_torch.nn import Dropout, Linear  # noqa: E402
from paddle_tpu_torch.optimizer import Adam  # noqa: E402

SMALL = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=64,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             max_position_embeddings=32)
B, T, STEPS = 4, 16, 3
# 3 fp32 Adam steps of a 2-layer BERT, summed in another order than XLA's
LOSS_TOL = 1e-5


class _Replayer:
    def __init__(self, body) -> None:
        self.body = body

    def replay(self) -> None:
        self.body()


class EagerGraphs:
    """The CUDA graph backend's stand-in on the CPU (warm-up runs, the
    capture keeps the body, a replay runs it on the static inputs)."""

    def __init__(self) -> None:
        self.graphs = []

    def warm_up(self, fn):
        return fn()

    def capture(self, fn, generator=None, table_rows=0):
        self.graphs.append(_Replayer(fn))
        return self.graphs[-1], []

    def host_sync_check(self, what):
        return contextlib.nullcontext()


def test_scope_lookups_and_errors():
    for S, E in ((static.Scope, errors.NotFoundError),
                 (jstatic.Scope, pt.errors.NotFoundError)):
        root = S()
        root.set_var("a", 1)
        kid = root.new_scope()
        kid.var("b", 2)
        assert kid.find_var("a") == 1 and kid.has_var("a")
        assert not root.has_var("b")
        assert kid.local_var_names() == ["b"]
        assert kid.var("b", 5) == 2  # var() never overwrites
        with pytest.raises(E, match="'zz' not found in scope chain") as ei:
            kid.find_var("zz")
        assert type(ei.value).__name__ == "NotFoundError"
        assert ei.value.code == "NOT_FOUND"
        root.drop_kids()
        assert root.as_dict() == {"a": 1}
    assert static.global_scope() is static.global_scope()


def test_scope_set_var_is_in_place():
    s = static.Scope()
    held = torch.zeros(3)
    s.set_var("w", held)
    s.set_var("w", torch.ones(3))
    assert s.find_var("w") is held and float(held.sum()) == 3.0
    s.set_var("w", np.full(3, 2.0, np.float32))
    assert s.find_var("w") is held and float(held.sum()) == 6.0
    s.set_var("w", torch.ones(4))  # another shape replaces it
    assert s.find_var("w") is not held and s.find_var("w").shape == (4,)


def _fn(state, feeds):
    w = state["w"]
    y = feeds["x"] * w + state["b"]
    return {"w": w * 0.5 + 1.0, "b": state["b"]}, {
        "y": y, "total": y.sum(), "parts": [y.max(), y.min()]}


def _scopes(j=True):
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = np.ones(3, np.float32)
    js = jstatic.Scope()
    js.set_var("w", jnp.asarray(w))
    js.set_var("b", jnp.asarray(b))
    ps = static.Scope()
    ps.set_var("w", torch.from_numpy(w.copy()))
    ps.set_var("b", torch.from_numpy(b.copy()))
    return js, ps


@pytest.mark.parametrize("captured", [False, True])
def test_executor_run_matches_jax(captured):
    js, ps = _scopes()
    jprog = jstatic.Program(_fn, state_names=["w", "b"])
    prog = static.Program(_fn, state_names=["w", "b"])
    if captured:
        prog.compiled, prog._backend = True, EagerGraphs()
    held = ps.find_var("w")
    jexe, exe = jstatic.Executor(), static.Executor("cpu")
    x = np.random.default_rng(0).normal(size=(2, 3)).astype(np.float32)
    for step in range(3):
        want = jexe.run(jprog, {"x": x + step}, ["y", "total", "parts"],
                        scope=js)
        got = exe.run(prog, {"x": x + step}, ["y", "total", "parts"],
                      scope=ps)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g, w, rtol=1e-6)
        np.testing.assert_allclose(ps.find_var("w").numpy(),
                                   np.asarray(js.find_var("w")))
    assert ps.find_var("w") is held  # the state was written in place
    assert prog.captures == (1 if captured else 0)
    # whole fetch dicts, and tensors with return_numpy=False
    out = exe.run(prog, {"x": x}, scope=ps, return_numpy=False)
    assert set(out) == {"y", "total", "parts"}
    assert isinstance(out["y"], torch.Tensor)


def test_check_nan_inf_message_equals_jax():
    js, ps = _scopes()
    jprog = jstatic.Program(_fn, state_names=["w", "b"], name="acc")
    prog = static.Program(_fn, state_names=["w", "b"], name="acc")
    bad = np.array([[1.0, np.inf, 1.0], [1.0, 1.0, 1.0]], np.float32)
    pt.set_flags({"check_nan_inf": True})
    set_flags({"check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError) as jerr:
            jstatic.Executor().run(jprog, {"x": bad}, scope=js)
        with pytest.raises(FloatingPointError) as perr:
            static.Executor("cpu").run(prog, {"x": bad}, scope=ps)
        assert str(perr.value) == str(jerr.value)
        assert "FLAGS_check_nan_inf" in str(perr.value)
        ok = np.ones((2, 3), np.float32)
        static.Executor("cpu").run(prog, {"x": ok}, scope=ps)
    finally:
        pt.set_flags({"check_nan_inf": False})
        set_flags({"check_nan_inf": False})
    # off: no check
    static.Executor("cpu").run(prog, {"x": bad}, scope=ps)


def test_program_clone_for_test_disables_dropout():
    torch.manual_seed(0)
    net = torch.nn.Sequential(Linear(8, 8, device="cpu"), Dropout(0.9))
    net.train()

    def fn(state, feeds):
        return state, {"out": net(feeds["x"])}

    prog = static.Program(fn, name="p")
    test_prog = prog.clone(for_test=True)
    assert test_prog.name == "p_test"
    x = {"x": torch.ones(4, 8)}
    _, f1 = test_prog.run({}, x)
    _, f2 = test_prog.run({}, x)
    assert torch.equal(f1["out"], f2["out"])
    assert float(f1["out"].abs().sum()) > 0 and net.training
    _, g1 = prog.clone().run({}, x)
    assert float((g1["out"] == 0).float().mean()) > 0.5


def test_data_and_default_main_program():
    spec = static.data("x", [-1, 5], "int64")
    jspec = jstatic.data("x", [-1, 5], "int64")
    assert tuple(spec.shape) == tuple(jspec.shape) == (1, 5)
    assert spec.dtype == torch.int64 and spec.device.type == "meta"
    for mod in (static, jstatic):
        with pytest.raises(NotImplementedError, match="Program"):
            mod.default_main_program()


# ---------------------------------------------------------------------------
# the dataset-driven loops
# ---------------------------------------------------------------------------

SLOTS = [("ids", "sparse", T), ("mlm", "sparse", T), ("nsp", "sparse", 1)]


@pytest.fixture
def slot_files(tmp_path):
    rng = np.random.default_rng(3)
    files = []
    for part in range(2):
        p = tmp_path / f"part-{part}"
        with open(p, "w") as f:
            for _ in range(B * STEPS // 2):
                ids = rng.integers(1, 128, T)
                mlm = np.where(rng.random(T) < 0.3, ids, -100)
                nsp = rng.integers(0, 2, 1)
                f.write(" ".join(f"{len(v)} " + " ".join(map(str, v))
                                 for v in (ids, mlm, nsp)) + "\n")
        files.append(str(p))
    return files


def _dataset(mod, files, batch=B):
    ds = mod.InMemoryDataset()
    ds.set_slots(SLOTS)
    ds.set_batch_size(batch)
    ds.set_thread(1)
    ds.set_filelist(files)
    ds.load_into_memory()
    return ds


def test_train_from_dataset_matches_jax(slot_files):
    pt.seed(0)
    jm = JaxBert(JaxBertConfig(**SMALL))
    pm = BertForPretraining(BertConfig(**SMALL), device="cpu")
    load_jax_params(pm, {k: np.asarray(v)
                         for k, v in jm.param_dict().items()})

    def loss_fn(loss):
        return lambda out, mlm, nsp: loss(out, mlm, nsp.reshape(-1))

    jstep = jstatic.TrainStep(jm, JaxAdam(1e-3), loss_fn(j_loss))
    step = static.TrainStep(pm, Adam(1e-3), loss_fn(pretraining_loss))
    want = jstatic.Executor().train_from_dataset(
        jstep, _dataset(jdata, slot_files), input_slots=["ids"],
        label_slots=["mlm", "nsp"], epochs=2)
    seen = []
    got = static.Executor("cpu").train_from_dataset(
        step, _dataset(pdata, slot_files), input_slots=["ids"],
        label_slots=["mlm", "nsp"], epochs=2,
        fetch_handler=lambda m: seen.append(float(m["loss"])))
    assert len(seen) == 2 * STEPS
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert got[1] < got[0]
    # the epoch mean is the mean of the steps' losses
    np.testing.assert_allclose(got[0], np.mean(seen[:STEPS]), rtol=1e-6)


def test_train_from_dataset_drops_the_short_batch(slot_files):
    calls = []

    def step(*args, labels=()):
        calls.append(args[0].shape[0])
        return {"loss": torch.tensor(1.0)}

    ds = _dataset(pdata, slot_files, batch=5)  # 12 rows: 5, 5, 2
    hist = static.Executor("cpu").train_from_dataset(
        step, ds, epochs=1)
    assert calls == [5, 5] and hist == [1.0]
    calls.clear()
    static.Executor("cpu").train_from_dataset(step, ds, drop_last=False)
    assert calls == [5, 5, 2]


def test_infer_from_dataset_dump_equals_jax(slot_files, tmp_path):
    def jprog(ids):
        return {"score": jnp.asarray(ids, jnp.float32).mean(1) / 7.0,
                "aux": jnp.asarray(1.0)}

    def prog(ids):
        return {"score": ids.float().mean(1) / 7.0, "aux": torch.tensor(1.)}

    texts = []
    for mod, exe, fn in ((jdata, jstatic.Executor(), jprog),
                         (pdata, static.Executor("cpu"), prog)):
        ds = _dataset(mod, slot_files, batch=5)
        path = str(tmp_path / mod.__name__ / "dump" / "part-0")
        outs = exe.infer_from_dataset(fn, ds, input_slots=["ids"],
                                      drop_last=True,
                                      dump_fields=["ids", "nsp"],
                                      dump_fields_path=path)
        assert len(outs) == 2
        texts.append(open(path).read())
    assert texts[0] == texts[1] and texts[0].count("\n") == 10
    with pytest.raises(ValueError, match="dump_fields_path"):
        static.Executor("cpu").infer_from_dataset(
            prog, _dataset(pdata, slot_files), dump_fields=["ids"])
