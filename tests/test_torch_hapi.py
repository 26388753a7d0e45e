"""PyTorch port: ``hapi.Model`` (fit, evaluate, predict, train_batch,
save/load, callbacks, resume, preemption, rollback) and the SGD /
Momentum optimizers, against the JAX package on the CPU.

The JAX ``tests/test_hapi.py`` cases run in both packages: the same MLP
(weights moved across with ``convert.load_jax_params``), the same data
in the same order (both samplers are numpy's seeded ``default_rng``).
fp32 on both sides, a few Adam steps: the per-epoch history and the
weights agree within ``TOL``. The same holds for the slice as a whole, a
2-layer hidden-64 BERT pretrained through ``Model.fit`` with the MLM and
NSP labels packed into one label. What only the port has (a resume bit
for bit, SIGTERM in a subprocess, the rollback drill, the metrics) is
checked on the port alone.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as pt  # noqa: E402
from paddle_tpu import io as jax_io  # noqa: E402
from paddle_tpu.hapi import Model as JaxModel  # noqa: E402

import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu_torch import data, io, metric, nn  # noqa: E402
from paddle_tpu_torch import observability as obs  # noqa: E402
from paddle_tpu_torch.convert import (load_jax_params,  # noqa: E402
                                      opt_state_from_jax,
                                      train_state_to_jax)
from paddle_tpu_torch.hapi import (Callback, EarlyStopping,  # noqa: E402
                                   LRSchedulerCallback, Model)
from paddle_tpu_torch.ops.loss import cross_entropy  # noqa: E402
from paddle_tpu_torch.optimizer import SGD, Adam, Momentum  # noqa: E402
from paddle_tpu_torch.optimizer.lr import ReduceOnPlateau  # noqa: E402
from paddle_tpu_torch.testing import faults  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32 on both sides, a dozen optimizer steps of sums in another order
TOL = 1e-5


class JaxMLP(pt.nn.Layer):
    def __init__(self, n_cls=4):
        super().__init__()
        self.fc1 = pt.nn.Linear(8, 32)
        self.fc2 = pt.nn.Linear(32, n_cls)

    def forward(self, x):
        return self.fc2(pt.nn.functional.relu(self.fc1(x)))


class MLP(torch.nn.Module):
    def __init__(self, n_cls=4):
        super().__init__()
        self.fc1 = nn.Linear(8, 32, device="cpu")
        self.fc2 = nn.Linear(32, n_cls, device="cpu")

    def forward(self, x):
        return self.fc2(nn.functional.relu(self.fc1(x)))


def _data(n=128, n_cls=4, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 2, (n_cls, 8)).astype(np.float32)
    y = rng.integers(0, n_cls, n)
    x = means[y] + 0.1 * rng.standard_normal((n, 8)).astype(np.float32)
    return x.astype(np.float32), y.astype(np.int64)


def _loaders(arrays, batch_size=32, seed=0):
    """The JAX and the port DataLoader over the same arrays, each with a
    seeded shuffle (the same order)."""
    out = []
    for pkg in (pt.data, data):
        ds = pkg.TensorDataset(*arrays)
        out.append(pkg.DataLoader(ds, batch_sampler=pkg.BatchSampler(
            pkg.RandomSampler(ds, seed=seed), batch_size=batch_size)))
    return out


def _pair(opt="adam", lr=1e-2):
    """A JAX and a port Model over the same MLP weights."""
    pt.seed(0)
    jnet, pnet = JaxMLP(), MLP()
    load_jax_params(pnet, {k: np.asarray(v)
                           for k, v in jnet.param_dict().items()})
    jopt = {"adam": pt.optimizer.Adam, "sgd": pt.optimizer.SGD}[opt]
    popt = {"adam": Adam, "sgd": SGD}[opt]
    jm, pm = JaxModel(jnet), Model(pnet)
    jm.prepare(optimizer=jopt(learning_rate=lr),
               loss=pt.nn.CrossEntropyLoss(),
               metrics=[pt.metric.Accuracy()])
    pm.prepare(optimizer=popt(learning_rate=lr), loss=nn.CrossEntropyLoss(),
               metrics=[metric.Accuracy()])
    return jm, pm


def _weights_close(jnet, pnet, tol=TOL):
    own = pnet.state_dict()
    for k, v in jnet.param_dict().items():
        assert np.max(np.abs(own[k].numpy() - np.asarray(v))) <= tol, k


def _close(a, b, tol=TOL):
    assert set(a) == set(b)
    for k in a:
        assert np.allclose(a[k], b[k], rtol=0, atol=tol), (k, a[k], b[k])


@pytest.fixture(autouse=True)
def _clean_state():
    yield
    faults.configure(None)
    ptt.set_flags({"enable_metrics": False, "divergence_streak": 5,
                   "rollback_budget": 2})
    obs.reset_all()


# -- the JAX test_hapi.py cases in both packages ---------------------------

def test_fit_history_weights_and_evaluate_match_jax():
    jm, pm = _pair()
    jl, pl = _loaders(_data())
    hj = jm.fit(jl, epochs=3, verbose=0)
    hp = pm.fit(pl, epochs=3, verbose=0)
    assert set(hp) == set(hj) == {"loss", "acc"}
    _close(hp, hj)
    assert hp["loss"][-1] < hp["loss"][0]
    _weights_close(jm.network, pm.network)
    ej, ep = jm.evaluate(jl, verbose=0), pm.evaluate(pl, verbose=0)
    assert set(ep) == set(ej) == {"eval_loss", "eval_accuracy"}
    _close(ep, ej)
    assert ep["eval_accuracy"] > 0.9


def test_train_batch_and_predict_match_jax():
    jm, pm = _pair()
    x, y = _data(16, seed=3)
    rj, rp = jm.train_batch(x, y), pm.train_batch(x, y)
    assert isinstance(rp["loss"], float)
    _close(rp, rj)
    _weights_close(jm.network, pm.network)
    jl, pl = _loaders(_data(40, seed=4), batch_size=16)
    outj, outp = jm.predict(jl), pm.predict(pl)
    # one numpy output per batch, the last one partial
    assert [o.shape for o in outp] == [np.shape(o) for o in outj] \
        == [(16, 4), (16, 4), (8, 4)]
    for a, b in zip(outp, outj):
        assert isinstance(a, np.ndarray)
        assert np.max(np.abs(a - np.asarray(b))) <= TOL


def test_early_stopping_matches_jax():
    jm, pm = _pair(opt="sgd", lr=0.0)
    jl, pl = _loaders(_data())
    hj = jm.fit(jl, epochs=10, verbose=0, callbacks=[
        pt.hapi.EarlyStopping(monitor="loss", patience=1, mode="min")])
    hp = pm.fit(pl, epochs=10, verbose=0,
                callbacks=[EarlyStopping(monitor="loss", patience=1)])
    assert len(hp["loss"]) == len(hj["loss"]) < 10
    _close(hp, hj)


def test_summary_counts_the_parameters_like_jax(capsys):
    jm, pm = _pair()
    ts = [text.splitlines()[-1] for text in (jm.summary(), pm.summary())]
    assert ts[0] == ts[1] == "Total params: 420"
    assert len(pm.parameters()) == 4
    capsys.readouterr()


def test_save_load_roundtrip_across_packages(tmp_path):
    jm, pm = _pair()
    jl, pl = _loaders(_data())
    pm.fit(pl, epochs=2, verbose=0)
    acc = pm.evaluate(pl, verbose=0)
    pm.save(str(tmp_path / "port"))
    # the port's .pdparams into a JAX Model, and back into a fresh port one
    jm.load(str(tmp_path / "port"))
    _weights_close(jm.network, pm.network, tol=0.0)
    _close(jm.evaluate(jl, verbose=0), acc)
    _, pm2 = _pair()
    pm2.load(str(tmp_path / "port"))
    assert pm2.evaluate(pl, verbose=0) == acc
    # a .pdparams the JAX Model wrote loads into the port's Model
    jm2, pm3 = _pair()
    jm2.fit(jl, epochs=1, verbose=0)
    jm2.save(str(tmp_path / "jax"))
    pm3.load(str(tmp_path / "jax"))
    _weights_close(jm2.network, pm3.network, tol=0.0)


def test_batch_logs_are_device_tensors_and_epoch_logs_floats():
    seen, epochs = [], []

    class Spy(Callback):
        def on_batch_end(self, step, logs=None):
            seen.append(logs)

        def on_epoch_end(self, epoch, logs=None):
            epochs.append(dict(logs))

    _, pm = _pair()
    pm.fit(_loaders(_data())[1], epochs=2, verbose=0, callbacks=[Spy()])
    assert len(seen) == 8 and len(epochs) == 2
    # no host sync per step: the batch metrics stay tensors
    assert all(isinstance(v, torch.Tensor) for logs in seen
               for v in logs.values())
    assert all(isinstance(v, float) for logs in epochs
               for v in logs.values())


def test_weight_mutation_after_fit_is_visible():
    _, pm = _pair()
    pl = _loaders(_data())[1]
    pm.fit(pl, epochs=2, verbose=0)
    assert pm.evaluate(pl, verbose=0)["eval_accuracy"] > 0.9
    with torch.no_grad():
        for p in pm.network.parameters():
            p.data = torch.zeros_like(p)  # new storage
    assert pm.evaluate(pl, verbose=0)["eval_accuracy"] < 0.6
    # the next fit trains the new storage
    pm.fit(pl, epochs=1, verbose=0)
    assert float(pm.network.fc2.bias.detach().abs().sum()) > 0


def test_prepare_refuses_a_mesh_and_unknown_kwargs():
    m = Model(MLP())
    with pytest.raises(TypeError):
        m.prepare(optimzer=Adam())  # a typo must not be eaten
    with pytest.raises(TypeError):
        m.prepare(zero_stage=1)  # a mesh option without a mesh
    # a mesh and its options are taken, as the JAX Model takes them (the
    # sharded fit: tests/test_torch_parallel.py)
    mesh = object()
    assert m.prepare(mesh=mesh, dp_axis="dp") is m
    assert (m._mesh, m._mesh_kwargs) == (mesh, {"dp_axis": "dp"})


def test_fit_amp_options():
    _, pm = _pair()
    pl = _loaders(_data())[1]
    pm.fit(pl, epochs=1, verbose=0, amp="float16")
    assert pm._train_step.scaler is not None
    assert pm._train_step.amp_dtype == "float16"
    pm.fit(pl, epochs=1, verbose=0, amp="bfloat16")
    assert pm._train_step.scaler is None
    with pytest.raises(ValueError, match="amp"):
        pm.fit(pl, epochs=1, verbose=0, amp="int8")


# -- BERT pretraining through Model.fit, the slice as a whole ----------------

SMALL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=128,
             max_position_embeddings=64)
NB, T, NP = 4, 32, 6


def _bert_samples(n=8, seed=0):
    """ids, types, mask, masked positions and the packed label (MLM
    labels, then NSP) per sample, int64."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (n, T))
    types = (np.arange(T)[None] >= rng.integers(8, 24, n)[:, None])
    mask = np.ones((n, T))
    mask[::3, 26:] = 0
    pos = np.sort(rng.permuted(np.broadcast_to(np.arange(24), (n, 24)),
                               axis=1)[:, :NP], axis=1)
    label = np.concatenate([rng.integers(0, 512, (n, NP)),
                            rng.integers(0, 2, (n, 1))], axis=1)
    label[0, 1] = -100
    return [a.astype(np.int64) for a in (ids, types, mask, pos, label)]


def _port_bert(dropout):
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    return BertForPretraining(BertConfig(
        **SMALL, hidden_dropout_prob=dropout,
        attention_probs_dropout_prob=dropout), device="cpu", seed=0)


def _packed(out, label):
    from paddle_tpu_torch.models import pretraining_loss
    return pretraining_loss(out, label[:, :-1], label[:, -1])


def test_bert_pretraining_through_fit_matches_jax():
    from paddle_tpu.models import BertConfig as JaxBertConfig
    from paddle_tpu.models import BertForPretraining as JaxBert
    from paddle_tpu.models import pretraining_loss as jax_loss
    from paddle_tpu_torch.optimizer import AdamW
    pt.seed(0)
    jnet = JaxBert(JaxBertConfig(**SMALL, hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0))
    pnet = _port_bert(0.0)
    load_jax_params(pnet, {k: np.asarray(v)
                           for k, v in jnet.param_dict().items()})
    jm = JaxModel(jnet, loss=lambda out, lab: jax_loss(
        out, lab[:, :-1], lab[:, -1]),
        optimizer=pt.optimizer.AdamW(1e-3, weight_decay=0.01))
    pm = Model(pnet, loss=_packed, optimizer=AdamW(1e-3, weight_decay=0.01))
    jl, pl = _loaders(_bert_samples(), batch_size=NB)
    hj = jm.fit(jl, epochs=2, verbose=0)
    hp = pm.fit(pl, epochs=2, verbose=0)
    _close(hp, hj)
    own = dict(pnet.named_parameters())
    for name, v in jnet.param_dict().items():
        if name.endswith("k_proj.bias"):
            # an exactly-zero gradient: only fp32 noise, which Adam turns
            # into steps of up to lr (tests/test_torch_bert.py)
            continue
        assert np.max(np.abs(own[name].detach().numpy()
                             - np.asarray(v))) <= TOL, name
    _close(pm.evaluate(pl, verbose=0), jm.evaluate(jl, verbose=0))


def _bert_model(dropout=0.1):
    from paddle_tpu_torch.optimizer import AdamW
    return Model(_port_bert(dropout), loss=_packed,
                 optimizer=AdamW(1e-3, weight_decay=0.01, fused_state=True))


def _bert_loader(workers=0):
    ds = data.TensorDataset(*_bert_samples(16, seed=1))
    return data.DataLoader(ds, batch_sampler=data.BatchSampler(
        data.RandomSampler(ds, seed=0), batch_size=NB),
        num_workers=workers, timeout=60.0)


def _leaves(model):
    return {k: v.detach().clone()
            for k, v in io.flatten(model._train_step.state_dict()).items()}


def test_bert_fit_resumed_equals_uninterrupted_and_bare_step(tmp_path):
    """The chip phase's check at 2 layers, hidden 64, dropout 0.1: an
    interrupted fit resumed through ``iter_from`` (2 workers), an
    uninterrupted fit and a bare ``TrainStep`` over the same batches end
    bit for bit alike."""
    from paddle_tpu_torch.models import pretraining_loss
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.static import TrainStep

    class Losses(Callback):
        def __init__(self):
            self.seen = []

        def on_batch_end(self, step, logs=None):
            self.seen.append(float(logs["loss"]))

    full, rec = _bert_model(), Losses()
    full.fit(_bert_loader(), epochs=2, verbose=0, callbacks=[rec])
    d = str(tmp_path / "ck")
    first, second = Losses(), Losses()
    _bert_model().fit(_bert_loader(2), epochs=1, verbose=0, ckpt_dir=d,
                      save_steps=2, callbacks=[first])
    ck = io.AsyncCheckpointer(d)
    assert ck.intact_steps() == [2, 4]
    assert ck.host_state()["batch_in_epoch"] == 3
    resumed = _bert_model()
    resumed.fit(_bert_loader(2), epochs=2, verbose=0, ckpt_dir=d,
                save_steps=2, callbacks=[second])
    assert first.seen + second.seen == rec.seen and len(rec.seen) == 8
    want = _leaves(full)
    got = _leaves(resumed)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    step = TrainStep(_port_bert(0.1), AdamW(1e-3, weight_decay=0.01,
                                            fused_state=True),
                     pretraining_loss)
    loader = _bert_loader()
    bare = [float(step(*b[:4], labels=(b[4][:, :-1], b[4][:, -1]))["loss"])
            for _ in range(2) for b in loader]
    assert bare == rec.seen
    theirs = {k: v for k, v in io.flatten(step.state_dict()).items()}
    assert all(torch.equal(theirs[k], want[k]) for k in want)


# -- SGD and Momentum against JAX -------------------------------------------

SHAPES = {"fc.weight": (12, 8), "fc.bias": (8,), "emb.weight": (30, 4)}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["sgd", "momentum", "nesterov"])
@pytest.mark.parametrize("decay", [None, 0.01])
def test_sgd_and_momentum_ten_steps_match_jax(kind, decay, fused):
    """5 steps in JAX, the state carried into the port with ``convert``,
    5 more steps in both; then the port's state back to JAX's layout."""
    rng = np.random.default_rng(3)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(10)]
    kw = dict(learning_rate=0.05, weight_decay=decay, fused_state=fused)
    if kind != "sgd":
        kw.update(momentum=0.9, use_nesterov=kind == "nesterov")
    jcls = pt.optimizer.SGD if kind == "sgd" else pt.optimizer.Momentum
    pcls = SGD if kind == "sgd" else Momentum
    jopt, popt = jcls(**kw), pcls(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    for g in grads[:5]:
        jp, jstate = jopt.apply_gradients(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jstate)
    pp = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jp.items()}
    pstate = opt_state_from_jax(jax.tree.map(np.asarray, jstate), pp)
    if kind != "sgd" and not fused:
        assert set(pstate["slots"]["fc.bias"]) == {"velocity"}
    for g in grads[5:]:
        jp, jstate = jopt.apply_gradients(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jstate)
        popt.apply_gradients(pp, {k: torch.from_numpy(v)
                                  for k, v in g.items()}, pstate)
    for k in SHAPES:
        assert np.max(np.abs(pp[k].numpy() - np.asarray(jp[k]))) <= 1e-6
    assert int(pstate["step"]) == int(jstate["step"]) == 10
    back = train_state_to_jax({"opt": pstate})["opt"]
    for path, theirs in jax.tree_util.tree_leaves_with_path(jstate):
        mine = back
        for key in path:
            mine = mine[key.key]
        assert np.max(np.abs(np.asarray(mine, np.float32)
                             - np.asarray(theirs, np.float32))) <= 1e-6


def test_sgd_skip_guard_keeps_everything():
    p = {"w": torch.ones(3)}
    opt = Momentum(0.1)
    state = opt.init(p)
    opt.apply_gradients(p, {"w": torch.ones(3)}, state,
                        ok=torch.tensor(False))
    assert torch.equal(p["w"], torch.ones(3))
    assert float(state["slots"]["w"]["velocity"].abs().sum()) == 0
    assert int(state["step"]) == 0


# -- what the port's fit does on its own ------------------------------------

def _make_model():
    net = nn.Linear(4, 2, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    return Model(net, loss=cross_entropy, optimizer=SGD(learning_rate=0.1))


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(8, 4)).astype(np.float32),
             rng.integers(0, 2, (8,)).astype(np.int64)) for _ in range(n)]


def test_fit_step_granular_resume_and_fast_forward(tmp_path):
    d = str(tmp_path / "ck")
    batches = _batches(6)
    full = _make_model()
    full.fit(batches, epochs=1, verbose=0)
    _make_model().fit(batches[:4], epochs=1, verbose=0, ckpt_dir=d,
                      save_steps=2)
    ck = io.AsyncCheckpointer(d)
    assert ck.latest_step() == 4 and ck.verify() == []
    ran = []

    class CB(Callback):
        def on_batch_end(self, step, logs=None):
            ran.append(step)

    resumed = _make_model()
    resumed.fit(batches, epochs=1, verbose=0, ckpt_dir=d, save_steps=2,
                callbacks=[CB()])
    # the restored steps 0-3 were replayed without compute or callbacks
    assert ran == [4, 5]
    assert ck.latest_step() == 6
    for k, v in full.network.state_dict().items():
        assert torch.equal(resumed.network.state_dict()[k], v), k


def test_fit_loader_fault_surfaces():
    faults.configure("loader:step=1:exc=OSError")
    with pytest.raises(OSError, match="fault injected"):
        _make_model().fit(_batches(4), epochs=1, verbose=0)


SIGTERM_SCRIPT = """
import sys
import numpy as np, torch
sys.path.insert(0, {root!r})
from paddle_tpu_torch import nn
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.ops.loss import cross_entropy
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.testing import faults
rng = np.random.default_rng(0)
batches = [(rng.normal(size=(8, 4)).astype(np.float32),
            rng.integers(0, 2, (8,)).astype(np.int64)) for _ in range(8)]
net = nn.Linear(4, 2, device="cpu", generator=torch.Generator().manual_seed(0))
faults.configure("sigterm:step={at}")
Model(net, loss=cross_entropy, optimizer=SGD(0.1)).fit(
    batches, epochs=1, verbose=0, ckpt_dir={ckpt!r}, save_steps=100)
print("fit returned")
"""


def test_sigterm_mid_fit_checkpoints_the_step_and_dies(tmp_path):
    d = str(tmp_path / "ck")
    script = tmp_path / "fit.py"
    script.write_text(SIGTERM_SCRIPT.format(root=ROOT, at=3, ckpt=d))
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, timeout=120, cwd=str(tmp_path))
    assert r.returncode == -signal.SIGTERM, r.stderr[-2000:]
    assert "fit returned" not in r.stdout
    ck = io.AsyncCheckpointer(d)
    # the step in flight (global step 3) finished, then the final
    # synchronous checkpoint: 4 steps done
    assert ck.intact_steps() == [4]
    assert ck.host_state() == {"global_step": 4, "epoch": 0,
                               "batch_in_epoch": 3}
    assert ck.verify() == []


def _rollback_fit(tmp_path, spec, batches=10):
    model = _make_model()
    faults.configure(spec)
    try:
        return model.fit(_batches(batches), epochs=1, verbose=0,
                         ckpt_dir=str(tmp_path / "ck"), save_steps=1), model
    finally:
        faults.configure(None)


def test_divergence_rollback_recovers(tmp_path):
    ptt.set_flags({"enable_metrics": True, "metrics_port": -1,
                   "divergence_streak": 3, "rollback_budget": 2})
    rollbacks = obs.counter("rollbacks_total", always=True)
    before = rollbacks.value()
    _, model = _rollback_fit(
        tmp_path, "loss_spike:at=4:mul=nan,loss_spike:at=5:mul=nan,"
                  "loss_spike:at=6:mul=nan")
    assert rollbacks.value() == before + 1
    kinds = [e["kind"] for e in obs.flight_recorder().events()]
    assert "fit_rollback" in kinds and "fit_rollback_resume" in kinds
    assert all(torch.isfinite(v).all()
               for v in model.network.state_dict().values())


def test_divergence_rollback_budget_exhausts(tmp_path):
    ptt.set_flags({"enable_metrics": True, "metrics_port": -1,
                   "divergence_streak": 3, "rollback_budget": 1})
    relentless = ",".join(f"loss_spike:at={i}:mul=nan" for i in range(1, 60))
    with pytest.raises(FloatingPointError, match="rollback_budget"):
        _rollback_fit(tmp_path, relentless)


def test_rollback_needs_metrics(tmp_path):
    rollbacks = obs.counter("rollbacks_total", always=True)
    before = rollbacks.value()
    _rollback_fit(tmp_path, "nonfinite_grad:at=4,nonfinite_grad:at=5")
    assert rollbacks.value() == before


def test_rollback_budget_flag_matches_jax():
    from paddle_tpu.flags import GLOBAL_FLAGS as JAX_FLAGS
    assert ptt.get_flags(["rollback_budget"]) == {
        "rollback_budget": JAX_FLAGS.get("rollback_budget")} == {
        "rollback_budget": 2}


def test_reduce_on_plateau_through_the_callback():
    sched = ReduceOnPlateau(learning_rate=0.1, patience=0, factor=0.5,
                            threshold=10.0)  # never improves
    net = nn.Sequential(nn.Linear(8, 8, device="cpu"), nn.ReLU(),
                        nn.Linear(8, 2, device="cpu"))
    model = Model(net)
    model.prepare(optimizer=SGD(learning_rate=sched),
                  loss=nn.CrossEntropyLoss())
    rng = np.random.default_rng(0)
    ds = data.TensorDataset(rng.normal(0, 1, (32, 8)).astype(np.float32),
                            rng.integers(0, 2, (32,)).astype(np.int64))
    model.fit(data.DataLoader(ds, batch_size=16), epochs=3, verbose=0)
    # 3 epochs of "no improvement": two halvings at the ends of epochs 1
    # and 2; the last epoch's steps read the live rate of the first one
    assert sched.get_lr() <= 0.1 * 0.5 * 0.5 + 1e-6
    assert float(model._train_step.host_lr) == pytest.approx(0.05,
                                                              rel=1e-6)
    cb = LRSchedulerCallback(model._optimizer)
    cb.on_epoch_end(0, {"loss": 5.0})
    assert sched.get_lr() < 0.1 * 0.5 * 0.5


def test_fit_publishes_the_hapi_series_with_metrics_on():
    ptt.set_flags({"enable_metrics": True, "metrics_port": -1})
    _, pm = _pair()
    pm.fit(_loaders(_data())[1], epochs=1, verbose=0)
    reg = obs.registry()
    assert reg.get("hapi_step_time_seconds").count() == 4
    assert float(reg.get("hapi_loss").value()) > 0
    assert reg.get("hapi_throughput_items_per_sec").value() > 0
    text = reg.prometheus_text()
    for name in ("device_mem_bytes_in_use", "train_heartbeat_timestamp",
                 "optimizer_steps_total"):
        assert name in text, name
    buckets = obs.goodput_ledger().snapshot()["buckets"]
    assert buckets["step_compute"] > 0 and buckets["data_wait"] > 0
    kinds = {e["kind"] for e in obs.flight_recorder().events()}
    assert {"fit_begin", "step", "fit_end"} <= kinds


def test_export_through_save_training_false(tmp_path):
    from paddle_tpu_torch import jit
    net = nn.Sequential(nn.Linear(8, 4, device="cpu"), nn.ReLU(),
                        nn.Dropout(0.5), nn.Linear(4, 2, device="cpu"))
    path = str(tmp_path / "served")
    Model(net).save(path, training=False,
                    input_spec=[jit.InputSpec([None, 8], "float32")])
    assert net.training  # mode restored after the export
    loaded = jit.load(path, device="cpu")
    x = torch.ones(3, 8)
    out = loaded(x)
    assert out.shape == (3, 2)
    # dropout was exported in eval mode: deterministic, the eval forward
    net.eval()
    assert torch.equal(out, loaded(x)) and torch.allclose(out, net(x))


def test_save_reads_back_with_jax_io(tmp_path):
    _, pm = _pair()
    pm.save(str(tmp_path / "w"))
    state = jax_io.load(str(tmp_path / "w.pdparams"))
    assert set(state) == {"fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"}
