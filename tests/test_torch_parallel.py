"""PyTorch port: meshes, ``ShardedTrainStep`` (ZeRO 0/1/3, tensor
parallelism; each partitioned for real: a rank holds and multiplies its
blocks), BatchNorm and SyncBatchNorm over the data axis,
``DataParallel``, ``Model.prepare(mesh=).fit`` and the straggler detector,
against the JAX package.

The port runs in four Gloo processes (``paddle_tpu_torch.testing.
dist_worker``, job ``train``, one job for the module; each case's
configuration is ``dist_worker.SHARDED_CASES``/``BERT_CASES``/
``BN_CASES``), every rank called with the global batch as the JAX step
is. The JAX side runs on four of the conftest's eight virtual CPU devices
(``create_mesh(..., allow_submesh=True)``): the same model (JAX weights
crossed with ``convert``), batch and steps. Tolerances: ``TOL`` for the
sharded MLP and the small BERT in fp32 over 5 Adam steps (loss and every
parameter, relative to the parameter's largest entry: the global sums
are formed in another order),
``NET_TOL`` through the small ResNet, ``BF16_TOL`` under bf16 autocast.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu import hapi as jhapi  # noqa: E402
from paddle_tpu.clip import ClipGradByGlobalNorm as JaxClip  # noqa: E402
from paddle_tpu.flags import GLOBAL_FLAGS as JAX_FLAGS  # noqa: E402
from paddle_tpu.models import BertConfig as JaxBertConfig  # noqa: E402
from paddle_tpu.models import BertForPretraining as JaxBert  # noqa: E402
from paddle_tpu.models import pretraining_loss as jax_pretraining_loss  # noqa
from paddle_tpu.models import resnet as jresnet  # noqa: E402
from paddle_tpu.ops import loss as JL  # noqa: E402
from paddle_tpu.ops import nn_functional as JF  # noqa: E402
from paddle_tpu.parallel import ShardedTrainStep as JaxSharded  # noqa: E402
from paddle_tpu.parallel import create_mesh as jax_mesh  # noqa: E402
from paddle_tpu.parallel import megatron_param_rule as jax_megatron  # noqa
from paddle_tpu.parallel._shard_map import shard_map  # noqa: E402

from paddle_tpu_torch.parallel import create_mesh, mesh as pmesh  # noqa
from paddle_tpu_torch.parallel import spmd  # noqa: E402
from paddle_tpu_torch.testing import dist_worker as W  # noqa: E402

WORLD = 4
TOL = 2e-5
NET_TOL = 1e-4
BF16_TOL = 3e-2
# a BERT parameter is held within TOL of its largest entry or a
# two-hundredth of one Adam step, whichever is larger: a near-zero
# gradient entry's fp32 noise moves Adam's update by a few thousandths of
# a step (the JAX step itself moves bert.pooler.bias by 2.4e-7 between
# dp 1 and dp 4), where the fused head's gradient counted four times
# moves the loss by 3e-3 and a parameter by 1e-4, a tenth of a step
BERT_PARAM_ATOL = W.BERT_LR / 200


class JaxMLP(jpt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jpt.nn.Linear(16, 64)
        self.act = jpt.nn.GELU()
        self.fc2 = jpt.nn.Linear(64, 4)

    def forward(self, x, scale=None, shift=None):
        h = self.fc1(x)
        if scale is not None:
            h = h * scale
        out = self.fc2(self.act(h))
        return out if shift is None else out + shift


def _jax_mlp():
    jpt.seed(0)
    return JaxMLP()


def _jax_resnet():
    jpt.seed(0)
    return jresnet.ResNet(jresnet.BasicBlock, [1, 1, 1, 1], num_classes=10,
                          data_format="NHWC")


def _jax_bert():
    jpt.seed(0)
    return JaxBert(JaxBertConfig(**W.BERT_SMALL))


def _bert_batch(rng):
    b, t, m = W.BERT_BATCH, W.BERT_SEQ, W.BERT_MASKED
    ids = rng.integers(0, 512, (b, t)).astype(np.int64)
    types = rng.integers(0, 2, (b, t)).astype(np.int64)
    mask = np.ones((b, t), np.int64)
    mask[3, 12:] = 0
    pos = np.sort(rng.permuted(np.broadcast_to(np.arange(t), (b, t)),
                               axis=1)[:, :m], axis=1).astype(np.int64)
    mlm = rng.integers(0, 512, (b, m)).astype(np.int64)
    # unequal ignored counts per rank's 2 rows: 0, 3, 1 and 4
    mlm[2, :3] = mlm[5, 0] = -100
    mlm[6, 1:3] = mlm[7, 2:] = -100
    nsp = rng.integers(0, 2, (b,)).astype(np.int64)
    return dict(ids=ids, types=types, mask=mask, pos=pos, mlm=mlm, nsp=nsp)


def _inputs():
    rng = np.random.default_rng(0)
    y_ignore = rng.integers(0, 4, 16).astype(np.int64)
    # unequal ignored counts per rank's 4 rows: 0, 3, 1 and 2
    for i in (4, 5, 6, 9, 14, 15):
        y_ignore[i] = -100
    inputs = dict(
        x=rng.standard_normal((16, 16)).astype(np.float32),
        y=rng.integers(0, 4, 16).astype(np.int64), y_ignore=y_ignore,
        scale=(rng.random((16, 64)) + 0.5).astype(np.float32),
        shift=rng.standard_normal((1, 4)).astype(np.float32),
        images=rng.standard_normal((8, 64, 64, 3)).astype(np.float32),
        classes=(np.arange(8) % 10).astype(np.int64),
        sbn_x=rng.standard_normal((8, 3, 4, 4)).astype(np.float32) * 2 + 1,
        sbn_g=rng.standard_normal((8, 3, 4, 4)).astype(np.float32),
        sbn_w=rng.standard_normal(3).astype(np.float32),
        sbn_b=rng.standard_normal(3).astype(np.float32))
    for k, v in _jax_mlp().param_dict().items():
        inputs[f"mlp/{k}"] = np.asarray(v)
    for k, v in _bert_batch(rng).items():
        inputs[f"bert_{k}"] = v
    for k, v in _jax_bert().param_dict().items():
        inputs[f"bert/{k}"] = np.asarray(v)
    jr = _jax_resnet()
    for d in (jr.param_dict(), jr.buffer_dict()):
        for k, v in d.items():
            inputs[f"resnet/{k}"] = np.asarray(v)
    return inputs


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    inputs = _inputs()
    outs = W.run_job("train", tmp_path_factory.mktemp("train"), WORLD,
                     inputs, timeout_s=300)
    return inputs, outs


def _close(got, want, tol, what="", floor=0.0):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        got, want, rtol=tol,
        atol=max(tol * max(1e-3, np.abs(want).max()), floor), err_msg=what)


def _jax_case(spec, inputs):
    model = _jax_mlp()
    mesh = jax_mesh(spec["axes"], allow_submesh=True)
    rule = None
    if spec.get("rule") == "test_parallel":
        def rule(name, v):
            return JP(None, "mp") if name == "fc1.weight" else (
                JP("mp", None) if name == "fc2.weight" else JP())
    elif spec.get("rule") == "megatron":
        rule = jax_megatron()
    scaler = jpt.amp.GradScaler(init_loss_scaling=2.0 ** 10) \
        if spec.get("scaler") else None
    clip = JaxClip(spec["clip"]) \
        if spec.get("clip") else None
    step = JaxSharded(model, jpt.optimizer.Adam(1e-2, grad_clip=clip),
                      lambda o, y: JL.cross_entropy(o, y), mesh,
                      param_rule=rule, zero_stage=spec.get("zero", 0),
                      amp_dtype=spec.get("amp"), scaler=scaler)
    rows = spec.get("rows", len(inputs["x"]))
    y = inputs["y_ignore" if spec.get("ignore") else "y"][:rows]
    kw = dict(scale=inputs["scale"], shift=inputs["shift"]) \
        if spec.get("kwargs") else {}
    losses = [float(np.asarray(step(inputs["x"][:rows], labels=(y,),
                                    **kw)["loss"]))
              for _ in range(W.SHARDED_STEPS)]
    return losses, {k: np.asarray(v)
                    for k, v in step.state["params"].items()}, step


@pytest.mark.parametrize("case", sorted(W.SHARDED_CASES))
def test_sharded_train_step_matches_jax(job, case):
    inputs, outs = job
    spec = W.SHARDED_CASES[case]
    want_loss, want_params, jstep = _jax_case(spec, inputs)
    tol = BF16_TOL if spec.get("amp") else TOL
    for r, out in enumerate(outs):
        _close(out[f"{case}/loss"], want_loss, tol, f"{case} loss r{r}")
        for n, w in want_params.items():
            _close(out[f"{case}/param/{n}"], w, tol, f"{case} {n} r{r}")
    # the placement: the rank's shards are 1 / (number of ranks a
    # parameter's blocks spread over) of the model
    total = sum(v.size for v in want_params.values())
    numel = int(outs[0][f"{case}/shard_numel"])
    if spec.get("zero", 0) or spec.get("rule"):
        assert numel < total
    else:
        assert numel == total
    if spec.get("rule"):
        specs = jstep.state_specs["params"]
        assert tuple(specs["fc1.weight"])[1] == "mp"


def _held(out, case):
    return {k.split("/held_shape/")[1]: tuple(int(x) for x in v)
            for k, v in out.items() if k.startswith(f"{case}/held_shape/")}


@pytest.mark.parametrize("case", ["tp_rule", "megatron", "tp_zero3",
                                  "zero3", "bert_fused_tp", "bert_tp_zero3",
                                  "bert_fused_zero3"])
def test_partitioned_blocks_are_what_a_rank_holds(job, case):
    """The bytes: at mp 2 a rank's column-parallel weight holds half its
    columns (with its bias) and the row-parallel one half its rows; under
    ZeRO 3 a rank holds 1/dp of every parameter that dp divides, between
    steps, in the model itself."""
    inputs, outs = job
    spec = {**W.SHARDED_CASES, **W.BERT_CASES}[case]
    prefix = "mlp/" if case in W.SHARDED_CASES else "bert/"
    whole = {k[len(prefix):]: v.shape for k, v in inputs.items()
             if k.startswith(prefix)}
    mp = spec["axes"].get("mp", 1) if spec.get("rule") else 1
    dp = spec["axes"]["dp"] if spec.get("zero", 0) >= 3 else 1
    column, row = ("q_proj", "k_proj", "v_proj", "fc1", "linear1"), \
        ("out_proj", "fc2", "linear2")
    for out in outs:
        held = _held(out, case)
        assert set(held) == set(whole)
        for n, shape in whole.items():
            want = list(shape)
            layer, kind = n.rsplit(".", 2)[-2:]
            if layer in column:  # [in, out] columns, or the bias
                want[-1] //= mp
            elif layer in row and kind == "weight":
                want[0] //= mp
            numel = int(np.prod(want))
            if any(d % dp == 0 for d in want):
                numel //= dp
            assert int(np.prod(held[n])) == numel, (case, n, held[n])
    if case == "bert_fused_tp":
        q = "bert.encoder.layers.0.self_attn.q_proj.weight"
        o = "bert.encoder.layers.0.self_attn.out_proj.weight"
        assert _held(outs[0], case)[q] == (64, 32)
        assert _held(outs[0], case)[o] == (32, 64)


def test_a_rule_the_model_cannot_partition_names_the_parameter(job):
    """A split with no Megatron pair in the model raises, naming the
    parameter; nothing falls back to running the whole model."""
    _, outs = job
    want = {"no_partner": "fc1.weight", "bias_alone": "fc2.bias",
            "two_axes": "fc1.weight", "row_bias": "fc2.bias"}
    for out in outs:
        for tag, name in want.items():
            msg = str(out[f"tp_error/{tag}"])
            assert f"'{name}'" in msg and "Megatron" in msg, (tag, msg)


_JAX_BERT: dict = {}


def _jax_bert_run(spec, inputs):
    """The JAX step on the global batch (cached by placement: the fused
    head is the port's; the JAX program's loss is the same function)."""
    key = (tuple(spec["axes"].items()), spec.get("rule"),
           spec.get("zero", 0))
    if key not in _JAX_BERT:
        model = _jax_bert()
        step = JaxSharded(
            model, jpt.optimizer.AdamW(W.BERT_LR, weight_decay=0.01,
                                       fused_state=False),
            jax_pretraining_loss,
            jax_mesh(spec["axes"], allow_submesh=True),
            param_rule=jax_megatron() if spec.get("rule") == "megatron"
            else None, zero_stage=spec.get("zero", 0))
        batch = [inputs[f"bert_{k}"] for k in ("ids", "types", "mask",
                                                "pos", "mlm", "nsp")]
        losses = [float(np.asarray(step(*batch[:4],
                                        labels=tuple(batch[4:]))["loss"]))
                  for _ in range(W.SHARDED_STEPS)]
        _JAX_BERT[key] = losses, {k: np.asarray(v) for k, v in
                                  step.state["params"].items()}
    return _JAX_BERT[key]


@pytest.mark.parametrize("case", sorted(W.BERT_CASES))
def test_sharded_bert_matches_jax(job, case):
    """A model that hands parameters to its loss (the fused MLM head:
    the tied word embedding and the decoder bias, whole on every rank)
    still gets the global loss's gradient: each rank keeps its share of
    their cotangent, so the sum over dp counts it once."""
    inputs, outs = job
    spec = W.BERT_CASES[case]
    want_loss, want_params = _jax_bert_run(spec, inputs)
    for r, out in enumerate(outs):
        _close(out[f"{case}/loss"], want_loss, TOL, f"{case} loss r{r}")
        for n, w in want_params.items():
            if n.endswith("k_proj.bias"):
                # softmax ignores a per-query constant: the key bias's
                # gradient is exactly 0, and both sides see only fp32
                # noise, which Adam turns into steps of up to lr (as in
                # tests/test_torch_bert.py)
                continue
            _close(out[f"{case}/param/{n}"], w, TOL, f"{case} {n} r{r}",
                   floor=BERT_PARAM_ATOL)


def _jax_resnet_run(single_pass: bool):
    JAX_FLAGS.set("batch_norm_single_pass", single_pass)
    try:
        jm = _jax_resnet()
        step = JaxSharded(jm, jpt.optimizer.Momentum(0.1, 0.9),
                          lambda o, y: JL.cross_entropy(o, y),
                          jax_mesh({"dp": WORLD}, allow_submesh=True))
        inputs = _INPUTS_CACHE
        losses = [float(np.asarray(step(inputs["images"],
                                        labels=(inputs["classes"],))[
                                            "loss"]))
                  for _ in range(W.BN_STEPS)]
    finally:
        JAX_FLAGS.set("batch_norm_single_pass", True)
    return losses, step.state


_INPUTS_CACHE = {}


@pytest.fixture(scope="module")
def jax_resnet(job):
    _INPUTS_CACHE.update(job[0])
    return _jax_resnet_run(False)


@pytest.mark.parametrize("case", sorted(W.BN_CASES))
def test_batch_norm_kinds_at_dp4_match_jax_global_batch(job, jax_resnet,
                                                        case):
    """Plain BatchNorm inside the step and SyncBatchNorm both normalise
    over the global batch, as JAX's one program does (its plain
    BatchNorm in ShardedTrainStep; a JAX SyncBatchNorm only runs under
    shard_map: its op is held below)."""
    _, outs = job
    want_loss, state = jax_resnet
    spec = W.BN_CASES[case]
    # single-pass statistics put rounding into the gradient (see
    # tests/test_torch_resnet.py): its trajectory is held 10x looser
    tol = NET_TOL * (10 if spec["single_pass"] else 1)
    for r, out in enumerate(outs):
        _close(out[f"{case}/loss"], want_loss, tol, f"{case} loss r{r}")
        for n, w in state["params"].items():
            _close(out[f"{case}/param/{n}"], np.asarray(w), tol,
                   f"{case} {n}")
        for n, w in state["buffers"].items():
            if n.endswith("_variance") and spec["sync"]:
                continue  # biased, as JAX's sync op: held below
            _close(out[f"{case}/buffer/{n}"], np.asarray(w), tol,
                   f"{case} {n}")


@pytest.fixture(scope="module")
def jax_sync_bn(job):
    """The JAX sync_batch_norm op under shard_map over the dp ranks and
    its input gradient, one jitted program each (the reference both
    ranks' layouts are held against)."""
    inputs, _ = job
    mesh = jax_mesh({"dp": WORLD}, allow_submesh=True)
    w, b = jnp.asarray(inputs["sbn_w"]), jnp.asarray(inputs["sbn_b"])

    def f(x):
        y, nm, nv = JF.sync_batch_norm(x, jnp.zeros(3), jnp.ones(3), w, b,
                                       True, 0.9, 1e-5, "NCHW",
                                       axis_name="dp")
        return y, nm[None], nv[None]

    fn = shard_map(f, mesh=mesh, in_specs=JP("dp"),
                   out_specs=(JP("dp"), JP("dp"), JP("dp")),
                   check_vma=False)
    x = jnp.asarray(inputs["sbn_x"])
    y, nm, nv = jax.jit(fn)(x)
    dx = jax.jit(jax.grad(lambda xx: jnp.sum(
        fn(xx)[0] * jnp.asarray(inputs["sbn_g"]))))(x)
    return y, nm, nv, dx


@pytest.mark.parametrize("tag", ["tp", "sp"])
def test_sync_batch_norm_op_matches_jax_shard_map(job, jax_sync_bn, tag):
    inputs, outs = job
    y, nm, nv, dx = jax_sync_bn
    rows = 8 // WORLD
    for r, out in enumerate(outs):
        sl = slice(r * rows, (r + 1) * rows)
        _close(out[f"sbn_{tag}/out"], np.asarray(y)[sl], 1e-5, "out")
        _close(out[f"sbn_{tag}/mean"], np.asarray(nm)[r], 1e-5, "mean")
        _close(out[f"sbn_{tag}/var"], np.asarray(nv)[r], 1e-5, "var")
        _close(out[f"sbn_{tag}/dx"], np.asarray(dx)[sl], 1e-4, "dx")


def test_data_parallel_means_gradients_over_dp(job):
    _, outs = job
    for out in outs:
        np.testing.assert_array_equal(out["dp_mean"],
                                      np.full((16, 64), 2.5, np.float32))
        assert int(out["dp_nranks"]) == WORLD


def test_model_fit_with_a_mesh_matches_jax_hapi(job):
    inputs, outs = job
    jm = _jax_mlp()
    model = jhapi.Model(jm, loss=lambda o, y: JL.cross_entropy(o, y),
                        optimizer=jpt.optimizer.Adam(1e-2))
    model.prepare(mesh=jax_mesh({"dp": WORLD}, allow_submesh=True),
                  zero_stage=1)
    batches = [(inputs["x"][i * 8:(i + 1) * 8], inputs["y"][i * 8:(i + 1)
                                                           * 8])
               for i in range(2)]
    hist = model.fit(batches, epochs=2, verbose=0)
    model._train_step.sync_to_model()
    for out in outs:
        _close(out["hapi/loss"], hist["loss"], TOL, "history")
        for n, w in jm.param_dict().items():
            _close(out[f"hapi/param/{n}"], np.asarray(w), TOL, n)


def test_straggler_detector_flags_the_slowed_rank_alone(job):
    _, outs = job
    for out in outs:
        # every rank sees the same fleet vector and flags rank 2 once
        assert out["straggler/flagged"].tolist() == [W.STRAGGLER_RANK]
        assert int(out["straggler/events"]) == 1


def test_create_mesh_and_its_errors_match_jax():
    """One process (no process group) is a world of one rank, as the
    conftest's JAX world is eight devices: the same rules and messages at
    each size."""
    for axes in ({"dp": 1}, {"dp": -1}, {"dp": 1, "mp": 1}, None):
        m = create_mesh(axes)
        assert m.shape == {k: 1 for k in (axes or {"dp": 1})}
        assert m.size == 1 and m.coordinate == (0,) * len(m.shape)
        assert m.group("dp") is None and m.device_mesh is None
    assert dict(jax_mesh({"dp": -1, "mp": 2}).shape) == {"dp": 4, "mp": 2}
    for port_axes, jax_axes, msg in (
            ({"dp": 2}, {"dp": 16}, "need"),
            ({"dp": 3, "mp": -1}, {"dp": 3, "mp": -1}, "wildcard"),
            ({"dp": 0}, {"dp": 0}, "need")):
        with pytest.raises(ValueError, match=msg):
            create_mesh(port_axes)
        with pytest.raises(ValueError, match=msg):
            jax_mesh(jax_axes)
    # a mesh over fewer ranks than there are needs allow_submesh (JAX: 4
    # of its 8 devices)
    with pytest.raises(ValueError, match="allow_submesh"):
        jax_mesh({"dp": 4})
    with pytest.raises(ValueError, match="allow_submesh"):
        create_mesh({"dp": 1}, devices=[0, 1])
    m = create_mesh({"dp": 1}, devices=[0, 1, 2], allow_submesh=True)
    assert m.devices.tolist() == [0]
    assert pmesh.mesh_axis_size(m, "mp") == 1
    assert tuple(pmesh.batch_sharding(m).spec) == ("dp",)
    assert tuple(pmesh.replicated(m).spec) == ()
    assert tuple(pmesh.named_sharding(m, None, "mp").spec) == (None, "mp")
    assert pmesh.num_slices() == 1
    ms = pmesh.create_multislice_mesh({"dcn": 1}, {"dp": -1})
    assert ms.shape == {"dcn": 1, "dp": 1}
    assert tuple(pmesh.multislice_data_spec(ms)) == (("dcn", "dp"),)
    with pytest.raises(ValueError, match="at most one ici axis"):
        pmesh.create_multislice_mesh({"dcn": 1}, {"dp": -1, "mp": -1})


def test_step_helpers_match_jax():
    from paddle_tpu.parallel import spmd as jspmd
    params = {"a.q_proj.weight": np.zeros((4, 8)), "b.fc2.weight":
              np.zeros((8, 4)), "c.bias": np.zeros(4)}
    rule = spmd.megatron_param_rule()
    assert {n: tuple(s) for n, s in spmd.make_param_specs(
        params, rule).items()} == {
        n: tuple(s) for n, s in jspmd.make_param_specs(
            params, jax_megatron()).items()}
    kw = {"mask": np.zeros((8, 3)), "table": np.zeros((5, 2)), "s": 1.0}
    sh, rep = spmd.split_kwargs_by_shardable(kw, 8, note=False)
    jsh, jrep = jspmd.split_kwargs_by_shardable(kw, 8, note=False)
    assert (sorted(sh), sorted(rep)) == (sorted(jsh), sorted(jrep))
    assert spmd.leading_batch_size((np.zeros((6, 2)),), ()) == 6
    assert spmd.host_lr_of(object()) is None
    assert "lr" not in spmd.inject_host_lr({}, object())
    m = create_mesh({"dp": 1})
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.testing.dist_worker import tiny_mlp
    with pytest.raises(ValueError, match="optimizer_fused_state"):
        spmd.ShardedTrainStep(tiny_mlp("cpu"), AdamW(1e-3, fused_state=True),
                              lambda o, y: o.sum(), m, zero_stage=1)
    # one process, no group: the step is TrainStep with the placement, and
    # like the JAX class it has no run_steps
    step = spmd.ShardedTrainStep(tiny_mlp("cpu"), AdamW(1e-3),
                                 lambda o, y: (o - y).square().mean(), m)
    x, y = np.ones((4, 16), np.float32), np.zeros((4, 4), np.float32)
    assert np.isfinite(float(step(x, labels=(y,))["loss"]))
    assert not step.compiled and step.shards["fc1.weight"] is \
        step.params["fc1.weight"]
    assert not hasattr(JaxSharded, "run_steps")
    with pytest.raises(NotImplementedError, match="run_steps"):
        step.run_steps(x[None], labels=(y[None],))
