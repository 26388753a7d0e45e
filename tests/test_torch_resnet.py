"""PyTorch port: the ResNet path (convs, pools, BatchNorm, the ResNet
family, its flags, and the train step's buffer guard) against the JAX
package on the CPU.

Inputs come from numpy with a fixed seed; JAX weights (and BatchNorm
buffers) move into the port through ``convert.load_jax_params``.
Tolerances are relative to the largest entry of the reference: ``TOL``
for one fp32 op (its reductions summed in another order than XLA's),
``NET_TOL`` through a network of them, one bf16 step for bf16 outputs.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import paddle_tpu as jpt  # noqa: E402
from paddle_tpu.flags import GLOBAL_FLAGS as JAX_FLAGS  # noqa: E402
from paddle_tpu.models import resnet as jresnet  # noqa: E402
from paddle_tpu.nn.layer import functional_call as jcall  # noqa: E402
from paddle_tpu.ops import nn_functional as JF  # noqa: E402
from paddle_tpu.static import TrainStep as JaxTrainStep  # noqa: E402

from paddle_tpu_torch import io as pio  # noqa: E402
from paddle_tpu_torch import nn as pnn  # noqa: E402
from paddle_tpu_torch import optimizer as popt  # noqa: E402
from paddle_tpu_torch import set_flags  # noqa: E402
from paddle_tpu_torch.amp import GradScaler  # noqa: E402
from paddle_tpu_torch.convert import (load_jax_params,  # noqa: E402
                                      tensor_from_numpy)
from paddle_tpu_torch.models import resnet as presnet  # noqa: E402
from paddle_tpu_torch.ops import nn_functional as PF  # noqa: E402
from paddle_tpu_torch.static import EvalStep, TrainStep  # noqa: E402

# one fp32 op: its sums in another order than XLA's
TOL = 2e-6
# a small ResNet's forward, gradients and statistics: the convs' fp32
# reassociation through ~10 layers, and BatchNorm dividing by the batch's
# spread (measured up to ~2e-5 of the largest entry)
NET_TOL = 1e-4
BF16_ULP = 2.0 ** -7


def _np(x):
    if isinstance(x, np.ndarray):
        return x
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, what=""):
    g = got.detach()
    g = (g if g.dtype == torch.float64 else g.float()).numpy()
    w = _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    # a window wholly in the padding is -inf on both sides
    fin = np.isfinite(w)
    assert np.array_equal(g[~fin], w[~fin]), what
    g, w = g[fin], w[fin]
    scale = max(float(np.max(np.abs(w), initial=0.0)), 1e-30)
    err = float(np.max(np.abs(g - w), initial=0.0)) / scale
    assert err <= tol, (what, err)


def _rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _both_grads(jfn, pfn, arrays, seed=1):
    """Forward of both functions over ``arrays`` (numpy), and the
    gradient of ``sum(out * r)`` for a fixed random ``r`` with respect to
    each array."""
    jargs = [jnp.asarray(a) for a in arrays]
    jout = jfn(*jargs)
    r = _rand(np.shape(jout), seed)
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a) * r),
                  argnums=tuple(range(len(arrays))))(*jargs)
    pargs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    pout = pfn(*pargs)
    pg = torch.autograd.grad((pout * torch.from_numpy(r)).sum(), pargs)
    return jout, jg, pout, pg


def _nhwc(shape):
    n, c, h, w = shape
    return (n, h, w, c)


CONV_CASES = {
    # name: (x NCHW shape, weight OIHW shape, stride, padding, dilation,
    # groups)
    "k3_pad1": ((2, 4, 9, 9), (6, 4, 3, 3), 1, 1, 1, 1),
    "k7_s2_pad3": ((2, 3, 16, 16), (8, 3, 7, 7), 2, 3, 1, 1),
    "k1_s2": ((2, 8, 8, 8), (4, 8, 1, 1), 2, 0, 1, 1),
    "pair_pad": ((1, 4, 10, 7), (4, 4, 3, 3), (2, 1), (1, 2), 1, 1),
    "four_sided": ((1, 4, 8, 8), (4, 4, 4, 4), 1, [2, 1, 2, 1], 1, 1),
    "same": ((2, 4, 11, 9), (6, 4, 3, 2), 2, "SAME", 1, 1),
    "valid_dilated": ((1, 4, 12, 12), (4, 4, 3, 3), 1, "VALID", 2, 1),
    "groups": ((2, 8, 8, 8), (8, 2, 3, 3), 1, 1, 1, 4),
}


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv2d_matches_jax(case, layout):
    xs, ws, stride, pad, dil, groups = CONV_CASES[case]
    x = _rand(xs if layout == "NCHW" else _nhwc(xs), 0)
    w = _rand(ws, 1, 0.3)
    b = _rand((ws[0],), 2)

    def jfn(x, w, b):
        return JF.conv2d(x, w, b, stride, pad, dil, groups, layout,
                         weight_format="OIHW")

    def pfn(x, w, b):
        return PF.conv2d(x, w, b, stride, pad, dil, groups, layout,
                         weight_format="OIHW")

    jout, jg, pout, pg = _both_grads(jfn, pfn, [x, w, b])
    _close(pout, jout, TOL, "out")
    for name, got, want in zip("xwb", pg, jg):
        _close(got, want, TOL, name)


def test_conv2d_default_weight_formats_match_jax():
    # NHWC pairs with HWIO by default, as lax's dimension numbers do
    x = _rand((2, 8, 8, 3))
    w = _rand((3, 3, 3, 5), 1)
    _close(PF.conv2d(torch.from_numpy(x), torch.from_numpy(w), None, 1, 1,
                     data_format="NHWC"),
           JF.conv2d(jnp.asarray(x), jnp.asarray(w), None, 1, 1,
                     data_format="NHWC"), TOL)


POOL_CASES = {
    # name: (x NCHW shape, kernel, stride, padding, ceil_mode, exclusive)
    "resnet_stem": ((2, 3, 16, 16), 3, 2, 1, False, True),
    "no_pad": ((2, 3, 9, 9), 2, 2, 0, False, True),
    "ceil": ((1, 2, 9, 9), 3, 2, 0, True, True),
    "ceil_pad_inclusive": ((1, 2, 10, 7), 3, 2, 1, True, False),
    "pad_inclusive": ((1, 2, 8, 8), 3, 1, 1, False, False),
    "asym_pad": ((1, 2, 8, 9), (3, 2), (2, 1), [1, 0, 0, 1], False, True),
    "big_pad_ceil": ((1, 2, 7, 7), 2, 2, 2, True, True),
    "same": ((1, 2, 9, 10), 3, 2, "SAME", False, True),
}


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pool_matches_jax(case, kind, layout):
    xs, k, s, p, ceil, excl = POOL_CASES[case]
    x = _rand(xs if layout == "NCHW" else _nhwc(xs), 3)
    if kind == "max":
        # ties, as after a ReLU: the gradient goes to the first maximum
        x = np.maximum(x, 0.0)

        def jfn(x):
            return JF.max_pool2d(x, k, s, p, ceil, layout)

        def pfn(x):
            return PF.max_pool2d(x, k, s, p, ceil, layout)
    else:
        def jfn(x):
            return JF.avg_pool2d(x, k, s, p, ceil, excl, layout)

        def pfn(x):
            return PF.avg_pool2d(x, k, s, p, ceil, excl, layout)
    jout, jg, pout, pg = _both_grads(jfn, pfn, [x])
    _close(pout, jout, TOL, "out")
    _close(pg[0], jg[0], TOL, "grad")


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("out", [1, (2, 2), (3, 2), (4, 5)])
def test_adaptive_avg_pool_matches_jax(out, layout):
    # 8 x 10 into 3 x 2 and 4 x 5... bins that do not divide take the
    # floor/ceil bounds, and overlap
    xs = (2, 3, 8, 10) if layout == "NCHW" else (2, 8, 10, 3)
    x = _rand(xs, 4)
    jout, jg, pout, pg = _both_grads(
        lambda a: JF.adaptive_avg_pool2d(a, out, layout),
        lambda a: PF.adaptive_avg_pool2d(a, out, layout), [x])
    _close(pout, jout, TOL, "out")
    _close(pg[0], jg[0], TOL, "grad")


def _bn_args(layout, dtype, seed=5):
    xs = (4, 3, 5, 6) if layout == "NCHW" else (4, 5, 6, 3)
    x = _rand(xs, seed, 2.0) + 0.5
    w, b = _rand((3,), seed + 1) + 1.0, _rand((3,), seed + 2)
    rm, rv = _rand((3,), seed + 3, 0.1), np.abs(_rand((3,), seed + 4)) + 0.5
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx, jw, jb = (jnp.asarray(a).astype(jdt) for a in (x, w, b))
    jrm, jrv = jnp.asarray(rm), jnp.asarray(rv)
    port = [tensor_from_numpy(np.asarray(a)) for a in (jx, jrm, jrv, jw, jb)]
    return (jx, jrm, jrv, jw, jb), port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("single_pass", [True, False])
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_batch_norm_matches_jax(layout, training, single_pass, dtype):
    jargs, pargs = _bn_args(layout, dtype)
    JAX_FLAGS.set("batch_norm_single_pass", single_pass)
    set_flags({"batch_norm_single_pass": single_pass})
    try:
        jout = JF.batch_norm(*jargs, training, 0.9, 1e-5, layout)
        pout = PF.batch_norm(*pargs, training, 0.9, 1e-5, layout)
    finally:
        JAX_FLAGS.set("batch_norm_single_pass", True)
        set_flags({"batch_norm_single_pass": True})
    tol = TOL if dtype == "float32" else BF16_ULP
    for name, got, want in zip(("out", "mean", "var"), pout, jout):
        # every output and statistic in JAX's dtype (bf16 promotion: the
        # statistics come back fp32 against the fp32 running buffers)
        assert str(got.dtype).split(".")[1] == str(want.dtype), name
        _close(got, want, tol if name == "out" else 4 * TOL, name)
    if not training:
        assert torch.equal(pout[1], pargs[1])


def test_batch_norm_gradients_match_jax():
    jargs, pargs = _bn_args("NHWC", "float32")

    def jfn(x, w, b):
        return JF.batch_norm(x, jargs[1], jargs[2], w, b, True, 0.9, 1e-5,
                             "NHWC")[0]

    def pfn(x, w, b):
        return PF.batch_norm(x, pargs[1], pargs[2], w, b, True, 0.9, 1e-5,
                             "NHWC")[0]

    arrays = [np.asarray(jargs[i]) for i in (0, 3, 4)]
    jout, jg, pout, pg = _both_grads(jfn, pfn, arrays)
    _close(pout, jout, TOL)
    for name, got, want in zip("xwb", pg, jg):
        _close(got, want, 1e-5, name)


def _models(block, layout, num_classes=10, **kw):
    jpt.seed(0)
    jm = jresnet.ResNet(getattr(jresnet, block), [1, 1, 1, 1],
                        num_classes=num_classes, data_format=layout)
    pm = presnet.ResNet(getattr(presnet, block), [1, 1, 1, 1],
                        num_classes=num_classes, data_format=layout,
                        device="cpu", **kw)
    load_jax_params(pm, {k: np.asarray(v) for k, v in
                         jm.param_dict().items()},
                    {k: np.asarray(v) for k, v in jm.buffer_dict().items()})
    return jm, pm


def _images(layout, n=4, hw=32, seed=7):
    shape = (n, 3, hw, hw) if layout == "NCHW" else (n, hw, hw, 3)
    return _rand(shape, seed)


def _single_pass(on: bool) -> None:
    JAX_FLAGS.set("batch_norm_single_pass", on)
    set_flags({"batch_norm_single_pass": on})


def _port_loss(pm, x, labels):
    out = pm(torch.from_numpy(x).to(pm.conv1.weight.dtype))
    loss = -torch.log_softmax(out, -1)[torch.arange(len(labels)),
                                       torch.from_numpy(labels)].mean()
    return out, loss


# float64 on both sides: the same composition to rounding
F64_TOL = 1e-10


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("block", ["BasicBlock", "BottleneckBlock"])
def test_resnet_forward_gradients_and_buffers_match_jax(block, layout):
    """Training mode, through ``convert``. The gradients are held in
    float64 under the two-pass statistics, where both packages compute
    one function to rounding: in fp32 a ReLU unit within rounding of 0
    takes either side (PR 18's kink), and the single-pass statistics are
    fp32 by definition, so JAX's own fp32 gradients stray from float64
    by up to 0.57 of a leaf's largest entry here (measured at layer4).
    In fp32 under the default single pass the forward and the new
    statistics are held against JAX."""
    jm, pm = _models(block, layout)
    x = _images(layout, 4, 32)
    labels = np.arange(4) % 10

    def jloss(p, bufs, xx):
        out, new = jcall(jm, p, bufs, xx, capture_buffers=True)
        logp = jax.nn.log_softmax(out)
        return -jnp.mean(logp[jnp.arange(4), labels]), (out, new)

    bufs = {k: v.clone() for k, v in pm.named_buffers()}
    # fp32, single pass: forward and statistics
    jout, jbufs = jax.jit(lambda p, b: jcall(
        jm, p, b, jnp.asarray(x), capture_buffers=True))(
        jm.param_dict(), jm.buffer_dict())
    pout, _ = _port_loss(pm, x, labels)
    _close(pout, jout, NET_TOL, "logits")
    assert set(dict(pm.named_buffers())) == set(jbufs)
    for n, b in pm.named_buffers():
        assert b.dtype == torch.float32
        _close(b, jbufs[n], NET_TOL, n)
    # float64, two-pass: forward, every gradient, every statistic
    _single_pass(False)
    try:
        with jax.enable_x64(True):
            p64, b64 = ({k: jnp.asarray(np.asarray(v), jnp.float64)
                         for k, v in d.items()}
                        for d in (jm.param_dict(), jm.buffer_dict()))
            (jl, (jout, jbufs)), jg = jax.jit(jax.value_and_grad(
                jloss, has_aux=True))(p64, b64,
                                      jnp.asarray(x, jnp.float64))
            jl, jout = float(jl), np.asarray(jout)
            jg = {k: np.asarray(v) for k, v in jg.items()}
            jbufs = {k: np.asarray(v) for k, v in jbufs.items()}
        pm.load_state_dict(bufs, strict=False)
        pm.double()
        pout, pl = _port_loss(pm, x.astype(np.float64), labels)
        names = list(jg)
        params = dict(pm.named_parameters())
        pg = torch.autograd.grad(pl, [params[n] for n in names])
    finally:
        _single_pass(True)
    assert abs(float(pl) - jl) <= F64_TOL * abs(jl)
    _close(pout, jout, F64_TOL, "logits")
    for n, g in zip(names, pg):
        _close(g, jg[n], F64_TOL, n)
    for n, b in pm.named_buffers():
        _close(b, jbufs[n], F64_TOL, n)


def test_load_jax_params_names_every_missing_key():
    jm, pm = _models("BasicBlock", "NCHW")
    params = {k: np.asarray(v) for k, v in jm.param_dict().items()}
    with pytest.raises(ValueError) as err:
        load_jax_params(pm, params)
    for n in jm.buffer_dict():
        assert n in str(err.value)
    del params["fc.bias"]
    with pytest.raises(ValueError, match="fc.bias"):
        load_jax_params(pm, params, {k: np.asarray(v)
                                     for k, v in jm.buffer_dict().items()})


def test_resnet50_names_match_jax():
    jm = jresnet.resnet50()
    pm = presnet.resnet50(device="cpu")
    assert set(dict(pm.named_parameters())) == set(jm.param_dict())
    assert set(dict(pm.named_buffers())) == set(jm.buffer_dict())
    for n, p in pm.named_parameters():
        assert tuple(p.shape) == tuple(jm.param_dict()[n].shape), n
    # ResNeXt: grouped 3x3 convs
    rx = presnet.resnext50_32x4d(device="cpu")
    assert rx.layer1[0].conv2.groups == 32
    assert set(dict(rx.named_parameters())) == set(
        jresnet.resnext50_32x4d().param_dict())


def test_space_to_depth_stem_matches_plain_stem():
    # JAX's own tolerance for the rearrangement (2e-5)
    _, pm = _models("BasicBlock", "NHWC")
    pm.eval()
    x = torch.from_numpy(_rand((2, 24, 24, 3), 8))
    with torch.no_grad():
        pm.s2d_stem = False
        base = pm(x)
        set_flags({"resnet_space_to_depth_stem": True})
        try:
            pm.s2d_stem = None
            s2d = pm(x)
            odd = pm(torch.from_numpy(_rand((1, 23, 23, 3), 9)))
        finally:
            set_flags({"resnet_space_to_depth_stem": False})
    np.testing.assert_allclose(s2d.numpy(), base.numpy(), rtol=2e-5,
                               atol=2e-5)
    assert odd.shape == (1, 10)
    # the rearranged conv alone against the JAX one
    w = pm.conv1.weight.detach()
    _close(presnet._space_to_depth_stem(x, w),
           jresnet._space_to_depth_stem(jnp.asarray(x.numpy()),
                                        jnp.asarray(w.numpy())), TOL)


def _train(pm, steps, remat=False, batch=None, **kw):
    set_flags({"resnet_block_remat": remat})
    try:
        step = TrainStep(pm, popt.Momentum(0.1, 0.9), pnn.CrossEntropyLoss(),
                         **kw)
        x, y = batch or (_images(pm.data_format, 4, 16),
                         np.arange(4) % 10)
        losses = [float(step(torch.from_numpy(x),
                             labels=(torch.from_numpy(y),))["loss"])
                  for _ in range(steps)]
    finally:
        set_flags({"resnet_block_remat": False})
    return step, losses


def test_block_remat_is_bit_for_bit_with_statistics_moved_once():
    runs = {}
    for remat in (False, True):
        _, pm = _models("BottleneckBlock", "NHWC")
        step, losses = _train(pm, 2, remat)
        runs[remat] = (losses, {k: v.clone() for k, v in
                                step.state_dict()["buffers"].items()},
                       {k: v.clone() for k, v in pm.named_parameters()})
    assert runs[False][0] == runs[True][0]
    for i in (1, 2):
        for k, v in runs[False][i].items():
            assert torch.equal(v, runs[True][i][k]), k
    # the statistics moved (once a step: equal to the run without remat)
    _, fresh = _models("BottleneckBlock", "NHWC")
    assert not torch.equal(runs[True][1]["bn1._mean"], fresh.bn1._mean)


def test_train_step_momentum_matches_jax_train_step():
    # two-pass statistics: JAX's single-pass gradient strays on the CPU
    # (see the test above)
    jm, pm = _models("BasicBlock", "NHWC")
    x, y = _images("NHWC", 4, 64), (np.arange(4) % 10).astype(np.int64)
    _single_pass(False)
    try:
        jstep = JaxTrainStep(jm, jpt.optimizer.Momentum(0.1, 0.9),
                             jpt.nn.CrossEntropyLoss())
        jl = [float(np.asarray(jstep(x, labels=(y,))["loss"]))
              for _ in range(3)]
        step, pl = _train(pm, 3, batch=(x, y))
    finally:
        _single_pass(True)
    np.testing.assert_allclose(pl, jl, rtol=NET_TOL)
    for n, p in pm.named_parameters():
        _close(p, jstep.state["params"][n], NET_TOL, n)
        _close(step.state["slots"][n]["velocity"],
               jstep.state["opt"]["slots"][n]["velocity"], 4 * NET_TOL, n)
    for n, b in pm.named_buffers():
        _close(b, jstep.state["buffers"][n], NET_TOL, n)


@pytest.mark.parametrize("guard", ["skip_guard", "scaler"])
def test_skip_guard_restores_buffers(guard):
    _, pm = _models("BasicBlock", "NCHW")
    kw = {"scaler": GradScaler(init_loss_scaling=2.0 ** 4)} \
        if guard == "scaler" else {}
    step, _ = _train(pm, 1, **kw)
    before = {k: v.clone() for k, v in pio.flatten(
        {k: v for k, v in step.state_dict().items()
         if k != "generator"}).items()}
    x = _images("NCHW", 4, 16)
    x[0, 0, 0, 0] = np.inf
    step(torch.from_numpy(x), labels=(torch.arange(4),))
    after = pio.flatten({k: v for k, v in step.state_dict().items()
                         if k != "generator"})
    assert int(step.nonfinite_steps) == 1
    for k, v in before.items():
        if k.startswith("scaler/"):
            continue
        assert torch.equal(after[k], v), k
    assert any(k.startswith("buffers/") for k in before)


def test_eval_step_reads_running_statistics():
    _, pm = _models("BasicBlock", "NHWC")
    _train(pm, 2)
    x = torch.from_numpy(_images("NHWC", 2, 16, seed=11))
    out, _ = EvalStep(pm)(None, None, x)
    stats = {k: v.clone() for k, v in pm.named_buffers()}
    with torch.no_grad():
        pm.eval()
        want = pm(x)
        pm.train()
    assert torch.equal(out, want)
    for k, v in pm.named_buffers():
        assert torch.equal(v, stats[k]), k
    assert pm.training


def test_resumed_training_is_bit_for_bit(tmp_path):
    batches = [(_images("NHWC", 4, 16, seed=20 + i),
                (np.arange(4) + i) % 10) for i in range(4)]

    def run(step, part):
        return [float(step(torch.from_numpy(x),
                           labels=(torch.from_numpy(y),))["loss"])
                for x, y in part]

    _, pm = _models("BasicBlock", "NHWC")
    step = TrainStep(pm, popt.LarsMomentum(0.1, 0.9),
                     pnn.CrossEntropyLoss())
    whole = run(step, batches)
    end = {k: v.clone() for k, v in pio.flatten(step.state_dict()).items()}
    _, pm2 = _models("BasicBlock", "NHWC")
    step2 = TrainStep(pm2, popt.LarsMomentum(0.1, 0.9),
                      pnn.CrossEntropyLoss())
    first = run(step2, batches[:2])
    pio.save(step2.state_dict(), str(tmp_path / "ck"))
    _, pm3 = _models("BasicBlock", "NHWC")
    step3 = TrainStep(pm3, popt.LarsMomentum(0.1, 0.9),
                      pnn.CrossEntropyLoss())
    step3.set_state_dict(pio.load(str(tmp_path / "ck")))
    rest = run(step3, batches[2:])
    assert first + rest == whole
    for k, v in pio.flatten(step3.state_dict()).items():
        assert torch.equal(v, end[k]), k


def test_batch_norm_layers_and_flags():
    bn = pnn.BatchNorm2D(3, device="cpu")
    assert set(dict(bn.named_buffers())) == {"_mean", "_variance"}
    ptrs = (bn._mean.data_ptr(), bn._variance.data_ptr())
    bn.to("bfloat16")
    assert bn.weight.dtype == torch.bfloat16
    assert bn._mean.dtype == torch.float32
    bn(torch.randn(2, 3, 4, 4).to(torch.bfloat16))
    # written in place: a captured step reads them where they are
    assert (bn._mean.data_ptr(), bn._variance.data_ptr()) == ptrs
    assert bn._mean.abs().sum() > 0
    g = pnn.BatchNorm2D(3, use_global_stats=True, device="cpu")
    g(torch.randn(2, 3, 4, 4))
    assert not g._mean.any()
    assert pnn.BatchNorm1D(3, device="cpu").data_format == "NCL"
    assert pnn.BatchNorm3D(3, device="cpu").data_format == "NCDHW"
    # outside a process group SyncBatchNorm is the plain BatchNorm (its
    # reduction over ranks: tests/test_torch_parallel.py)
    sync = pnn.SyncBatchNorm(3, device="cpu")
    plain = pnn.BatchNorm2D(3, device="cpu")
    assert sync.sync_axis == "dp" and plain.sync_axis is None
    x = torch.randn(2, 3, 4, 4)
    torch.testing.assert_close(sync(x), plain(x), rtol=0, atol=0)
    torch.testing.assert_close(sync._variance, plain._variance, rtol=0,
                               atol=0)
    net = pnn.Sequential(pnn.BatchNorm2D(3, device="cpu"))
    assert pnn.SyncBatchNorm.convert_sync_batchnorm(net, "dp") is net
    assert net[0].sync_axis == "dp"
    from paddle_tpu_torch import get_flags
    assert get_flags(["batch_norm_single_pass", "resnet_block_remat",
                      "resnet_space_to_depth_stem"]) == {
        "batch_norm_single_pass": True, "resnet_block_remat": False,
        "resnet_space_to_depth_stem": False}
    was = torch.backends.cudnn.deterministic
    try:
        set_flags({"deterministic": True})
        assert torch.backends.cudnn.deterministic
    finally:
        set_flags({"deterministic": False})
        torch.backends.cudnn.deterministic = was
