"""PyTorch port: the vision models (LeNet, VGG, MobileNet V1/V2, SSDLite,
the DCGAN and its step) against the JAX package on the CPU, at narrow
widths and small images.

JAX weights and BatchNorm buffers move into the port through
``convert.load_jax_params``. Training-mode forwards and the new
statistics are held in fp32 under the default single-pass statistics
within ``NET_TOL`` of the largest entry; gradients are held in float64
under the two-pass statistics (``F64_TOL``), where both packages compute
one function to rounding (an fp32 ReLU6 unit within rounding of an edge
takes either side, and the single-pass statistics are fp32 by
definition). SSD's priors equal JAX's bit for bit; its ``predict`` gives
the same valid counts and labels, and scores and boxes within
``NET_TOL``. The GAN step is held against the JAX step's pieces
(``functional_call`` + ``apply_gradients``) on the ``z`` the port drew.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import paddle_tpu as jpt  # noqa: E402
from paddle_tpu import models as jmodels  # noqa: E402
from paddle_tpu import optimizer as jopt  # noqa: E402
from paddle_tpu.flags import GLOBAL_FLAGS as JAX_FLAGS  # noqa: E402
from paddle_tpu.models.gan import _bce_logits as j_bce  # noqa: E402
from paddle_tpu.nn.layer import functional_call as jcall  # noqa: E402

from paddle_tpu_torch import models as pmodels  # noqa: E402
from paddle_tpu_torch import optimizer as popt  # noqa: E402
from paddle_tpu_torch import set_flags  # noqa: E402
from paddle_tpu_torch.convert import load_jax_params  # noqa: E402

NET_TOL = 1e-4
OUT_TOL = 1e-5
F64_TOL = 1e-8


def _close(got, want, tol, what="", scale=0.0):
    """The largest gap over the largest entry of ``want`` (or ``scale``,
    if larger: a leaf whose gradient is zero but for rounding, as a
    convolution bias before a BatchNorm, is held to its model's
    scale)."""
    g = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = max(float(np.max(np.abs(w), initial=0.0)), scale, 1e-30)
    err = float(np.max(np.abs(g - w), initial=0.0)) / scale
    assert err <= tol, (what, err)


def _move(jm, pm):
    load_jax_params(pm, {k: np.asarray(v) for k, v in
                         jm.param_dict().items()},
                    {k: np.asarray(v) for k, v in jm.buffer_dict().items()})
    return pm


def _pair(jctor, pctor, seed=0, **kw):
    jpt.seed(seed)
    jm = jctor(**kw)
    return jm, _move(jm, pctor(**kw, device="cpu"))


def _single_pass(on: bool) -> None:
    JAX_FLAGS.set("batch_norm_single_pass", on)
    set_flags({"batch_norm_single_pass": on})


def _xent(out, labels, np_like):
    lp = out - np_like.log(np_like.exp(out).sum(-1, keepdims=True)) \
        if np_like is jnp else torch.log_softmax(out, -1)
    idx = np.arange(len(labels))
    return -lp[idx, labels].mean()


def _top(grads) -> float:
    return max(float(np.max(np.abs(np.asarray(g)))) for g in grads)


def _train_parity(jm, pm, x, labels):
    """The eval-mode fp32 forward within OUT_TOL (BatchNorm by its
    running statistics); then training mode in float64 under the
    two-pass statistics: the loss, every gradient (each within
    ``F64_TOL`` of its leaf's largest entry, or of a thousandth of the
    model's) and every new statistic. (An fp32 training-mode forward of
    these nets is not a parity check: their last BatchNorms normalise
    16 values a channel, and fp32 statistics of so few differ by ~1e-4
    between any two summation orders.)"""
    bufs = {k: v.clone() for k, v in pm.named_buffers()}

    def jloss(p, b, xx):
        out, new = jcall(jm, p, b, xx, capture_buffers=True)
        return _xent(out, labels, jnp), new

    jm.eval()
    pm.eval()
    try:
        jout = jax.jit(lambda p, b, xx: jcall(jm, p, b, xx))(
            jm.param_dict(), jm.buffer_dict(), jnp.asarray(x))
        with torch.no_grad():
            _close(pm(torch.from_numpy(x)), jout, OUT_TOL, "eval logits")
    finally:
        jm.train()
        pm.train()
    _single_pass(False)
    try:
        with jax.enable_x64(True):
            p64, b64 = ({k: jnp.asarray(np.asarray(v), jnp.float64)
                         for k, v in d.items()}
                        for d in (jm.param_dict(), jm.buffer_dict()))
            (jl, jb), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
                p64, b64, jnp.asarray(x, jnp.float64))
            jl = float(jl)
            jg = {k: np.asarray(v) for k, v in jg.items()}
            jb = {k: np.asarray(v) for k, v in jb.items()}
        pm.load_state_dict(bufs, strict=False)
        pm.double()
        pl = _xent(pm(torch.from_numpy(x).double()), labels, torch)
        params = dict(pm.named_parameters())
        names = sorted(jg)
        assert names == sorted(params)
        pg = torch.autograd.grad(pl, [params[n] for n in names])
        pb = {n: b.detach().clone() for n, b in pm.named_buffers()}
    finally:
        _single_pass(True)
        pm.float()
    assert abs(float(pl) - jl) <= F64_TOL * abs(jl)
    top = _top(jg.values())
    for n, g in zip(names, pg):
        _close(g, jg[n], F64_TOL, n, 1e-3 * top)
    assert set(pb) == set(jb)
    # a running mean after a bias-free 1x1 convolution of a BatchNorm's
    # output is zero but for rounding (the batch mean of a normalised
    # channel is its shift, 0 at the start): held to the model's scale
    top = _top(jb.values())
    for n, b in pb.items():
        _close(b, jb[n], F64_TOL, n, 1e-3 * top)


def _images(n, c, hw, seed=7):
    return np.random.default_rng(seed).standard_normal(
        (n, c, hw, hw)).astype(np.float32)


def test_lenet_forward_and_gradients_match_jax():
    jm, pm = _pair(jmodels.LeNet, pmodels.LeNet, num_classes=10)
    x = _images(3, 1, 28)
    labels = np.array([1, 5, 9])
    jl, jg = jax.jit(jax.value_and_grad(lambda p: _xent(
        jcall(jm, p, {}, jnp.asarray(x)), labels, jnp)))(jm.param_dict())
    params = dict(pm.named_parameters())
    pl = _xent(pm(torch.from_numpy(x)), labels, torch)
    pg = dict(zip(params, torch.autograd.grad(pl, list(params.values()))))
    assert abs(float(pl) - float(jl)) <= OUT_TOL * abs(float(jl))
    assert sorted(pg) == sorted(jg)
    for n in jg:
        _close(pg[n], jg[n], NET_TOL, n)


@pytest.mark.parametrize("ctor", ["mobilenet_v1", "mobilenet_v2"])
def test_mobilenet_train_forward_gradients_and_buffers_match_jax(ctor):
    jm, pm = _pair(getattr(jmodels, ctor), getattr(pmodels, ctor),
                   num_classes=5, scale=0.25)
    _train_parity(jm, pm, _images(4, 3, 64), np.array([0, 3, 1, 4]))


def test_vgg_bn_eval_forward_and_gradients_match_jax():
    """vgg11 with BatchNorm at 32 x 32 in eval mode (running statistics,
    no dropout): the classifier reads the 7 x 7 pool of a 1 x 1 map."""
    jm, pm = _pair(jmodels.vgg11, pmodels.vgg11, num_classes=5,
                   batch_norm=True)
    jm.eval()
    pm.eval()
    x = _images(2, 3, 32)
    labels = np.array([2, 4])
    picked = ["features.0.weight", "features.1.weight",
              "features.25.weight", "classifier.0.bias",
              "classifier.6.weight"]
    jl, jg = jax.jit(jax.value_and_grad(lambda p: _xent(
        jcall(jm, p, jm.buffer_dict(), jnp.asarray(x)), labels, jnp)))(
        jm.param_dict())
    params = dict(pm.named_parameters())
    pl = _xent(pm(torch.from_numpy(x)), labels, torch)
    pg = torch.autograd.grad(pl, [params[n] for n in picked])
    assert sorted(params) == sorted(jg)
    assert abs(float(pl) - float(jl)) <= OUT_TOL * abs(float(jl))
    for n, g in zip(picked, pg):
        _close(g, jg[n], NET_TOL, n)


@pytest.mark.parametrize("which", ["mobilenet_v1", "mobilenet_v2", "vgg"])
def test_nhwc_matches_nchw(which):
    """The channels-last model with the same (OIHW) weights computes the
    NCHW model's function; VGG's flatten is transposed back, so its
    classifier weights are the same (a 14 x 14 input through a 512-wide
    stage pools to a real 7 x 7 map)."""
    if which == "vgg":
        from paddle_tpu_torch.models.vgg import VGG, _make_layers

        def make(df):
            g = torch.Generator().manual_seed(0)
            return VGG(_make_layers([8, "M", 512], True, df, "cpu", g),
                       num_classes=3, data_format=df, device="cpu",
                       generator=g)
        x = _images(2, 3, 14)
    else:
        def make(df):
            return getattr(pmodels, which)(num_classes=7, scale=0.25,
                                           data_format=df, device="cpu")
        x = _images(2, 3, 32)
    m1, m2 = make("NCHW"), make("NHWC")
    assert set(m1.state_dict()) == set(m2.state_dict())
    for k, v in m1.state_dict().items():
        assert torch.equal(v, m2.state_dict()[k]), k
    m1.eval()
    m2.eval()
    with torch.no_grad():
        y1 = m1(torch.from_numpy(x))
        y2 = m2(torch.from_numpy(x).permute(0, 2, 3, 1).contiguous())
    assert bool(torch.isfinite(y1).all())
    _close(y2, y1.numpy(), OUT_TOL, which)


def _ssd_pair():
    return _pair(jmodels.SSDLite, pmodels.SSDLite, num_classes=3,
                 image_size=64, base=8)


def _ssd_targets():
    gt = np.zeros((2, 3, 4), np.float32)
    gt[0, :2] = [[0.1, 0.1, 0.5, 0.6], [0.4, 0.3, 0.9, 0.8]]
    gt[1, :1] = [[0.2, 0.2, 0.7, 0.5]]
    return gt, np.array([[1, 3, -1], [2, -1, -1]])


def test_ssd_priors_forward_loss_and_gradients_match_jax():
    jm, pm = _ssd_pair()
    # the priors are computed at construction and equal JAX's
    assert np.array_equal(pm.priors.numpy(), np.asarray(jm.priors))
    assert np.array_equal(pm.prior_vars.numpy(), np.asarray(jm.prior_vars))
    x = _images(2, 3, 64)
    gt, lab = _ssd_targets()
    _single_pass(False)
    try:
        jloc, jconf = jax.jit(lambda p, b, xx: jcall(jm, p, b, xx))(
            jm.param_dict(), jm.buffer_dict(), jnp.asarray(x))
        ploc, pconf = pm(torch.from_numpy(x))
        _close(ploc, jloc, NET_TOL, "loc")
        _close(pconf, jconf, NET_TOL, "conf")
        with jax.enable_x64(True):
            p64, b64 = ({k: jnp.asarray(np.asarray(v), jnp.float64)
                         for k, v in d.items()}
                        for d in (jm.param_dict(), jm.buffer_dict()))

            def jl(p):
                with jm.bind(p, b64):
                    return jm.loss(jnp.asarray(x, jnp.float64),
                                   jnp.asarray(gt, jnp.float64),
                                   jnp.asarray(lab))
            jloss, jg = jax.jit(jax.value_and_grad(jl))(p64)
            jloss, jg = float(jloss), {k: np.asarray(v)
                                       for k, v in jg.items()}
        pm.double()
        params = dict(pm.named_parameters())
        ploss = pm.loss(torch.from_numpy(x).double(),
                        torch.from_numpy(gt).double(), torch.from_numpy(lab))
        names = sorted(jg)
        pg = torch.autograd.grad(ploss, [params[n] for n in names])
    finally:
        _single_pass(True)
        pm.float()
    assert abs(float(ploss) - jloss) <= F64_TOL * abs(jloss)
    top = _top(jg.values())
    for n, g in zip(names, pg):
        _close(g, jg[n], F64_TOL, n, 1e-3 * top)


def test_ssd_predict_matches_jax():
    jm, pm = _ssd_pair()
    jm.eval()
    pm.eval()
    x = _images(2, 3, 64, seed=3)
    want = jax.jit(lambda xx: jm.predict(xx, keep_top_k=10,
                                         score_threshold=0.2))(
        jnp.asarray(x))
    with torch.no_grad():
        got = pm.predict(torch.from_numpy(x), keep_top_k=10,
                         score_threshold=0.2)
    assert len(got) == len(want) == 2
    for (go, gv), (wo, wv) in zip(got, want):
        wo, wv = np.asarray(wo), np.asarray(wv)
        assert np.array_equal(gv.numpy(), wv) and wv.any()
        assert np.array_equal(go[:, 0].numpy(), wo[:, 0])
        _close(go[:, 1:], wo[:, 1:], OUT_TOL, "scores and boxes")


def test_gan_step_matches_jax_pieces():
    """One GANTrainStep call (SGD on both sides) against the JAX step's
    body on the same z: the losses, every updated parameter and every
    statistic. Two-pass statistics on both sides (BatchNorm1D over 4
    rows)."""
    jpt.seed(0)
    jg_, jd_ = jmodels.Generator(z_dim=16, base=8), \
        jmodels.Discriminator(base=8)
    pg_ = _move(jg_, pmodels.Generator(z_dim=16, base=8, device="cpu"))
    pd_ = _move(jd_, pmodels.Discriminator(base=8, device="cpu"))
    real = np.tanh(np.random.default_rng(4).standard_normal(
        (4, 1, 28, 28))).astype(np.float32)
    step = pmodels.GANTrainStep(pg_, pd_, popt.SGD(0.1), popt.SGD(0.05),
                                seed=11)
    # z is the first draw of the call from the step's generator
    z = torch.randn((4, 16), generator=torch.Generator().manual_seed(11))
    _single_pass(False)
    try:
        out = step(torch.from_numpy(real))
        jz, jreal = jnp.asarray(z.numpy()), jnp.asarray(real)
        g_p, gb = jg_.param_dict(), jg_.buffer_dict()
        d_p, db = jd_.param_dict(), jd_.buffer_dict()
        g_opt, d_opt = jopt.SGD(0.1), jopt.SGD(0.05)

        def d_loss_fn(dp):
            fake, _ = jcall(jg_, g_p, gb, jz, capture_buffers=True)
            rl, nb = jcall(jd_, dp, db, jreal, capture_buffers=True)
            fl, nb = jcall(jd_, dp, nb, fake, capture_buffers=True)
            return j_bce(rl, 1.0) + j_bce(fl, 0.0), nb

        (d_loss, new_db), dgr = jax.jit(jax.value_and_grad(
            d_loss_fn, has_aux=True))(d_p)
        new_d, _ = d_opt.apply_gradients(d_p, dgr, d_opt.init(d_p))

        def g_loss_fn(gp):
            fake, nb = jcall(jg_, gp, gb, jz, capture_buffers=True)
            fl, _ = jcall(jd_, new_d, new_db, fake, capture_buffers=True)
            return j_bce(fl, 1.0), nb

        (g_loss, new_gb), ggr = jax.jit(jax.value_and_grad(
            g_loss_fn, has_aux=True))(g_p)
        new_g, _ = g_opt.apply_gradients(g_p, ggr, g_opt.init(g_p))
    finally:
        _single_pass(True)
    assert abs(float(out["d_loss"]) - float(d_loss)) <= OUT_TOL * abs(
        float(d_loss))
    assert abs(float(out["g_loss"]) - float(g_loss)) <= OUT_TOL * abs(
        float(g_loss))
    for model, old, params, bufs in ((pg_, g_p, new_g, new_gb),
                                     (pd_, d_p, new_d, new_db)):
        # each parameter within NET_TOL of the model's largest update
        top = _top([np.asarray(params[n]) - np.asarray(old[n])
                    for n in params])
        for n, p in model.named_parameters():
            _close(p - torch.from_numpy(np.asarray(old[n])),
                   np.asarray(params[n]) - np.asarray(old[n]), NET_TOL, n,
                   top)
        for n, b in model.named_buffers():
            _close(b, bufs[n], NET_TOL, n)
    # a second call draws a new z and moves both models again
    before = {n: p.clone() for n, p in pg_.named_parameters()}
    out2 = step(torch.from_numpy(real))
    assert all(bool(torch.isfinite(v)) for v in out2.values())
    assert any(not torch.equal(before[n], p)
               for n, p in pg_.named_parameters())
    s = step.sample(3, key=5)
    assert s.shape == (3, 1, 28, 28) and torch.equal(s, step.sample(3, 5))


def test_fused_adam_takes_channels_last_gradients(monkeypatch):
    """A channels-last convolution's weight gradient (cuDNN's on the
    card) reaches the fused Adam kernel as one dense row: the leaves the
    router gets are contiguous, and the update equals the unfused one."""
    from paddle_tpu_torch import kernels
    w = torch.randn(8, 3, 3, 3)
    g = torch.randn(8, 3, 3, 3).to(memory_format=torch.channels_last)
    assert not g.is_contiguous()
    seen = []
    real = kernels.maybe_fused_adam

    def spy(params, grads, *args):
        seen.append(all(t.is_contiguous() for t in list(params)
                        + list(grads)))
        return real(params, grads, *args)

    monkeypatch.setattr(kernels, "maybe_fused_adam", spy)
    out = {}
    for fused in (True, False):
        p = {"w": w.clone()}
        opt = popt.Adam(1e-2)
        state = opt.init(p)
        set_flags({"fused_adam": fused})
        try:
            opt.apply_gradients(p, {"w": g}, state)
        finally:
            set_flags({"fused_adam": False})
        out[fused] = p["w"]
    assert seen == [True]
    assert torch.equal(out[True], out[False])
