"""PyTorch port: the vision slice's ops (``ops.nn_functional``'s
convolutions, pools, norms and misc ops, and ``ops.conv_extra``) against
the JAX package on the CPU.

The cases are ``testing/op_cases.py``'s ``VISION_CASES``: outputs agree
within ``RTOL``/``ATOL`` (fp32, sums in another order), integer and bool
outputs exactly (the port gives int64 indices where JAX with x64 off
gives int32). ``test_vision_grad_matches_jax`` holds the gradient of
each case's float output with respect to its first argument, for a
seeded cotangent, within ``GRAD_TOL`` of the largest entry. The sampled
ops (``random_crop``, ``dropout_keep_mask``) cannot match threefry's
bits: they are checked by shape, by their law and by the same draw from
the same seed.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.ops import conv_extra as j_ce  # noqa: E402
from paddle_tpu.ops import nn_functional as j_nnf  # noqa: E402

from paddle_tpu_torch import nn as pnn  # noqa: E402
from paddle_tpu_torch import ops as pops  # noqa: E402
from paddle_tpu_torch.nn import functional as pF  # noqa: E402
from paddle_tpu_torch.ops import conv_extra as t_ce  # noqa: E402
from paddle_tpu_torch.ops import nn_functional as t_nnf  # noqa: E402
from paddle_tpu_torch.testing import op_cases as C  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5
GRAD_TOL = 1e-4
MODS = {"nn_functional": (j_nnf, t_nnf), "conv_extra": (j_ce, t_ce)}
IDS = [f"{c[0]}.{c[1]}-{i}" for i, c in enumerate(C.VISION_CASES)]
# cases whose first argument is not differentiated (indices, one-hot
# labels) or whose output is not a float of it
NO_GRAD = {"one_hot", "max_pool2d_with_index", "max_pool3d_with_index",
           "similarity_focus", "label_smooth", "partial_sum",
           "partial_concat", "pyramid_hash", "tree_conv"}


def _j(v):
    if isinstance(v, np.ndarray):
        return jnp.asarray(v)
    if isinstance(v, list) and v and isinstance(v[0], np.ndarray):
        return [jnp.asarray(a) for a in v]
    return v


def _is_array(v) -> bool:
    return isinstance(v, np.ndarray) or (
        isinstance(v, list) and bool(v) and isinstance(v[0], np.ndarray))


def _jax_fn(fn, args, kw, argnum=None):
    """``fn`` over the case's arrays as one jitted program (its other
    arguments closed over), or the eager function where tracing cannot
    run it; with ``argnum``, ``(x, cotangent) -> (out, d out.cot / dx)``
    for the array at that position."""
    slots = [i for i, a in enumerate(args) if _is_array(a)]
    keys = [k for k, v in kw.items() if _is_array(v)]

    def call(*arrays):
        a = list(args)
        for i, v in zip(slots, arrays):
            a[i] = v
        k = dict(kw, **dict(zip(keys, arrays[len(slots):])))
        return fn(*a, **k)

    arrays = [_j(args[i]) for i in slots] + [_j(kw[k]) for k in keys]
    if argnum is None:
        try:
            return jax.jit(call)(*arrays)
        except jax.errors.UnexpectedTracerError:
            return call(*arrays)
    pos = slots.index(argnum)

    def first(out):
        return out[0] if isinstance(out, tuple) else out

    def grad(x, cot):
        rest = list(arrays)
        rest[pos] = x
        out, vjp = jax.vjp(lambda y: first(call(*(
            rest[:pos] + [y] + rest[pos + 1:]))), x)
        return out, vjp(cot)[0]

    return grad, arrays[pos]


def _t(v):
    if isinstance(v, np.ndarray):
        return torch.from_numpy(v.copy())
    if isinstance(v, list) and v and isinstance(v[0], np.ndarray):
        return [torch.from_numpy(a.copy()) for a in v]
    return v


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _flat(o)]
    if isinstance(out, torch.Tensor):
        return [out.detach().numpy()]
    return [np.asarray(out)]


def _agree(got, want, what):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert g.shape == w.shape, (what, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=what)
        else:
            np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("mod,name,args,kw", C.VISION_CASES, ids=IDS)
def test_vision_op_matches_jax(mod, name, args, kw):
    jmod, tmod = MODS[mod]
    want = _jax_fn(getattr(jmod, name), args, kw)
    got = getattr(tmod, name)(*(_t(a) for a in args),
                              **{k: _t(v) for k, v in kw.items()})
    _agree(got, want, f"{mod}.{name}")


GRAD_CASES = [(i, c) for i, c in enumerate(C.VISION_CASES)
              if c[1] not in NO_GRAD]


@pytest.mark.parametrize("i,case", GRAD_CASES,
                         ids=[IDS[i] for i, _ in GRAD_CASES])
def test_vision_grad_matches_jax(i, case):
    mod, name, args, kw = case
    jmod, tmod = MODS[mod]
    first = args[0]
    grad, x0 = _jax_fn(getattr(jmod, name), args, kw, argnum=0)
    fwd = getattr(tmod, name)(*(_t(a) for a in args),
                              **{k: _t(v) for k, v in kw.items()})
    fwd = fwd[0] if isinstance(fwd, tuple) else fwd
    cot = np.random.default_rng(i).normal(size=tuple(fwd.shape)).astype(
        np.float32)
    _, want = jax.jit(grad)(x0, jnp.asarray(cot))
    x = torch.from_numpy(first.copy()).requires_grad_(True)
    out = getattr(tmod, name)(x, *(_t(a) for a in args[1:]),
                              **{k: _t(v) for k, v in kw.items()})
    out = out[0] if isinstance(out, tuple) else out
    (got,) = torch.autograd.grad(out, x, torch.from_numpy(cot))
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got.numpy() - want).max()) <= GRAD_TOL * scale, name


def test_every_public_function_has_a_case():
    covered = {c[1] for c in C.VISION_CASES} | C.VISION_RANDOM
    assert set(t_ce.__all__) <= covered
    # every function of the JAX modules has a port, exported as there
    for mod, (jmod, tmod) in MODS.items():
        jnames = {n for n in dir(jmod) if not n.startswith("_")
                  and callable(getattr(jmod, n))
                  and getattr(getattr(jmod, n), "__module__", "")
                  == jmod.__name__}
        missing = {n for n in jnames if not hasattr(tmod, n)}
        assert not missing, (mod, sorted(missing))
    vision = {"conv1d", "conv3d", "conv2d_transpose", "depthwise_conv2d",
              "conv_shift", "pool2d", "pool3d", "max_pool3d", "avg_pool3d",
              "adaptive_max_pool2d", "adaptive_pool3d",
              "max_pool2d_with_index", "max_pool3d_with_index", "unpool",
              "instance_norm", "group_norm", "local_response_norm",
              "spectral_norm", "data_norm", "affine_channel", "inplace_abn",
              "unfold", "fold", "grid_sample", "affine_grid", "normalize",
              "l2_normalize", "cos_sim", "label_smooth", "one_hot",
              "npair_loss", "random_crop", "add_position_encoding",
              "similarity_focus", "continuous_value_model",
              "deformable_roi_pooling", "dropout_keep_mask"}
    assert vision <= covered
    for name in vision:
        assert hasattr(pops, name) and hasattr(pF, name), name
    for name in t_ce.__all__:
        assert hasattr(pops, name), name


def test_random_crop_law_and_seed():
    x = torch.arange(2 * 3 * 6 * 7, dtype=torch.float32).reshape(2, 3, 6, 7)
    a = t_nnf.random_crop(x, (4, 5), key=3)
    b = t_nnf.random_crop(x, (4, 5), key=torch.Generator().manual_seed(3))
    assert a.shape == (2, 3, 4, 5) and torch.equal(a, b)
    assert np.asarray(j_nnf.random_crop(jnp.asarray(x.numpy()), (4, 5),
                                        key=jax.random.PRNGKey(0))).shape \
        == (2, 3, 4, 5)
    # each sample is a contiguous window of its own input; offsets spread
    # uniformly over the 3 x 3 positions, drawn per sample
    starts = []
    for seed in range(300):
        c = t_nnf.random_crop(x, (4, 5), key=seed)
        for i in range(2):
            for j in range(3):
                v = int(c[i, j, 0, 0]) - int(x[i, j, 0, 0])
                r, s = divmod(v, 7)
                assert torch.equal(c[i, j], x[i, j, r:r + 4, s:s + 5])
                starts.append((r, s))
    counts = np.bincount([r * 3 + s for r, s in starts], minlength=9)
    assert counts.min() > 0.8 * len(starts) / 9
    assert len(set(starts[:6])) > 1 or len(set(starts[6:12])) > 1


def test_dropout_keep_mask_law_and_seed(monkeypatch):
    a = t_nnf.dropout_keep_mask(5, 0.7, (200, 300), device="cpu")
    b = t_nnf.dropout_keep_mask(torch.Generator().manual_seed(5), 0.7,
                                (200, 300))
    c = t_nnf.dropout_keep_mask(6, 0.7, (200, 300), device="cpu")
    assert a.dtype == torch.bool and a.shape == (200, 300)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs(float(a.float().mean()) - 0.7) < 0.01
    assert bool(t_nnf.dropout_keep_mask(1, 1.0, (1000,), device="cpu").all())
    assert not bool(t_nnf.dropout_keep_mask(1, 0.0, (1000,),
                                            device="cpu").any())
    # an int or no key draws on the card unless the caller asks for the CPU
    from paddle_tpu_torch.ops import _common
    asked = []
    monkeypatch.setattr(_common, "device_of", lambda *xs, device=None: (
        asked.append(device), torch.device("cpu"))[1])
    for key in (5, None):
        assert t_nnf.dropout_keep_mask(key, 0.7, (8,)).device.type == "cpu"
    assert asked == [None, None]
    jm = j_nnf.dropout_keep_mask(jax.random.PRNGKey(0), 0.7, (200, 300))
    assert abs(float(jnp.mean(jm)) - 0.7) < 0.01


LAYERS = [
    ("Conv1D", dict(in_channels=4, out_channels=6, kernel_size=3, stride=2,
                    padding=1, groups=2), (2, 4, 11)),
    ("Conv3D", dict(in_channels=3, out_channels=4, kernel_size=(2, 3, 2),
                    padding="SAME"), (2, 3, 5, 6, 7)),
    ("Conv2DTranspose", dict(in_channels=4, out_channels=6, kernel_size=4,
                             stride=2, padding=1, groups=2), (2, 4, 5, 6)),
    ("Conv2DTranspose", dict(in_channels=4, out_channels=3, kernel_size=3,
                             stride=2, padding=1, output_padding=1,
                             data_format="NHWC"), (2, 5, 6, 4)),
    ("MaxPool3D", dict(kernel_size=3, stride=2, padding=1, ceil_mode=True),
     (2, 3, 5, 6, 7)),
    ("AvgPool3D", dict(kernel_size=2, stride=2, ceil_mode=True),
     (2, 3, 5, 6, 7)),
    ("AdaptiveMaxPool2D", dict(output_size=(3, 2)), (2, 4, 7, 9)),
    ("Unfold", dict(kernel_sizes=3, strides=2, paddings=1), (2, 4, 7, 9)),
    ("Fold", dict(output_sizes=(5, 7), kernel_sizes=(2, 3), strides=2,
                  paddings=1), (2, 24, 12)),
    ("PixelShuffle", dict(upscale_factor=2), (2, 8, 3, 4)),
    ("PixelShuffle", dict(upscale_factor=2, data_format="NHWC"),
     (2, 3, 4, 8)),
    ("InstanceNorm2D", dict(num_features=4), (2, 4, 5, 6)),
    ("InstanceNorm1D", dict(num_features=4), (2, 4, 9)),
    ("InstanceNorm3D", dict(num_features=3), (2, 3, 4, 5, 6)),
    ("GroupNorm", dict(num_groups=2, num_channels=4), (2, 4, 5, 6)),
    ("LocalResponseNorm", dict(size=3), (2, 4, 5, 6)),
]


@pytest.mark.parametrize("name,kw,shape", LAYERS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(LAYERS)])
def test_vision_layer_matches_jax(name, kw, shape):
    from paddle_tpu_torch.convert import load_jax_params
    jl = getattr(jnn, name)(**kw)
    rng = np.random.default_rng(len(shape) * 7 + len(kw))
    # non-trivial scales and shifts, the same on both sides
    params = {k: (np.asarray(v) + rng.normal(size=v.shape) * 0.3).astype(
        np.float32) for k, v in jl.param_dict().items()}
    jl.set_state_dict({k: jnp.asarray(v) for k, v in params.items()})
    tl = getattr(pnn, name)(**kw, **({"device": "cpu"} if params else {}))
    load_jax_params(tl, params)
    x = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(jax.jit(lambda xx: jl(xx))(jnp.asarray(x)))
    got = tl(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)


def test_spectral_norm_layer_matches_jax():
    from paddle_tpu_torch.convert import load_jax_params
    jl = jnn.SpectralNorm((4, 3, 2), dim=1, power_iters=2)
    tl = pnn.SpectralNorm((4, 3, 2), dim=1, power_iters=2, device="cpu")
    bufs = {k: np.asarray(v) for k, v in jl.buffer_dict().items()}
    load_jax_params(tl, bufs)
    w = np.random.default_rng(2).normal(size=(4, 3, 2)).astype(np.float32)
    want = np.asarray(jl(jnp.asarray(w)))
    for _ in range(2):   # the JAX layer's vectors never move
        got = tl(torch.from_numpy(w)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert sorted(dict(tl.named_buffers())) == sorted(bufs)
