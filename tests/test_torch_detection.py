"""PyTorch port: ``ops.detection`` against the JAX package on the CPU.

Every public function of the JAX module runs through ``DET_CASES`` (and
the creation ops through ``DET_CREATION``, made on the CPU): float
outputs within ``RTOL``/``ATOL``, indices, labels, counts and masks
exactly, NMS ties (the lower index first) and exhaustion among them.
The losses' and ROI ops' gradients agree within ``GRAD_TOL`` of the
largest entry. The sampled assignments (``use_random=True``) cannot
match threefry's bits: their law is checked (the fg cap, the batch
size, a subset of the eligible anchors, the same draw from the same
seed), and ``use_random=False`` exactly. ``layers.detection_output``
(decode + per-image ``multiclass_nms``, batched over the images in the
port) is held against the JAX layer.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from paddle_tpu.ops import detection as j_det  # noqa: E402

from paddle_tpu_torch.ops import detection as t_det  # noqa: E402
from paddle_tpu_torch.testing import op_cases as C  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5
GRAD_TOL = 1e-4
IDS = [f"{c[1]}-{i}" for i, c in enumerate(C.DET_CASES)]


def _j(v):
    if isinstance(v, np.ndarray):
        return jnp.asarray(v)
    if isinstance(v, list) and v and isinstance(v[0], np.ndarray):
        return [jnp.asarray(a) for a in v]
    return v


def _is_array(v) -> bool:
    return isinstance(v, np.ndarray) or (
        isinstance(v, list) and bool(v) and isinstance(v[0], np.ndarray))


# run eagerly: XLA's compiled roi_pool rounds a bin edge ``x1 + (p + 1)
# * w / n`` once where the eager op (and the port) round its product
# and sum apart, and at DET_CASES' 7 / 3 edge the two ceil to different
# cells
EAGER = {"roi_pool"}


def _jax_call(fn, args, kw):
    """``fn`` over the case's arrays as one jitted program (its other
    arguments closed over); eager where tracing cannot run it (an
    assignment drawing its own key) and for ``EAGER``."""
    slots = [i for i, a in enumerate(args) if _is_array(a)]
    keys = [k for k, v in kw.items() if _is_array(v)]

    def call(*arrays):
        a = list(args)
        for i, v in zip(slots, arrays):
            a[i] = v
        return fn(*a, **dict(kw, **dict(zip(keys, arrays[len(slots):]))))

    arrays = [_j(args[i]) for i in slots] + [_j(kw[k]) for k in keys]
    if fn.__name__ in EAGER:
        return call(*arrays)
    try:
        return jax.jit(call)(*arrays)
    except jax.errors.UnexpectedTracerError:
        return call(*arrays)


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


@pytest.mark.parametrize("mod,name,args,kw", C.DET_CASES, ids=IDS)
def test_detection_matches_jax(mod, name, args, kw):
    want = _jax_call(getattr(j_det, name), args, kw)
    got = getattr(t_det, name)(*(_t(a) for a in args),
                               **{k: _t(v) for k, v in kw.items()})
    _agree(got, want, name)


@pytest.mark.parametrize("mod,name,args,kw", C.DET_CREATION,
                         ids=[f"{c[1]}-{i}" for i, c in
                              enumerate(C.DET_CREATION)])
def test_detection_creation_matches_jax(mod, name, args, kw):
    want = getattr(j_det, name)(*args, **kw)
    got = getattr(t_det, name)(*args, **kw, device="cpu")
    _agree(got, want, name)


def test_every_public_function_has_a_case():
    covered = {c[1] for c in C.DET_CASES + C.DET_CREATION}
    jnames = {n for n in dir(j_det) if not n.startswith("_")
              and callable(getattr(j_det, n))
              and getattr(getattr(j_det, n), "__module__", "")
              == j_det.__name__}
    assert len(jnames) == 32 and jnames <= covered, sorted(jnames - covered)
    assert set(t_det.__all__) == set(j_det.__all__)
    for n in jnames:
        assert callable(getattr(t_det, n)), n


def _grad_pair(name, args, kw, argnum):
    """(port gradient, JAX gradient) of the sum of ``name``'s first output
    times a seeded cotangent, with respect to argument ``argnum``."""
    jargs = [_j(a) for a in args]

    def jfn(x):
        a = list(jargs)
        a[argnum] = x
        out = getattr(j_det, name)(*a, **kw)
        return out[0] if isinstance(out, tuple) else out

    shape = jax.eval_shape(jfn, jargs[argnum]).shape
    cot = np.random.default_rng(argnum).normal(size=shape).astype(
        np.float32)

    def grad(x, c):
        return jax.vjp(jfn, x)[1](c)[0]

    want = (grad if name in EAGER else jax.jit(grad))(
        jargs[argnum], jnp.asarray(cot))
    targs = [_t(a) for a in args]
    x = targs[argnum].requires_grad_(True)
    out = getattr(t_det, name)(*targs, **kw)
    out = out[0] if isinstance(out, tuple) else out
    (got,) = torch.autograd.grad(out, x, torch.from_numpy(cot))
    return got.numpy(), np.asarray(want)


GRADS = [(c, a) for c in C.DET_CASES for a in (0, 1)
         if (c[1], a) in {("roi_align", 0), ("prroi_pool", 0),
                          ("prroi_pool", 1), ("psroi_pool", 0),
                          ("roi_pool", 0), ("ssd_loss", 0), ("ssd_loss", 1),
                          ("yolov3_loss", 0), ("sigmoid_focal_loss", 0),
                          ("roi_perspective_transform", 0)}]


@pytest.mark.parametrize("case,argnum", GRADS,
                         ids=[f"{c[1]}-{a}-{i}" for i, (c, a) in
                              enumerate(GRADS)])
def test_detection_grad_matches_jax(case, argnum):
    _, name, args, kw = case
    got, want = _grad_pair(name, args, kw, argnum)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= GRAD_TOL * scale, name


def test_nms_ties_and_exhaustion():
    # three pairs of identical boxes: each pair's twin is suppressed, the
    # lower index of a tie taken first, and the slots past the survivors
    # stay -1 / invalid
    boxes = torch.from_numpy(np.repeat(C.DBOX[[0, 5, 9]], 2, 0))
    scores = torch.tensor([0.5, 0.5, 0.9, 0.9, 0.2, 0.2])
    idx, valid = t_det.nms(boxes, scores, 0.99, max_out=6)
    iou = t_det.iou_similarity(boxes, boxes)
    assert idx[0] == 2 and bool(valid[0])
    picked = idx[valid].tolist()
    assert picked == sorted(picked, key=lambda i: (-float(scores[i]), i))
    assert all(i % 2 == 0 for i in picked)
    assert (idx[~valid] == -1).all() and int(valid.sum()) <= 3
    assert float(iou[0, 2]) < 0.99


def test_rank_sample_law():
    anchors = torch.from_numpy(C.ANCH)
    gt = torch.from_numpy(C.GT_PIX)
    loc0, lab0 = t_det.rpn_target_assign(
        anchors, gt, rpn_batch_size_per_im=8, rpn_positive_overlap=0.4,
        rpn_negative_overlap=0.3, use_random=False, box_normalized=False)
    eligible_fg = lab0 == 1
    draws = [t_det.rpn_target_assign(
        anchors, gt, rpn_batch_size_per_im=8, rpn_positive_overlap=0.4,
        rpn_negative_overlap=0.3, use_random=True, box_normalized=False,
        key=s)[1] for s in (3, 3, 4)]
    assert torch.equal(draws[0], draws[1])
    # the encode does not depend on the draw
    loc1, _ = t_det.rpn_target_assign(
        anchors, gt, rpn_batch_size_per_im=8, rpn_positive_overlap=0.4,
        rpn_negative_overlap=0.3, use_random=True, box_normalized=False,
        key=3)
    assert torch.equal(loc0, loc1)
    # the same fg/bg pools: use_random=False's fg set is the eligible fg
    # below the cap; a sampled one keeps at most 4 fg and 8 in all
    _, full = t_det.rpn_target_assign(
        anchors, gt, rpn_batch_size_per_im=10 ** 6, rpn_fg_fraction=1.0,
        rpn_positive_overlap=0.4, rpn_negative_overlap=0.3,
        use_random=False, box_normalized=False)
    for lab in draws:
        assert int((lab == 1).sum()) <= 4 and int((lab >= 0).sum()) <= 8
        assert bool(((lab == 1) <= (full == 1)).all())
        assert bool(((lab == 0) <= (full == 0)).all())
        assert int((lab >= 0).sum()) == min(
            8, min(4, int((full == 1).sum())) + int((full == 0).sum()))
    assert int(eligible_fg.sum()) == min(4, int((full == 1).sum()))


def test_detection_output_matches_jax():
    from paddle_tpu import layers as jl
    from paddle_tpu_torch import layers as tl
    rng = np.random.default_rng(5)
    loc = (rng.normal(size=(3, 20, 4)) * 0.2).astype(np.float32)
    logits = rng.normal(size=(3, 20, 4)).astype(np.float32) * 2
    scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    var = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
    want = jax.jit(lambda a, b, c, d: jl.detection_output(
        a, b, c, d, keep_top_k=6, score_threshold=0.2))(
        jnp.asarray(loc), jnp.asarray(scores), jnp.asarray(C.PRIORS),
        jnp.asarray(var))
    got = tl.detection_output(torch.from_numpy(loc),
                              torch.from_numpy(scores),
                              torch.from_numpy(C.PRIORS),
                              torch.from_numpy(var), keep_top_k=6,
                              score_threshold=0.2)
    assert len(got) == len(want) == 3
    _agree(got, want, "detection_output")
