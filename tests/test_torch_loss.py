"""PyTorch port: ``ops.loss`` and the loss layers of ``nn`` against the
JAX package on the CPU.

Each loss function and class gets the same seeded numpy inputs in both
packages, under each reduction it takes, and where it has them with
``ignore_index``, class weights and soft labels. Everything is fp32
elementwise math and sums over at most a few hundred terms, so results
must agree within ``RTOL``/``ATOL``.

Where the JAX package's result is NaN by accident the reference is JAX
on the kept rows: its out-of-range gather of an ignored label (-100)
yields NaN, which its ``nll_loss`` and weighted ``cross_entropy`` carry
into the result (a zero mask times NaN); the port selects ignored
positions away, as Paddle defines them (0 loss, 0 weight).
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.nn.layers import loss as jax_layers  # noqa: E402
from paddle_tpu.ops import loss as J  # noqa: E402

from paddle_tpu_torch import nn  # noqa: E402
from paddle_tpu_torch.ops import loss as P  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
REDUCTIONS = ["mean", "sum", "none"]


def _check(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _check(g, w)
        return
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    assert not np.isnan(want).any()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _both(fn_name, *arrays, **kw):
    """``(port result, JAX result)`` of ``fn_name`` on the same arrays."""
    got = getattr(P, fn_name)(*(torch.from_numpy(np.asarray(a))
                                for a in arrays), **kw)
    want = getattr(J, fn_name)(*(jnp.asarray(a) for a in arrays), **kw)
    return got, want


def _rng(seed):
    return np.random.default_rng(seed)


def _logits(rng, shape=(6, 5, 7)):
    return rng.standard_normal(shape).astype(np.float32)


def _probs(rng, shape=(6, 5, 7)):
    e = np.exp(_logits(rng, shape))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _hard(rng, shape=(6, 5), c=7):
    return rng.integers(0, c, shape).astype(np.int64)


# -- the cross-entropy family -------------------------------------------------

@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("use_softmax", [True, False])
@pytest.mark.parametrize("label_form", ["hard", "hard_column", "soft"])
def test_cross_entropy_matches_jax(reduction, use_softmax, label_form):
    rng = _rng(1)
    x = _logits(rng) if use_softmax else _probs(rng)
    lab = _hard(rng)
    if label_form == "hard_column":
        lab = lab[..., None]
    if label_form == "soft":
        lab = _probs(rng)
    _check(*_both("cross_entropy", x, lab, soft_label=label_form == "soft",
                  reduction=reduction, use_softmax=use_softmax))


@pytest.mark.parametrize("axis", [1, -1])
def test_cross_entropy_axis_matches_jax(axis):
    rng = _rng(2)
    x = _logits(rng, (4, 7, 3)) if axis == 1 else _logits(rng)
    lab = _hard(rng, (4, 3)) if axis == 1 else _hard(rng)
    _check(*_both("cross_entropy", x, lab, axis=axis, reduction="none"))
    _check(*_both("softmax_with_cross_entropy", x, lab, axis=axis))


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_cross_entropy_class_weights_match_jax(reduction):
    rng = _rng(3)
    x, lab = _logits(rng), _hard(rng)
    w = rng.random(7).astype(np.float32) + 0.5
    got = P.cross_entropy(torch.from_numpy(x), torch.from_numpy(lab),
                          reduction=reduction, weight=torch.from_numpy(w))
    want = J.cross_entropy(jnp.asarray(x), jnp.asarray(lab),
                           reduction=reduction, weight=jnp.asarray(w))
    _check(got, want)


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_ignore_index(reduction, weighted):
    rng = _rng(4)
    x, lab = _logits(rng, (12, 7)), _hard(rng, (12,))
    lab[[2, 7, 11]] = -100
    w = rng.random(7).astype(np.float32) + 0.5 if weighted else None
    keep = lab != -100
    got = P.cross_entropy(torch.from_numpy(x), torch.from_numpy(lab),
                          reduction=reduction,
                          weight=None if w is None else torch.from_numpy(w))
    kw = {} if w is None else {"weight": jnp.asarray(w)}
    if reduction == "none" or not weighted:
        # unweighted, JAX gives 0 at an ignored row (its "mean" over every
        # position included); weighted, the kept rows are the reference
        want = J.cross_entropy(jnp.asarray(x), jnp.asarray(lab),
                               reduction=reduction) if not weighted else \
            J.cross_entropy(jnp.asarray(x[keep]), jnp.asarray(lab[keep]),
                            reduction="none", **kw)
        if weighted:
            assert np.all(got.numpy()[~keep] == 0)
            got = got[torch.from_numpy(keep)]
        _check(got, want)
        return
    _check(got, J.cross_entropy(jnp.asarray(x[keep]), jnp.asarray(lab[keep]),
                                reduction=reduction, **kw))


@pytest.mark.parametrize("soft_label", [False, True])
def test_softmax_with_cross_entropy_return_softmax(soft_label):
    rng = _rng(5)
    x = _logits(rng)
    lab = _probs(rng) if soft_label else _hard(rng)
    if not soft_label:
        lab[0, 1] = -100
    got = P.softmax_with_cross_entropy(torch.from_numpy(x),
                                       torch.from_numpy(lab), soft_label,
                                       return_softmax=True)
    want = J.softmax_with_cross_entropy(jnp.asarray(x), jnp.asarray(lab),
                                        soft_label, return_softmax=True)
    _check(got, want)


def test_hard_cross_entropy_reduces_bf16_logits_in_fp32():
    rng = _rng(6)
    x, lab = _logits(rng), _hard(rng)
    lab[1, 2] = -100
    got = P.softmax_with_cross_entropy(torch.from_numpy(x).bfloat16(),
                                       torch.from_numpy(lab))
    want = J.softmax_with_cross_entropy(jnp.asarray(x, jnp.bfloat16),
                                        jnp.asarray(lab))
    assert got.dtype == torch.float32
    _check(got, want)


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("weighted", [False, True])
def test_nll_loss_matches_jax(reduction, weighted):
    rng = _rng(7)
    lp = np.log(_probs(rng, (10, 6)))
    lab = _hard(rng, (10,), 6)
    w = rng.random(6).astype(np.float32) + 0.5 if weighted else None
    kw = {} if w is None else {"weight": w}
    got = P.nll_loss(torch.from_numpy(lp), torch.from_numpy(lab),
                     reduction=reduction,
                     **{k: torch.from_numpy(v) for k, v in kw.items()})
    _check(got, J.nll_loss(jnp.asarray(lp), jnp.asarray(lab),
                           reduction=reduction,
                           **{k: jnp.asarray(v) for k, v in kw.items()}))
    # an ignored row: JAX's result is NaN; its kept rows are the reference
    lab[[1, 4]] = -100
    keep = lab != -100
    got = P.nll_loss(torch.from_numpy(lp), torch.from_numpy(lab),
                     reduction=reduction,
                     **{k: torch.from_numpy(v) for k, v in kw.items()})
    want = J.nll_loss(jnp.asarray(lp[keep]), jnp.asarray(lab[keep]),
                      reduction=reduction,
                      **{k: jnp.asarray(v) for k, v in kw.items()})
    if reduction == "none":
        assert np.all(got.numpy()[~keep] == 0)
        got = got[torch.from_numpy(keep)]
    _check(got, want)


# -- the binary losses ------------------------------------------------------

@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("weighted", [False, True])
def test_bce_losses_match_jax(reduction, weighted):
    rng = _rng(8)
    logit = rng.standard_normal((8, 3)).astype(np.float32) * 3
    prob = 1 / (1 + np.exp(-logit))
    lab = rng.integers(0, 2, (8, 3)).astype(np.float32)
    w = (rng.random(3).astype(np.float32) + 0.5) if weighted else None
    kw = {} if w is None else {"weight": w}

    def call(fn, *arrays, weights=True, **extra):
        given = {**(kw if weights else {}), **extra}
        t = {k: torch.from_numpy(v) for k, v in given.items()}
        j = {k: jnp.asarray(v) for k, v in given.items()}
        return (getattr(P, fn)(*map(torch.from_numpy, arrays),
                               reduction=reduction, **t),
                getattr(J, fn)(*map(jnp.asarray, arrays),
                               reduction=reduction, **j))

    _check(*call("bce_loss", prob, lab))
    _check(*call("binary_cross_entropy_with_logits", logit, lab))
    _check(*call("binary_cross_entropy_with_logits", logit, lab,
                 pos_weight=np.float32([1.5, 0.5, 2.0])))
    _check(*call("sigmoid_focal_loss", logit, lab, weights=False))


@pytest.mark.parametrize("normalize", [False, True])
def test_sigmoid_cross_entropy_with_logits_matches_jax(normalize):
    rng = _rng(9)
    x = rng.standard_normal((6, 4)).astype(np.float32)
    lab = rng.integers(0, 2, (6, 4)).astype(np.float32)
    lab[0, 0] = lab[3, 2] = -100
    _check(*_both("sigmoid_cross_entropy_with_logits", x, lab,
                  normalize=normalize))


def test_sigmoid_focal_loss_normalizer_matches_jax():
    rng = _rng(10)
    x = rng.standard_normal((6, 4)).astype(np.float32)
    lab = rng.integers(0, 2, (6, 4)).astype(np.float32)
    _check(*_both("sigmoid_focal_loss", x, lab, normalizer=4.0, alpha=0.4,
                  gamma=1.5, reduction="mean"))


# -- regression, margin and ranking losses -------------------------------

@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_regression_losses_match_jax(reduction):
    rng = _rng(11)
    x, y = (rng.standard_normal((5, 6)).astype(np.float32) * 2
            for _ in range(2))
    _check(*_both("mse_loss", x, y, reduction=reduction))
    _check(*_both("l1_loss", x, y, reduction=reduction))
    _check(*_both("smooth_l1_loss", x, y, delta=0.7, reduction=reduction))


def test_elementwise_losses_match_jax():
    rng = _rng(12)
    x = rng.standard_normal((5, 6)).astype(np.float32) * 2
    y = rng.standard_normal((5, 6)).astype(np.float32)
    lab01 = rng.integers(0, 2, (5, 6)).astype(np.float32)
    prob = rng.random((5, 6)).astype(np.float32)
    _check(*_both("square_error_cost", x, y))
    _check(*_both("huber_loss", x, y, delta=0.8))
    _check(*_both("modified_huber_loss", x, lab01))
    _check(*_both("hinge_loss", x, lab01))
    _check(*_both("log_loss", prob, lab01))
    _check(*_both("teacher_student_sigmoid_loss", x * 10, prob))
    _check(*_both("squared_l2_distance", x, y))


@pytest.mark.parametrize("reduction", REDUCTIONS + ["batchmean"])
def test_kl_div_matches_jax(reduction):
    rng = _rng(13)
    inp = np.log(_probs(rng, (4, 6)))
    lab = _probs(rng, (4, 6))
    lab[0, :2] = 0.0  # zero targets contribute nothing
    _check(*_both("kl_div", inp, lab, reduction=reduction))


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_margin_and_embedding_losses_match_jax(reduction):
    rng = _rng(14)
    a, b = (rng.standard_normal(9).astype(np.float32) for _ in range(2))
    sign = rng.choice([-1.0, 1.0], 9).astype(np.float32)
    _check(*_both("margin_ranking_loss", a, b, sign, margin=0.3,
                  reduction=reduction))
    e1, e2, e3 = (rng.standard_normal((7, 5)).astype(np.float32)
                  for _ in range(3))
    _check(*_both("cosine_embedding_loss", e1, e2, sign[:7], margin=0.1,
                  reduction=reduction))
    for p in (1.0, 2.0, 3.0):
        _check(*_both("triplet_margin_loss", e1, e2, e3, margin=0.5, p=p,
                      reduction=reduction))


def test_rank_losses_match_jax():
    rng = _rng(15)
    left, right = (rng.standard_normal(8).astype(np.float32)
                   for _ in range(2))
    lab = rng.integers(0, 2, 8).astype(np.float32)
    _check(*_both("margin_rank_loss", lab * 2 - 1, left, right, margin=0.2))
    _check(*_both("rank_loss", lab, left, right))
    scores = rng.standard_normal((6, 5)).astype(np.float32)
    _check(*_both("bpr_loss", scores, _hard(rng, (6, 1), 5)))


@pytest.mark.parametrize("update_centers", [False, True])
def test_center_loss_matches_jax(update_centers):
    rng = _rng(16)
    feats = rng.standard_normal((9, 4)).astype(np.float32)
    centers = rng.standard_normal((3, 4)).astype(np.float32)
    lab = np.array([0, 2, 2, 1, 0, 0, 2, 1, 2])
    _check(*_both("center_loss", feats, lab, centers, alpha=0.3,
                  update_centers=update_centers))


def test_dice_loss_matches_jax():
    rng = _rng(17)
    _check(*_both("dice_loss", _probs(rng, (3, 4, 5)),
                  _hard(rng, (3, 4, 1), 5)))


# -- the layers -------------------------------------------------------------

def _layer_cases(rng):
    x, y = (rng.standard_normal((6, 5)).astype(np.float32) for _ in range(2))
    lab = _hard(rng, (6,), 5)
    lab01 = rng.integers(0, 2, (6, 5)).astype(np.float32)
    prob = 1 / (1 + np.exp(-x))
    sign = rng.choice([-1.0, 1.0], 6).astype(np.float32)
    w = rng.random(5).astype(np.float32) + 0.5
    return [
        ("CrossEntropyLoss", {}, (x, lab)),
        ("CrossEntropyLoss", {"weight": w}, (x, lab)),
        ("CrossEntropyLoss", {"soft_label": True},
         (x, _probs(rng, (6, 5)))),
        ("MSELoss", {}, (x, y)),
        ("L1Loss", {}, (x, y)),
        ("NLLLoss", {"weight": w}, (np.log(_probs(rng, (6, 5))), lab)),
        ("BCELoss", {"weight": w}, (prob, lab01)),
        ("BCEWithLogitsLoss", {"pos_weight": w}, (x, lab01)),
        ("KLDivLoss", {}, (np.log(_probs(rng, (6, 5))),
                           _probs(rng, (6, 5)))),
        ("SmoothL1Loss", {"delta": 0.5}, (x, y)),
        ("MarginRankingLoss", {"margin": 0.2}, (x[:, 0], y[:, 0], sign)),
        ("CosineEmbeddingLoss", {"margin": 0.1}, (x, y, sign)),
        ("TripletMarginLoss", {"margin": 0.4, "p": 1.5},
         (x, y, prob)),
    ]


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_loss_layers_match_jax(reduction):
    rng = _rng(18)
    for name, kw, arrays in _layer_cases(rng):
        kw_t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                for k, v in kw.items()}
        kw_j = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                for k, v in kw.items()}
        port = getattr(nn, name)(reduction=reduction, **kw_t)
        ref = getattr(jax_layers, name)(reduction=reduction, **kw_j)
        assert isinstance(port, torch.nn.Module)
        _check(port(*map(torch.from_numpy, arrays)),
               ref(*map(jnp.asarray, arrays)))


def test_loss_layer_gradient_flows():
    x = torch.randn(4, 3, requires_grad=True)
    nn.CrossEntropyLoss()(x, torch.tensor([0, 2, 1, 2])).backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_unknown_reduction_raises():
    with pytest.raises(ValueError, match="reduction"):
        P.mse_loss(torch.zeros(2), torch.zeros(2), reduction="avg")
