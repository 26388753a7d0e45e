"""PyTorch port: ``ops.metrics_ops`` and ``metric`` against the JAX package
on the CPU.

Both packages get the same seeded numpy inputs. Counts and histograms
(accuracy, AUC buckets, precision/recall counts, ranking pairs, mean
IoU's bins) must agree exactly; the fp32 reductions over them (the AUC
trapezoid sum, the IoU mean) within ``TOL``, torch and XLA summing in
another order. Tied logits are the case ``jax.lax.top_k`` decides
toward the lower index, which the port's counted top-k reproduces.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from paddle_tpu import metric as jax_metric  # noqa: E402
from paddle_tpu.ops import metrics_ops as J  # noqa: E402

from paddle_tpu_torch import metric  # noqa: E402
from paddle_tpu_torch.ops import metrics_ops as P  # noqa: E402

# fp32 sums of up to 2048 terms in another order
TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _logits(rng, n=64, c=10, ties=False):
    x = rng.standard_normal((n, c)).astype(np.float32)
    if ties:
        # a zero-initialised head's rows, rounded rows full of equal
        # values (-0.0 among them, which XLA orders below +0.0), and
        # rows where the label ties the leader
        x[: n // 4] = 0.0
        x[n // 4: n // 2] = np.round(x[n // 4: n // 2])
        x[n // 2:, :3] = x[n // 2:, 3:4]
    return x


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("label_shape", ["flat", "column"])
def test_accuracy_matches_jax_top_k(ties, k, label_shape):
    rng = np.random.default_rng(k + 10 * ties)
    x = _logits(rng, ties=ties)
    lab = rng.integers(0, 10, 64)
    if label_shape == "column":
        lab = lab[:, None]
    want = float(J.accuracy(jnp.asarray(x), jnp.asarray(lab), k))
    got = float(P.accuracy(_t(x), _t(lab), k))
    assert got == want


def test_accuracy_ties_break_toward_the_lower_index():
    x = np.zeros((3, 4), np.float32)
    lab = np.array([0, 1, 3])
    # all tied: only the lowest index is the top 1
    assert float(P.accuracy(_t(x), _t(lab), 1)) == pytest.approx(1 / 3)
    assert float(P.accuracy(_t(x), _t(lab), 2)) == pytest.approx(2 / 3)
    assert float(P.accuracy(_t(x).bfloat16(), _t(lab), 4)) == 1.0
    # -0.0 sorts below +0.0, as in XLA's top_k
    neg = np.array([[-0.0, 0.0]], np.float32)
    assert float(P.accuracy(_t(neg), _t(np.array([0])), 1)) == 0.0
    # a label outside the classes is never in the top k
    assert float(P.accuracy(_t(x), _t(np.array([4, -1, 0])), 4)) \
        == pytest.approx(1 / 3)


def test_auc_stats_and_auc_match_jax():
    rng = np.random.default_rng(1)
    pred = rng.random(500).astype(np.float32)
    # exact 1.0 and 0.0 scores: 1.0 * T is clipped into the top bucket
    pred[:5] = 1.0
    pred[5:10] = 0.0
    lab = rng.integers(0, 2, 500)
    for nt in (2048, 200):
        tp_j, fp_j = J.auc_stats(jnp.asarray(pred), jnp.asarray(lab), nt)
        tp_p, fp_p = P.auc_stats(_t(pred), _t(lab), nt)
        assert np.array_equal(tp_p.numpy(), np.asarray(tp_j))
        assert np.array_equal(fp_p.numpy(), np.asarray(fp_j))
        want = float(J.auc_from_stats(tp_j, fp_j))
        got = float(P.auc_from_stats(tp_p, fp_p))
        assert abs(got - want) <= TOL
    assert float(tp_p[-1] + fp_p[-1]) >= 5


def test_precision_recall_stats_match_jax():
    rng = np.random.default_rng(2)
    pl, tl = rng.integers(0, 6, 300), rng.integers(0, 6, 300)
    for a, b in zip(J.precision_recall_stats(jnp.asarray(pl),
                                             jnp.asarray(tl), 6),
                    P.precision_recall_stats(_t(pl), _t(tl), 6)):
        assert np.array_equal(b.numpy(), np.asarray(a))


def test_positive_negative_pair_matches_jax():
    rng = np.random.default_rng(3)
    score = np.round(rng.random(80), 1).astype(np.float32)  # ties
    label = rng.integers(0, 3, 80).astype(np.float32)
    query = rng.integers(0, 5, 80)
    want = J.positive_negative_pair(jnp.asarray(score), jnp.asarray(label),
                                    jnp.asarray(query))
    got = P.positive_negative_pair(_t(score), _t(label), _t(query))
    assert [float(g) for g in got] == [float(w) for w in want]
    assert float(got[2]) > 0


@pytest.mark.parametrize("out_of_range", [False, True])
def test_mean_iou_matches_jax(out_of_range):
    rng = np.random.default_rng(4)
    pred, lab = rng.integers(0, 7, 400), rng.integers(0, 7, 400)
    if out_of_range:
        # ids at or past C are dropped, negatives count from the end
        pred[::9], lab[::11], pred[::13], lab[::17] = 7, 9, -1, -8
    want = J.mean_iou(jnp.asarray(pred), jnp.asarray(lab), 7)
    got = P.mean_iou(_t(pred), _t(lab), 7)
    assert abs(float(got[0]) - float(want[0])) <= TOL
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == torch.int32
        assert np.array_equal(a.numpy(), np.asarray(b))


def _batches(rng, n=4):
    return [(_logits(rng, 32, 5, ties=i % 2 == 1),
             rng.integers(0, 5, 32)) for i in range(n)]


def test_accuracy_metric_streams_batch_means_like_jax():
    rng = np.random.default_rng(5)
    mj = jax_metric.Accuracy(topk=(1, 3))
    mp = metric.Accuracy(topk=(1, 3))
    for x, y in _batches(rng):
        mj.update(mj.compute(jnp.asarray(x), jnp.asarray(y)))
        mp.update(mp.compute(x, y))  # numpy in, as a user passes it
    assert mp.accumulate() == mj.accumulate()
    assert mp.name() == mj.name() == "accuracy"
    one = metric.Accuracy()
    one.update(one.compute(_t(_batches(rng)[0][0]), _t(np.zeros(32))))
    assert isinstance(one.accumulate(), float)
    # one count per update: the mean of the batch means
    assert one.count[0] == 1


@pytest.mark.parametrize("cls", ["Precision", "Recall"])
def test_precision_recall_metrics_stream_like_jax(cls):
    rng = np.random.default_rng(6)
    mj, mp = getattr(jax_metric, cls)(), getattr(metric, cls)()
    for _ in range(3):
        p, y = rng.random(50).astype(np.float32), rng.integers(0, 2, 50)
        mj.update(jnp.asarray(p), jnp.asarray(y))
        mp.update(_t(p), _t(y))
    assert mp.accumulate() == mj.accumulate()
    mp.reset()
    assert mp.accumulate() == 0.0


@pytest.mark.parametrize("two_column", [False, True])
def test_auc_metric_streams_like_jax(two_column):
    rng = np.random.default_rng(7)
    mj, mp = jax_metric.Auc(num_thresholds=512), metric.Auc(512)
    for _ in range(3):
        p = rng.random(64).astype(np.float32)
        if two_column:
            # the positive class is column 1
            p = np.stack([1 - p, p], axis=1)
        y = rng.integers(0, 2, 64)
        mj.update(jnp.asarray(p), jnp.asarray(y))
        mp.update(_t(p), _t(y))
    assert np.array_equal(mp.tp_buckets, mj.tp_buckets)
    assert abs(mp.accumulate() - mj.accumulate()) <= TOL


def test_accuracy_function_matches_jax():
    rng = np.random.default_rng(8)
    x, y = _logits(rng, ties=True), rng.integers(0, 10, 64)
    assert float(metric.accuracy(x, y, 2)) == float(
        jax_metric.accuracy(jnp.asarray(x), jnp.asarray(y), 2))
