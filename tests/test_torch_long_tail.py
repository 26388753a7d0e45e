"""PyTorch port: ``reader``, ``vision`` (transforms and re-exports),
``nets``, ``distribution``, ``utils`` and ``version`` against the JAX
package on the CPU.

- ``reader``: every decorator's output equal to the JAX decorator's on
  the same readers (``shuffle`` and ``xmap_readers(order=False)`` as
  multisets), ``batch``'s and ``buffered``'s observability series.
- ``vision.transforms``: every transform equal to the JAX one on the same
  image, the drawing ones from the same seed.
- ``nets``: the four composites' outputs and gradients within ``TOL`` of
  the reference's largest entry, and their shape errors.
- ``distribution``: ``log_prob``, ``entropy``, ``probs`` and every
  ``kl_divergence`` pair within ``TOL``; ``sample`` by shape, device,
  law (moments over 20,000 draws) and the same draw from the same seed.
- ``utils``: DLPack both ways, the cipher (a JAX blob decrypts in the
  port and back), ``op_bench`` and ``run_check`` on the CPU; ``version``'s
  fields.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import paddle_tpu as jpt  # noqa: E402
from paddle_tpu import distribution as JDist  # noqa: E402
from paddle_tpu import nets as jnets  # noqa: E402
from paddle_tpu import reader as jreader  # noqa: E402
from paddle_tpu import version as jversion  # noqa: E402
from paddle_tpu import vision as jvision  # noqa: E402
from paddle_tpu.utils import crypto as jcrypto  # noqa: E402
from paddle_tpu.vision import transforms as JT  # noqa: E402

from paddle_tpu_torch import distribution as PDist  # noqa: E402
from paddle_tpu_torch import nets as pnets  # noqa: E402
from paddle_tpu_torch import observability as obs  # noqa: E402
from paddle_tpu_torch import reader as preader  # noqa: E402
from paddle_tpu_torch import version as pversion  # noqa: E402
from paddle_tpu_torch import vision as pvision  # noqa: E402
from paddle_tpu_torch.utils import crypto as pcrypto  # noqa: E402
from paddle_tpu_torch.utils import dlpack, op_bench, run_check  # noqa: E402
from paddle_tpu_torch.vision import transforms as PT  # noqa: E402

TOL = 1e-5
RNG = np.random.default_rng(0)


def _close(got, want, what="", tol=TOL):
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    finite = np.isfinite(w)
    np.testing.assert_array_equal(np.isfinite(g), finite, err_msg=what)
    np.testing.assert_array_equal(g[~finite], w[~finite], err_msg=what)
    scale = max(float(np.max(np.abs(w[finite]), initial=0.0)), 1e-30)
    err = float(np.max(np.abs(g[finite] - w[finite]), initial=0.0)) / scale
    assert err <= tol, (what, err)


# -- reader ------------------------------------------------------------------

def _r(n=10):
    return lambda: iter(range(n))


def _r2():
    return lambda: iter("abcdefghij")


def _same_reader(name, make):
    j = list(make(jreader)())
    p = list(make(preader)())
    assert p == j, (name, p, j)
    return p


READERS = {
    "cache": lambda R: R.cache(_r()),
    "map_readers": lambda R: R.map_readers(lambda a, b: f"{a}{b}", _r(),
                                           _r2()),
    "chain": lambda R: R.chain(_r(3), _r(4)),
    "compose": lambda R: R.compose(_r(), _r2()),
    "compose_unchecked": lambda R: R.compose(_r(3), _r2(),
                                             check_alignment=False),
    "buffered": lambda R: R.buffered(_r(25), 4),
    "firstn": lambda R: R.firstn(_r(), 4),
    "xmap_ordered": lambda R: R.xmap_readers(lambda x: x * x, _r(30), 3, 4,
                                             order=True),
    "batch": lambda R: R.batch(_r(), 3),
    "batch_drop_last": lambda R: R.batch(_r(), 3, drop_last=True),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_matches_jax(name):
    _same_reader(name, READERS[name])


def test_reader_unordered_and_shuffled_keep_the_samples():
    for make in (lambda R: R.shuffle(_r(50), 8),
                 lambda R: R.xmap_readers(lambda x: -x, _r(40), 4, 8,
                                          order=False)):
        assert sorted(make(preader)()) == sorted(make(jreader)())


def test_reader_errors_match_jax():
    for fn in (lambda R: R.batch(_r(), 0),
               lambda R: list(R.compose(_r(3), _r(4))())):
        with pytest.raises(Exception) as je:
            fn(jreader)
        with pytest.raises(type(je.value)) as pe:
            fn(preader)
        assert str(pe.value) == str(je.value)


def test_reader_feeds_a_loop_and_counts_batches():
    """xmap -> buffered -> batch feeding a loop; with metrics on, the
    batches and the buffer's waits are counted as in the JAX package."""
    from paddle_tpu_torch import get_flags, set_flags
    flag = get_flags(["enable_metrics"])["enable_metrics"]
    set_flags({"enable_metrics": True})
    try:
        counter = obs.counter("reader_batches_total")
        hist = obs.histogram("reader_buffer_wait_seconds")
        before, waits = counter.value(), hist.count()
        reader = preader.batch(preader.buffered(preader.xmap_readers(
            lambda x: x * 2, _r(12), 2, 4, order=True), 3), 4)
        total = sum(sum(b) for b in reader())
        assert total == 2 * sum(range(12))
        assert counter.value() - before == 3
        assert hist.count() - waits == 13  # 12 samples and the end mark
    finally:
        set_flags({"enable_metrics": flag})


# -- vision ------------------------------------------------------------------

TRANSFORMS = {
    "normalize": lambda T: T.Normalize(mean=[0.5, 0.4, 0.3],
                                       std=[0.2, 0.3, 0.4]),
    "resize": lambda T: T.Resize((5, 7)),
    "resize_int": lambda T: T.Resize(6),
    "center_crop": lambda T: T.CenterCrop(4),
    "random_crop": lambda T: T.RandomCrop(5, padding=2, seed=3),
    "flip": lambda T: T.RandomHorizontalFlip(0.5, seed=1),
    "transpose": lambda T: T.Transpose((1, 2, 0)),
    "to_chw": lambda T: T.ToCHW(),
    "pad": lambda T: T.Pad(2),
    "brightness": lambda T: T.BrightnessTransform(0.4, seed=5),
    "compose": lambda T: T.Compose([T.Pad(1), T.RandomCrop(6, seed=2),
                                    T.Normalize([0.1], [0.9])]),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name):
    img = RNG.random((3, 8, 9)).astype(np.float32)
    if name == "to_chw":
        img = img.transpose(1, 2, 0)
    jt, pt_ = TRANSFORMS[name](JT), TRANSFORMS[name](PT)
    for _ in range(4):  # the drawing ones draw alike call after call
        j, p = jt(img.copy()), pt_(img.copy())
        assert p.dtype == j.dtype, name
        np.testing.assert_array_equal(p, j, err_msg=name)


def test_vision_exports_match_jax():
    names = {n for n in vars(jvision) if not n.startswith("_")}
    assert names <= set(vars(pvision)), names - set(vars(pvision))
    assert set(JT.__all__) == set(PT.__all__)


# -- nets --------------------------------------------------------------------

def _grads(jfn, pfn, arrays):
    """Output and gradients of sum(out * w) over every array."""
    jout = jfn(*[jnp.asarray(a) for a in arrays])
    w = RNG.standard_normal(np.shape(jout)).astype(np.float32)
    jg = jax.grad(lambda *xs: jnp.sum(jfn(*xs) * w),
                  argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    pout = pfn(*ts)
    (pout * torch.from_numpy(w)).sum().backward()
    _close(pout, jout, "out")
    for i, (t, g) in enumerate(zip(ts, jg)):
        _close(t.grad, g, f"d arg {i}")


def test_simple_img_conv_pool_matches_jax():
    x = RNG.standard_normal((2, 3, 8, 8)).astype(np.float32)
    w = RNG.standard_normal((4, 3, 3, 3)).astype(np.float32)
    b = RNG.standard_normal(4).astype(np.float32)
    for pool_type, glob in (("max", False), ("avg", False), ("max", True)):
        def call(N, x, w, b, pool_type=pool_type, glob=glob):
            return N.simple_img_conv_pool(
                x, 4, 3, pool_size=2, pool_stride=2, conv_weight=w,
                conv_bias=b, conv_padding=1, act="relu",
                pool_type=pool_type, global_pooling=glob)
        _grads(lambda *a: call(jnets, *a), lambda *a: call(pnets, *a),
               [x, w, b])
    with pytest.raises(ValueError) as je:
        jnets.simple_img_conv_pool(jnp.asarray(x), 8, 3, 2, 2,
                                   conv_weight=jnp.asarray(w))
    with pytest.raises(ValueError) as pe:
        pnets.simple_img_conv_pool(torch.from_numpy(x), 8, 3, 2, 2,
                                   conv_weight=torch.from_numpy(w))
    assert str(pe.value) == str(je.value)


def test_img_conv_group_matches_jax():
    x = RNG.standard_normal((2, 3, 8, 8)).astype(np.float32)
    ws = [RNG.standard_normal((6, 3, 3, 3)).astype(np.float32) * 0.3,
          RNG.standard_normal((6, 6, 3, 3)).astype(np.float32) * 0.3]
    bn = [(np.ones(6, np.float32), np.zeros(6, np.float32),
           np.zeros(6, np.float32), np.ones(6, np.float32))] * 2

    def call(N, conv, x, w0, w1, training):
        cast = jnp.asarray if N is jnets else torch.from_numpy
        params = [tuple(cast(a) for a in p) for p in bn]
        return N.img_conv_group(x, [6, 6], pool_size=2, conv_weights=[w0, w1],
                                bn_params=params, conv_act="relu",
                                conv_with_batchnorm=True, pool_stride=2,
                                training=training)

    for training in (True, False):
        _grads(lambda *a, t=training: call(jnets, None, *a, t),
               lambda *a, t=training: call(pnets, None, *a, t),
               [x] + ws)
    for bad in (lambda N, c: N.img_conv_group(c(x), [6, 6], 2,
                                              [c(w) for w in ws],
                                              conv_with_batchnorm=True),
                lambda N, c: N.img_conv_group(c(x), [6, 6, 6], 2,
                                              [c(w) for w in ws])):
        with pytest.raises(ValueError) as je:
            bad(jnets, jnp.asarray)
        with pytest.raises(ValueError) as pe:
            bad(pnets, torch.from_numpy)
        assert str(pe.value) == str(je.value)


def test_sequence_conv_pool_matches_jax():
    x = RNG.standard_normal((3, 7, 4)).astype(np.float32)
    length = np.array([7, 3, 5])
    w = RNG.standard_normal((3 * 4, 5)).astype(np.float32)
    b = RNG.standard_normal(5).astype(np.float32)
    for pool in ("max", "sum", "average"):
        _grads(lambda x, w, b, p=pool: jnets.sequence_conv_pool(
                   x, jnp.asarray(length), 5, 3, w, b, pool_type=p),
               lambda x, w, b, p=pool: pnets.sequence_conv_pool(
                   x, torch.from_numpy(length), 5, 3, w, b, pool_type=p),
               [x, w, b])
    with pytest.raises(ValueError) as je:
        jnets.sequence_conv_pool(jnp.asarray(x), length, 5, 2,
                                 jnp.asarray(w))
    with pytest.raises(ValueError) as pe:
        pnets.sequence_conv_pool(torch.from_numpy(x), length, 5, 2,
                                 torch.from_numpy(w))
    assert str(pe.value) == str(je.value)


def test_glu_and_attention_match_jax():
    x = RNG.standard_normal((2, 6, 8)).astype(np.float32)
    _grads(lambda x: jnets.glu(x, axis=-1), lambda x: pnets.glu(x, axis=-1),
           [x])
    q, k, v = (RNG.standard_normal((2, 2, 5, 4)).astype(np.float32)
               for _ in range(3))
    _grads(lambda q, k, v: jnets.scaled_dot_product_attention(q, k, v),
           lambda q, k, v: pnets.scaled_dot_product_attention(q, k, v),
           [q, k, v])


# -- distribution --------------------------------------------------------------

def _dists(M, cast):
    loc = RNG.standard_normal((3, 4)).astype(np.float32)
    scale = (RNG.random((3, 4)) + 0.5).astype(np.float32)
    logits = RNG.standard_normal((3, 5)).astype(np.float32)
    kw = {} if M is JDist else {"device": "cpu"}
    return {
        "uniform": M.Uniform(cast(loc - 1), cast(loc + scale), **kw),
        "uniform_in": M.Uniform(cast(loc - 0.5), cast(loc + 0.2), **kw),
        "normal": M.Normal(cast(loc), cast(scale), **kw),
        "normal2": M.Normal(cast(loc * 0.5), cast(scale * 2), **kw),
        "categorical": M.Categorical(cast(logits), **kw),
        "categorical2": M.Categorical(cast(logits[::-1].copy()), **kw),
        "mvn": M.MultivariateNormalDiag(cast(loc), cast(scale), **kw),
        "mvn2": M.MultivariateNormalDiag(cast(-loc), cast(scale + 1),
                                         **kw),
    }


RNG_STATE = RNG.bit_generator.state


def _pair_dists():
    RNG.bit_generator.state = RNG_STATE
    j = _dists(JDist, jnp.asarray)
    RNG.bit_generator.state = RNG_STATE
    p = _dists(PDist, lambda a: torch.from_numpy(np.asarray(a)))
    return j, p


@pytest.mark.parametrize("name", ["uniform", "normal", "categorical",
                                  "mvn"])
def test_distribution_matches_jax(name):
    j, p = _pair_dists()
    jd, pd = j[name], p[name]
    if name == "categorical":
        value = RNG.integers(0, 5, (3,))
    elif name == "mvn":
        value = RNG.standard_normal((3, 4)).astype(np.float32)
    else:
        # some values outside the uniform's support: -inf on both
        value = (RNG.standard_normal((3, 4)) * 2).astype(np.float32)
    _close(pd.log_prob(value), jd.log_prob(jnp.asarray(value)), "log_prob")
    _close(pd.probs(value), jd.probs(jnp.asarray(value)), "probs")
    _close(pd.entropy(), jd.entropy(), "entropy")


@pytest.mark.parametrize("pair", [("normal", "normal2"), ("mvn", "mvn2"),
                                  ("categorical", "categorical2"),
                                  ("uniform_in", "uniform"),
                                  ("uniform", "uniform_in"),
                                  ("uniform", "normal")])
def test_kl_divergence_matches_jax(pair):
    j, p = _pair_dists()
    a, b = pair
    _close(PDist.kl_divergence(p[a], p[b]), JDist.kl_divergence(j[a], j[b]),
           f"kl {pair}")
    _close(p[a].kl_divergence(p[b]), j[a].kl_divergence(j[b]), f"kl {pair}")
    with pytest.raises(NotImplementedError):
        PDist.kl_divergence(p["normal"], p["categorical"])


def test_distribution_sample_law_shape_and_seed():
    n = 20000
    u = PDist.Uniform(-1.0, 3.0, device="cpu")
    s = u.sample((n,), key=0)
    assert s.shape == (n,) and s.device.type == "cpu"
    assert abs(float(s.mean()) - 1.0) < 0.05 and float(s.min()) >= -1.0
    torch.testing.assert_close(s, u.sample((n,), key=0), rtol=0, atol=0)
    g = torch.Generator().manual_seed(0)
    torch.testing.assert_close(u.sample((n,), key=g), s, rtol=0, atol=0)
    nrm = PDist.Normal(torch.tensor([0.0, 2.0]), torch.tensor([1.0, 0.5]))
    s = nrm.sample((n,), key=1)
    assert s.shape == (n, 2)
    np.testing.assert_allclose(s.mean(0).numpy(), [0.0, 2.0], atol=0.03)
    np.testing.assert_allclose(s.std(0).numpy(), [1.0, 0.5], atol=0.03)
    mvn = PDist.MultivariateNormalDiag(torch.zeros(3), torch.full((3,), 2.))
    assert mvn.sample((n,), key=2).std(0).sub(2.0).abs().max() < 0.06
    logits = torch.tensor([[0.0, 1.0, 2.0], [2.0, 0.0, -1.0]])
    cat = PDist.Categorical(logits)
    s = cat.sample((n,), key=3)
    assert s.shape == (n, 2) and s.dtype == torch.int64
    freq = torch.stack([torch.bincount(s[:, i], minlength=3) / n
                        for i in range(2)])
    np.testing.assert_allclose(freq.numpy(),
                               torch.softmax(logits, -1).numpy(), atol=0.02)
    # reparameterized: the sample's gradient reaches the parameters
    loc = torch.zeros(4, requires_grad=True)
    PDist.Normal(loc, torch.ones(4)).sample((8,), key=4).sum().backward()
    np.testing.assert_array_equal(loc.grad.numpy(), np.full(4, 8.0))


def test_distribution_parameters_go_to_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is exercised there")
    with pytest.raises((RuntimeError, AssertionError)):
        PDist.Normal(0.0, 1.0)


# -- utils and version -----------------------------------------------------------

def test_dlpack_roundtrips():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = dlpack.from_dlpack(x)
    assert isinstance(t, torch.Tensor)
    np.testing.assert_array_equal(t.numpy(), x)
    back = dlpack.from_dlpack(dlpack.to_dlpack(t))
    assert back.data_ptr() == t.data_ptr()  # zero copy
    j = jnp.arange(6, dtype=jnp.float32).reshape(2, 3)
    np.testing.assert_array_equal(dlpack.from_dlpack(j).numpy(),
                                  np.asarray(j))
    np.testing.assert_array_equal(
        np.asarray(jax.dlpack.from_dlpack(torch.arange(5.0))),
        np.arange(5.0, dtype=np.float32))


def test_cipher_interoperates_with_jax(tmp_path):
    key = pcrypto.CipherUtils.gen_key(256)
    msg = b"model bytes \x00\x01\x02" * 100
    pc, jc = pcrypto.CipherFactory.create_cipher(), jcrypto.Cipher()
    assert pc.decrypt(jc.encrypt(msg, key), key) == msg
    assert jc.decrypt(pc.encrypt(msg, key), key) == msg
    with pytest.raises(ValueError, match="integrity"):
        pc.decrypt(jc.encrypt(msg, key), pcrypto.CipherUtils.gen_key(256))
    blob = bytearray(pc.encrypt(msg, key))
    blob[len(blob) // 2] ^= 0xFF
    with pytest.raises(ValueError, match="integrity"):
        pc.decrypt(bytes(blob), key)
    k = pcrypto.CipherUtils.gen_key_to_file(128, str(tmp_path / "k"))
    assert jcrypto.CipherUtils.read_key_from_file(str(tmp_path / "k")) == k
    pc.encrypt_to_file(b"weights", k, str(tmp_path / "m.enc"))
    assert jc.decrypt_from_file(k, str(tmp_path / "m.enc")) == b"weights"
    with pytest.raises(ValueError):
        pcrypto.CipherUtils.gen_key(100)


def test_op_bench_and_run_check_on_the_cpu(capsys):
    res = op_bench.bench_op(torch.matmul, torch.ones(64, 64),
                            torch.ones(64, 64), iters=3, warmup=1)
    assert res["ms"] > 0 and res["ops_per_sec"] > 0
    # a callable over its own tensors times on the device it is given;
    # given none, on the card, which this machine lacks
    a = torch.ones(64, 64)
    res = op_bench.bench_op(lambda: a @ a, iters=3, warmup=1,
                            device="cpu")
    assert res["ms"] > 0 and res["ops_per_sec"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            op_bench.bench_op(lambda: a @ a, iters=1, warmup=0)
    ops = op_bench.registered_ops("cpu")
    assert set(ops) == {"matmul", "softmax", "layer_norm", "conv2d"}
    assert ops["layer_norm"]((16, 32))()["ms"] > 0
    assert op_bench.main(["nope"]) == 2
    assert run_check(verbose=True, device="cpu")
    assert "installed and working" in capsys.readouterr().out


def test_version_fields_match_jax():
    for name in ("__version__", "full_version", "major", "minor", "patch",
                 "rc"):
        assert getattr(pversion, name) == getattr(jversion, name), name
