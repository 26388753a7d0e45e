"""PyTorch port: ``datasets`` and ``native.Tokenizer`` against the JAX
package.

- Every dataset in ``mode="synthetic"``: equal item for item (values and
  dtypes) with the JAX package's, drawn from the same numpy seeds.
- The parsers on the files the JAX tests write: each test of
  ``tests/test_datasets.py`` runs as it is, with every dataset class it
  builds replaced by a spy that builds the port's dataset from the same
  arguments beside the JAX one and holds them equal: the items, the
  vocabularies and tables, and, where the JAX constructor raises (a
  missing file), the port's error, type and message. The JAX test's own
  checks run on the JAX dataset. A model the JAX test then trains on the
  data (LeNet through ``DataLoader``, the SRL model, SSDLite) stops the
  test there: this module holds the data, and those models have their
  own port tests.
- ``Tokenizer`` against the JAX ``Tokenizer`` on one corpus: the vocab,
  the frequencies, the lookups, the encodings (text and file, unknown
  words) and the saved file, byte for byte; a closed handle raises.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import inspect

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import paddle_tpu  # noqa: E402
import paddle_tpu.data  # noqa: E402
import paddle_tpu.datasets as JD  # noqa: E402
import paddle_tpu.models  # noqa: E402
import test_datasets as JT  # noqa: E402
from paddle_tpu.native import Tokenizer as JaxTokenizer  # noqa: E402

import paddle_tpu_torch.datasets as PD  # noqa: E402
from paddle_tpu_torch.native import Tokenizer  # noqa: E402

SIMPLE = (bool, int, float, str, bytes, np.ndarray, np.generic)


def _equal(a, b, what):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), what
        for k in a:
            _equal(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, (np.ndarray, np.generic)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (
            what, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, SIMPLE) or a is None:
        assert type(a) is type(b) and a == b, (what, a, b)


def _same(jds, pds, name):
    """Items and the dataset's tables (its attributes that hold data)."""
    assert len(jds) == len(pds), name
    for i in range(len(jds)):
        _equal(jds[i], pds[i], f"{name}[{i}]")
    for k, v in vars(jds).items():
        if isinstance(v, (dict, list, tuple) + SIMPLE):
            assert k in vars(pds), (name, k)
            _equal(v, vars(pds)[k], f"{name}.{k}")


class _StopAfterData(Exception):
    """Raised where a JAX dataset test moves from its data to a model."""


def _stop(*a, **k):
    raise _StopAfterData


def _spy(name, seen):
    """A subclass of the JAX dataset (the JAX module's own references to
    its class keep working) that builds the port's beside it."""
    jcls, pcls = getattr(JD, name), getattr(PD, name)

    class Spy(jcls):
        def __init__(self, *args, **kwargs):
            try:
                super().__init__(*args, **kwargs)
            except Exception as e:
                with pytest.raises(type(e)) as got:
                    pcls(*args, **kwargs)
                assert str(got.value) == str(e), name
                seen.append(f"{name}!")
                raise
            _same(self, pcls(*args, **kwargs), name)
            seen.append(name)

    # pickled by the JAX module's name (the test's loader workers), which
    # resolves to the spy while it is installed
    Spy.__name__ = Spy.__qualname__ = name
    Spy.__module__ = jcls.__module__
    return Spy


JAX_TESTS = sorted(n for n, f in vars(JT).items()
                   if n.startswith("test_") and callable(f))


@pytest.mark.parametrize("name", JAX_TESTS)
def test_parsers_match_jax_on_its_test_files(name, tmp_path, monkeypatch):
    seen = []
    for cls in JD.__all__:
        if cls != "DATA_HOME":
            spy = _spy(cls, seen)
            monkeypatch.setattr(JD, cls, spy)
            if cls in vars(JT):
                monkeypatch.setattr(JT, cls, spy)
    monkeypatch.setattr(paddle_tpu.data, "DataLoader", _stop)
    for model in ("SRLBiLSTMCRF", "SSDLite"):
        monkeypatch.setattr(paddle_tpu.models, model, _stop)
    fn = getattr(JT, name)
    args = {"tmp_path": tmp_path} if "tmp_path" in inspect.signature(
        fn).parameters else {}
    try:
        fn(**args)
    except _StopAfterData:
        pass
    # every JAX test builds a dataset, or only checks transforms
    assert seen or "transform" in name or "resize" in name, name


SYNTHETIC = [n for n in JD.__all__ if n != "DATA_HOME"]


@pytest.mark.parametrize("name", SYNTHETIC)
def test_synthetic_mode_matches_jax(name):
    _same(getattr(JD, name)(mode="synthetic"),
          getattr(PD, name)(mode="synthetic"), name)


def test_data_home_and_require_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PT_DATA_HOME", str(tmp_path))
    assert PD.DATA_HOME() == JD.DATA_HOME() == str(tmp_path)
    monkeypatch.delenv("PT_DATA_HOME")
    assert PD.DATA_HOME() == JD.DATA_HOME()
    missing = str(tmp_path / "nope.gz")
    with pytest.raises(FileNotFoundError) as je:
        JD._require(missing, "https://example.org/x")
    with pytest.raises(FileNotFoundError) as pe:
        PD._require(missing, "https://example.org/x")
    assert str(pe.value) == str(je.value)
    assert PD._require(str(tmp_path), "u") == str(tmp_path)


def test_tokenizer_matches_jax(tmp_path):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("the cat sat on the mat\nthe dog sat\n"
                      "a cat and a dog\n" * 7 + "rare words here\n")
    text = "the cat saw a zebra on the mat"
    with JaxTokenizer.build([str(corpus)], min_freq=2) as jt, \
            Tokenizer.build([str(corpus)], min_freq=2) as pt:
        assert len(pt) == len(jt)
        assert [pt.word(i) for i in range(len(pt))] == \
            [jt.word(i) for i in range(len(jt))]
        np.testing.assert_array_equal(pt.freqs(), jt.freqs())
        for w in ("the", "cat", "rare", "zebra"):
            assert pt.lookup(w) == jt.lookup(w), w
        for unk in (-1, 0):
            np.testing.assert_array_equal(pt.encode(text, unk),
                                          jt.encode(text, unk))
        np.testing.assert_array_equal(pt.encode_file(str(corpus)),
                                      jt.encode_file(str(corpus)))
        with pytest.raises(IndexError):
            pt.word(len(pt) + 5)
        pt.save(str(tmp_path / "p.vocab"))
        jt.save(str(tmp_path / "j.vocab"))
        size, cat = len(jt), jt.lookup("cat")
    assert (tmp_path / "p.vocab").read_bytes() == \
        (tmp_path / "j.vocab").read_bytes()
    with Tokenizer.load(str(tmp_path / "j.vocab")) as loaded:
        assert len(loaded) == size
        assert loaded.lookup("cat") == cat
        assert len(loaded.freqs()) == 0
    closed = Tokenizer.load(str(tmp_path / "p.vocab"))
    closed.close()
    with pytest.raises(RuntimeError):
        len(closed)


def test_tokenizer_regrows_its_encode_buffer(tmp_path):
    """An encoding longer than the first buffer (65,536 ids) grows it and
    encodes again, as the JAX binding does."""
    corpus = tmp_path / "c.txt"
    corpus.write_text("x y\n")
    with Tokenizer.build([str(corpus)]) as pt:
        ids = pt.encode("x y " * 40000)
        want = [pt.lookup("x"), pt.lookup("y")] * 40000
    np.testing.assert_array_equal(ids, want)
