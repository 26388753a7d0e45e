"""PyTorch port: ``nn.decode`` (``dynamic_decode`` over ``BasicDecoder``
with each helper, and ``BeamSearchDecoder``) against the JAX package on
the CPU, built as ``tests/test_decode.py`` builds them: a GRU cell, an
embedding and an output projection, the JAX weights moved into the port
by ``convert.load_jax_params``.

Logits and final states agree within ``TOL`` of the largest entry (fp32,
sums in another order); sampled ids, lengths, beams exactly. The sampling
helper cannot match threefry's bits: it is checked by shape, range, the
same draws from the same seed, and the lengths its ids imply.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import paddle_tpu as jpt  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402

from paddle_tpu_torch import nn as pnn  # noqa: E402
from paddle_tpu_torch.convert import load_jax_params  # noqa: E402

TOL = 1e-5
VOCAB, EMB, HID = 12, 8, 16


def _close(got, want, what=""):
    g = got.detach().numpy()
    w = np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = max(float(np.max(np.abs(w), initial=0.0)), 1e-30)
    assert float(np.max(np.abs(g - w), initial=0.0)) <= TOL * scale, what


def _setup():
    jpt.seed(3)
    j = (jnn.GRUCell(EMB, HID), jnn.Embedding(VOCAB, EMB),
         jnn.Linear(HID, VOCAB))
    p = (pnn.GRUCell(EMB, HID, device="cpu"),
         pnn.Embedding(VOCAB, EMB, device="cpu"),
         pnn.Linear(HID, VOCAB, device="cpu"))
    for jl, pl in zip(j, p):
        load_jax_params(pl, {k: np.asarray(v)
                             for k, v in jl.param_dict().items()})
    return j, p


def _states(cell, b, lib):
    rng = np.random.default_rng(1)
    s = rng.standard_normal((b, HID)).astype(np.float32)
    return torch.from_numpy(s) if lib is torch else jnp.asarray(s)


def _run(mod, parts, helper, b, t, lib, **kw):
    cell, _, proj = parts
    dec = mod.BasicDecoder(cell, helper, output_fn=proj)
    return mod.dynamic_decode(dec, _states(cell, b, lib), max_step_num=t,
                              batch_size=b, **kw)


def _agree(got, want):
    (logits, ids), final, lens = got
    (jlogits, jids), jfinal, jlens = want
    _close(logits, jlogits, "logits")
    _close(final, jfinal, "final states")
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))


@pytest.mark.parametrize("lengths", [None, [6, 2, 4]])
@pytest.mark.parametrize("time_major", [False, True])
def test_training_helper_matches_jax(lengths, time_major):
    j, p = _setup()
    b, t = 3, 6
    gt = np.random.default_rng(0).integers(0, VOCAB, (b, t))
    jh = jnn.TrainingHelper(j[1](jnp.asarray(gt)), sequence_length=None
                            if lengths is None else np.array(lengths))
    ph = pnn.TrainingHelper(p[1](torch.from_numpy(gt)),
                            sequence_length=None if lengths is None
                            else torch.tensor(lengths))
    got = _run(pnn, p, ph, b, t, torch, output_time_major=time_major)
    want = _run(jnn, j, jh, b, t, jnp, output_time_major=time_major)
    _agree(got, want)


@pytest.mark.parametrize("impute", [True, False])
def test_greedy_helper_matches_jax(impute):
    j, p = _setup()
    b = 4
    start = np.array([0, 3, 5, 7])
    # end token 2: some rows finish early
    jh = jnn.GreedyEmbeddingHelper(j[1], start, 2)
    ph = pnn.GreedyEmbeddingHelper(p[1], torch.from_numpy(start), 2)
    got = _run(pnn, p, ph, b, 8, torch, impute_finished=impute)
    want = _run(jnn, j, jh, b, 8, jnp, impute_finished=impute)
    _agree(got, want)


def test_sample_helper_by_shape_and_seed():
    _, p = _setup()
    b, t = 8, 6
    start = torch.zeros(b, dtype=torch.int64)
    runs = []
    for key in (0, 0, 7):
        h = pnn.SampleEmbeddingHelper(p[1], start, 1,
                                      softmax_temperature=2.0, key=key)
        runs.append(_run(pnn, p, h, b, t, torch))
    (_, ids), _, lens = runs[0]
    assert ids.shape == (b, t) and ids.min() >= 0 and ids.max() < VOCAB
    assert torch.equal(ids, runs[1][0][1])
    assert not torch.equal(ids, runs[2][0][1])
    # a row's length is one past its first end token (else t)
    for row, n in zip(ids.tolist(), lens.tolist()):
        want = row.index(1) + 1 if 1 in row else t
        assert n == want


def test_beam_search_decoder_matches_jax():
    j, p = _setup()
    b, beam, t = 3, 4, 7
    kw = dict(start_token=0, end_token=1, beam_size=beam)
    jd = jnn.BeamSearchDecoder(j[0], embedding_fn=j[1], output_fn=j[2],
                               length_penalty=0.6, **kw)
    pd = pnn.BeamSearchDecoder(p[0], embedding_fn=p[1], output_fn=p[2],
                               length_penalty=0.6, **kw)
    jseq, jscore = jnn.dynamic_decode(jd, inits=_states(j[0], b, jnp),
                                      max_step_num=t)
    seq, score = pnn.dynamic_decode(pd, inits=_states(p[0], b, torch),
                                    max_step_num=t)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    _close(score, jscore, "scores")
