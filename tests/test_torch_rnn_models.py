"""PyTorch port: the recurrent and sequence models (``lstm_lm``,
``crnn_ctc``, ``nlp``, ``word2vec``) against the JAX package on the CPU
at tiny widths.

Each JAX model's parameters (and BatchNorm buffers) move into the port
through ``convert.load_jax_params``; the loss and the gradient of every
parameter agree within ``TOL`` of the reference's largest entry (fp32,
sums in another order), CRNN's BatchNorm statistics too. CRNN's greedy
decode, the SRL model's Viterbi decode and the N-gram model's logits
agree as well (ids exactly). The skip-gram NCE loss runs both sides on
the same given negatives (the log-uniform draws cannot match threefry's
bits).
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import paddle_tpu as jpt  # noqa: E402
from paddle_tpu import models as jm  # noqa: E402
from paddle_tpu.ops.sampling import nce_loss as j_nce  # noqa: E402

from paddle_tpu_torch import models as pm  # noqa: E402
from paddle_tpu_torch.convert import load_jax_params  # noqa: E402
from paddle_tpu_torch.ops.sampling import nce_loss as t_nce  # noqa: E402

TOL = 1e-5
RNG = np.random.default_rng(0)


def _close(got, want, what=""):
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = max(float(np.max(np.abs(w), initial=0.0)), 1e-30)
    err = float(np.max(np.abs(g - w), initial=0.0)) / scale
    assert err <= TOL, (what, err)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _pair(jmodel, pmodel, jloss, ploss, buffers=False, scale_of=None):
    """Moves the JAX weights into ``pmodel`` and holds the loss and every
    gradient (and the BatchNorm statistics after the step's forward).
    ``scale_of`` maps a parameter whose gradient is exactly zero in exact
    arithmetic (a conv bias before BatchNorm: the batch mean cancels it)
    to the parameter whose gradient sets the scale of its rounding
    noise."""
    jb = jmodel.buffer_dict() if buffers else None
    load_jax_params(pmodel, _np(jmodel.param_dict()),
                    _np(jb) if buffers else None)

    def f(p):
        with jmodel.bind(p, jb) as cap:
            loss = jloss(jmodel)
        return loss, (cap.buffers if buffers else {})

    (jl, jnew), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jmodel.param_dict())
    pl = ploss(pmodel)
    pl.backward()
    _close(pl, jl, "loss")
    grads = {n: p.grad for n, p in pmodel.named_parameters()}
    assert set(grads) == set(jg)
    for n in jg:
        ref = (scale_of or {}).get(n)
        if ref is None:
            _close(grads[n], jg[n], f"d {n}")
        else:
            err = float((grads[n] - torch.from_numpy(np.asarray(
                jg[n]))).abs().max())
            assert err <= TOL * float(np.abs(np.asarray(jg[ref])).max()), n
    if buffers:
        own = dict(pmodel.named_buffers())
        for n, v in jnew.items():
            _close(own[n], v, n)


@pytest.mark.parametrize("tie", [True, False])
def test_lstm_lm_matches_jax(tie):
    cfg = dict(vocab_size=40, hidden_size=12, num_layers=2, dropout=0.0,
               tie_weights=tie)
    jpt.seed(1)
    jmodel = jm.LSTMLanguageModel(jm.LMConfig(**cfg))
    pmodel = pm.LSTMLanguageModel(pm.LMConfig(**cfg), device="cpu")
    ids = RNG.integers(0, 40, (3, 7))
    nxt = RNG.integers(0, 40, (3, 7))
    from paddle_tpu.ops.loss import cross_entropy as j_ce
    from paddle_tpu_torch.ops.loss import cross_entropy as p_ce
    _pair(jmodel, pmodel,
          lambda m: j_ce(m(jnp.asarray(ids)), jnp.asarray(nxt)),
          lambda m: p_ce(m(torch.from_numpy(ids)), torch.from_numpy(nxt)))


def test_crnn_ctc_matches_jax():
    jpt.seed(2)
    kw = dict(num_classes=9, height=8, base=4, rnn_hidden=6)
    jmodel, pmodel = jm.CRNNCTC(**kw), pm.CRNNCTC(**kw, device="cpu")
    images = RNG.standard_normal((2, 1, 8, 24)).astype(np.float32)
    labels = np.array([[1, 1, 3, 0], [4, 2, 0, 0]])
    lens = np.array([3, 2])
    _pair(jmodel, pmodel,
          lambda m: m.loss(jnp.asarray(images), jnp.asarray(labels),
                           jnp.asarray(lens)),
          lambda m: m.loss(torch.from_numpy(images),
                           torch.from_numpy(labels), torch.from_numpy(lens)),
          buffers=True, scale_of={"conv1.bias": "conv1.weight",
                                  "conv2.bias": "conv2.weight"})
    # the decode, in eval (running statistics) on both
    jmodel.eval()
    pmodel.eval()
    jdec, jn = jmodel.decode(jnp.asarray(images))
    pdec, pn = pmodel.decode(torch.from_numpy(images))
    np.testing.assert_array_equal(pdec.numpy(), np.asarray(jdec))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))


def test_sentiment_bilstm_matches_jax():
    jpt.seed(3)
    kw = dict(vocab_size=30, embed_dim=8, hidden=6, num_layers=2)
    jmodel, pmodel = jm.SentimentBiLSTM(**kw), \
        pm.SentimentBiLSTM(**kw, device="cpu")
    tokens = RNG.integers(1, 30, (3, 6))
    tokens[1, 3:] = 0
    tokens[2, :] = 0  # an all-pad row pools to 0
    labels = np.array([0, 1, 1])
    _pair(jmodel, pmodel,
          lambda m: m.loss(jnp.asarray(tokens), jnp.asarray(labels)),
          lambda m: m.loss(torch.from_numpy(tokens),
                           torch.from_numpy(labels)))


def test_srl_bilstm_crf_matches_jax():
    jpt.seed(4)
    kw = dict(vocab_size=30, num_tags=5, embed_dim=8, hidden=6,
              num_layers=2)
    jmodel, pmodel = jm.SRLBiLSTMCRF(**kw), \
        pm.SRLBiLSTMCRF(**kw, device="cpu")
    words = RNG.integers(0, 30, (3, 6))
    mark = RNG.integers(0, 2, (3, 6))
    tags = RNG.integers(0, 5, (3, 6))
    length = np.array([6, 3, 1])
    # a non-zero transition, so the CRF's gradient reaches it everywhere
    jmodel.transition.value = jnp.asarray(
        RNG.standard_normal((7, 5)).astype(np.float32))
    args = (words, mark, tags, length)
    _pair(jmodel, pmodel,
          lambda m: m.loss(*(jnp.asarray(a) for a in args)),
          lambda m: m.loss(*(torch.from_numpy(a) for a in args)))
    jpath = jmodel.decode(jnp.asarray(words), jnp.asarray(mark),
                          jnp.asarray(length))
    ppath = pmodel.decode(torch.from_numpy(words), torch.from_numpy(mark),
                          torch.from_numpy(length))
    np.testing.assert_array_equal(ppath.numpy(), np.asarray(jpath))


def test_ngram_lm_matches_jax():
    jpt.seed(5)
    kw = dict(vocab_size=25, embed_dim=6, context=3, hidden=10)
    jmodel, pmodel = jm.NGramLM(**kw), pm.NGramLM(**kw, device="cpu")
    words = RNG.integers(0, 25, (4, 3))
    nxt = RNG.integers(0, 25, (4,))
    _pair(jmodel, pmodel,
          lambda m: m.loss(jnp.asarray(words), jnp.asarray(nxt)),
          lambda m: m.loss(torch.from_numpy(words), torch.from_numpy(nxt)))
    _close(pmodel(torch.from_numpy(words)), jmodel(jnp.asarray(words)),
           "logits")


def test_skipgram_nce_matches_jax():
    jpt.seed(6)
    jmodel = jm.SkipGramNCE(vocab_size=50, embed_dim=6, num_neg=4)
    pmodel = pm.SkipGramNCE(vocab_size=50, embed_dim=6, num_neg=4,
                            device="cpu")
    # a non-zero output table, so the input embedding's gradient is too
    jmodel.out_weight.value = jnp.asarray(
        RNG.standard_normal((50, 6)).astype(np.float32))
    center = RNG.integers(0, 50, (5,))
    context = RNG.integers(0, 50, (5,))
    neg = RNG.integers(0, 50, (5, 4))

    def jloss(m):
        return jnp.mean(j_nce(m.in_embed(jnp.asarray(center)), m.out_weight,
                              jnp.asarray(context), 50, 4,
                              sampler="log_uniform",
                              custom_neg_samples=jnp.asarray(neg)))

    def ploss(m):
        return torch.mean(t_nce(m.in_embed(torch.from_numpy(center)),
                                m.out_weight, torch.from_numpy(context), 50,
                                4, sampler="log_uniform",
                                custom_neg_samples=torch.from_numpy(neg)))

    _pair(jmodel, pmodel, jloss, ploss)
    sim = pmodel.similarity(torch.from_numpy(center),
                            torch.from_numpy(context))
    _close(sim, jmodel.similarity(jnp.asarray(center),
                                  jnp.asarray(context)), "similarity")
