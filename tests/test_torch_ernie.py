"""PyTorch port: ERNIE 1.0 (``models.ernie``) against the JAX package.

``knowledge_mask`` gives the JAX function's output, output for output,
for one ``np.random.Generator`` seed; ``ErnieForPretraining`` at 2
layers x H 64 with ERNIE's ``relu`` gives the JAX model's loss within
``LOSS_TOL`` and every gradient within ``GRAD_TOL`` of the gradient's
largest magnitude (fp32, the JAX weights moved in with
``convert.load_jax_params``)."""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as pt  # noqa: E402
from paddle_tpu.models import ernie as J  # noqa: E402
from paddle_tpu.nn.layer import functional_call  # noqa: E402

from paddle_tpu_torch import models  # noqa: E402
from paddle_tpu_torch.convert import load_jax_params  # noqa: E402
from paddle_tpu_torch.models import ernie as E  # noqa: E402

SMALL = dict(vocab_size=300, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=128,
             hidden_act="relu", hidden_dropout_prob=0.0,
             attention_probs_dropout_prob=0.0, max_position_embeddings=65)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
B, T = 3, 24


def _spans(rng, b, t):
    out = []
    for _ in range(b):
        row, s = [], 0
        while s < t:
            e = min(t, s + int(rng.integers(1, 5)))
            row.append((s, e))
            s = e
        out.append(row)
    return out


@pytest.mark.parametrize("seed", [0, 5])
def test_knowledge_mask_output_for_output(seed):
    ids = np.random.default_rng(100 + seed).integers(1, 300, (B, T))
    spans = _spans(np.random.default_rng(seed), B, T)
    spans[1] = []  # a row without units stays unmasked
    kw = dict(mask_id=3, vocab_size=300, mask_prob=0.4)
    want = J.knowledge_mask(ids, spans, rng=np.random.default_rng(seed),
                            **kw)
    got = E.knowledge_mask(ids, spans, rng=np.random.default_rng(seed),
                           **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    masked = got[1] != -100
    assert masked.any() and not masked[1].any()
    # a unit is masked whole
    for s, e in spans[0]:
        assert masked[0, s:e].all() or not masked[0, s:e].any()


def test_names_are_berts():
    assert E.ErnieConfig is models.BertConfig
    assert E.ErnieForPretraining is models.BertForPretraining
    assert E.ErnieModel is models.BertModel
    assert models.knowledge_mask is E.knowledge_mask


def test_pretraining_loss_and_grads_match_jax():
    pt.seed(0)
    jm = J.ErnieForPretraining(J.ErnieConfig(**SMALL))
    pm = E.ErnieForPretraining(E.ErnieConfig(**SMALL), device="cpu")
    load_jax_params(pm, {k: np.asarray(v)
                         for k, v in jm.param_dict().items()})
    rng = np.random.default_rng(1)
    ids = rng.integers(4, 300, (B, T))
    masked, mlm = E.knowledge_mask(ids, _spans(rng, B, T), mask_id=3,
                                   vocab_size=300, mask_prob=0.3, rng=rng)
    nsp = rng.integers(0, 2, (B,))

    def jax_loss(params):
        out = functional_call(jm, params, jm.buffer_dict(),
                              jnp.asarray(masked))
        return J.pretraining_loss(out, jnp.asarray(mlm), jnp.asarray(nsp))

    jl, jgrads = jax.value_and_grad(jax_loss)(jm.param_dict())
    out = pm(torch.from_numpy(masked))
    loss = E.pretraining_loss(out, torch.from_numpy(mlm),
                              torch.from_numpy(nsp))
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= LOSS_TOL
    params = dict(pm.named_parameters())
    assert set(params) == set(jgrads)
    for name, g in jgrads.items():
        g = np.asarray(g)
        # a parameter the loss does not reach (the token type embedding)
        # has no gradient here and a zero one in JAX
        got = params[name].grad
        got = np.zeros_like(g) if got is None else got.numpy()
        err = np.max(np.abs(got - g))
        assert err <= GRAD_TOL * max(np.max(np.abs(g)), 1e-3), (name, err)
