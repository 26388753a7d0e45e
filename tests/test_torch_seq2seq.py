"""PyTorch port: the seq2seq Transformer and beam search against the JAX
package on the CPU.

A small ``TransformerSeq2Seq`` (2 + 2 layers, d 32, dropout 0) is built in
the JAX package and its ``param_dict()`` moved into the port by name;
both run fp32 on the same numpy batch: the teacher-forced logits, the
``cross_entropy`` loss and every gradient (plain attention, and the plain
version of the flash kernels with the training gate lowered), 5
``TrainStep`` steps under Adam against the JAX step, then
``beam_search_step`` (ties included), ``gather_tree``,
``beam_search_decode`` and ``decode_beam``.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as pt  # noqa: E402
from paddle_tpu.models import Seq2SeqConfig as JaxConfig  # noqa: E402
from paddle_tpu.models import TransformerSeq2Seq as JaxSeq2Seq  # noqa: E402
from paddle_tpu.nn.layer import functional_call as jax_call  # noqa: E402
from paddle_tpu.ops import beam as jbeam  # noqa: E402
from paddle_tpu.ops import loss as jax_L  # noqa: E402
from paddle_tpu.optimizer import Adam as JaxAdam  # noqa: E402
from paddle_tpu.static import TrainStep as JaxTrainStep  # noqa: E402

from paddle_tpu_torch import get_flags, set_flags  # noqa: E402
from paddle_tpu_torch.convert import load_jax_params  # noqa: E402
from paddle_tpu_torch.models import (Seq2SeqConfig,  # noqa: E402
                                     TransformerSeq2Seq)
from paddle_tpu_torch.ops import beam  # noqa: E402
from paddle_tpu_torch.ops import loss as L  # noqa: E402
from paddle_tpu_torch.optimizer import Adam  # noqa: E402
from paddle_tpu_torch.static import TrainStep  # noqa: E402

CFG = dict(src_vocab=97, tgt_vocab=89, d_model=32, nhead=4,
           num_encoder_layers=2, num_decoder_layers=2, dim_feedforward=64,
           dropout=0.0, max_len=16)
B, S, T = 3, 12, 10
# the tolerances of tests/test_torch_bert.py
LOGIT_TOL = 2e-5
LOSS_TOL = 2e-5
GRAD_TOL = 5e-5


@pytest.fixture
def pair():
    pt.seed(0)
    jm = JaxSeq2Seq(JaxConfig(**CFG))
    pm = TransformerSeq2Seq(Seq2SeqConfig(**CFG), device="cpu")
    load_jax_params(pm, {k: np.asarray(v)
                         for k, v in jm.param_dict().items()})
    return jm, pm


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(3, CFG["src_vocab"], (B, S)).astype(np.int32)
    tgt = rng.integers(3, CFG["tgt_vocab"], (B, T)).astype(np.int32)
    lab = rng.integers(3, CFG["tgt_vocab"], (B, T)).astype(np.int64)
    return src, tgt, lab


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def test_param_names_are_the_jax_names(pair):
    jm, pm = pair
    assert list(jm.param_dict()) == list(pm.param_dict())


@pytest.mark.parametrize("gate", [512, 4])
def test_forward_loss_and_grads_match_jax(pair, gate):
    jm, pm = pair
    src, tgt, lab = _batch()

    def jax_loss(params):
        logits = jax_call(jm, params, jm.buffer_dict(), jnp.asarray(src),
                          jnp.asarray(tgt))
        return jax_L.cross_entropy(logits, jnp.asarray(lab)), logits

    # one XLA program: the same function, compiled once, not op by op
    (jl, jlogits), jgrads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(jm.param_dict())
    old = get_flags("flash_attention_min_seq_train")
    set_flags({"flash_attention_min_seq_train": gate})
    try:
        logits = pm(_t(src), _t(tgt))
        loss = L.cross_entropy(logits, _t(lab))
        loss.backward()
    finally:
        set_flags(old)
    assert logits.shape == (B, T, CFG["tgt_vocab"])
    assert np.max(np.abs(logits.detach().numpy() - np.asarray(jlogits))) \
        <= LOGIT_TOL
    assert abs(float(loss.detach()) - float(jl)) <= LOSS_TOL
    params = dict(pm.named_parameters())
    for name, g in jgrads.items():
        err = np.max(np.abs(params[name].grad.numpy() - np.asarray(g)))
        assert err <= GRAD_TOL, (name, err)


def test_five_train_steps_match_jax_adam(pair):
    jm, pm = pair
    jstep = JaxTrainStep(jm, JaxAdam(learning_rate=1e-3),
                         lambda logits, y: jax_L.cross_entropy(logits, y))
    pstep = TrainStep(pm, Adam(learning_rate=1e-3),
                      lambda logits, y: L.cross_entropy(logits, y))
    jl, pl = [], []
    # one batch five times: the loss must fall
    src, tgt, lab = _batch(seed=1)
    for _ in range(5):
        jl.append(float(jstep(jnp.asarray(src), jnp.asarray(tgt),
                              labels=(jnp.asarray(lab),))["loss"]))
        pl.append(float(pstep(_t(src), _t(tgt), labels=(_t(lab),))["loss"]))
    assert np.max(np.abs(np.array(pl) - np.array(jl))) <= 1e-5, (pl, jl)
    assert pl[-1] < pl[0]
    jstep.sync_to_model()
    own = dict(pm.named_parameters())
    for name, v in jm.param_dict().items():
        if name.endswith("k_proj.bias"):
            # an exactly-zero gradient both sides see as fp32 noise, which
            # Adam turns into steps of up to lr (tests/test_torch_bert.py)
            continue
        assert np.max(np.abs(own[name].detach().numpy()
                             - np.asarray(v))) <= 1e-5, name


@pytest.mark.parametrize("seed", [0, 1])
def test_beam_search_step_matches_jax_ties_included(seed):
    rng = np.random.default_rng(seed)
    batch, k, vocab, end = 3, 4, 11, 2
    # rounded to a coarse grid: many exact ties across beams and tokens
    logp = np.round(rng.standard_normal((batch, k, vocab)), 1).astype(
        np.float32)
    scores = np.round(rng.standard_normal((batch, k)), 1).astype(np.float32)
    fin = rng.random((batch, k)) < 0.3
    want = jbeam.beam_search_step(jnp.asarray(logp), jnp.asarray(scores),
                                  jnp.asarray(fin), k, end)
    got = beam.beam_search_step(torch.from_numpy(logp),
                                torch.from_numpy(scores),
                                torch.from_numpy(fin), k, end)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_gather_tree_and_decode_match_jax():
    rng = np.random.default_rng(3)
    steps, batch, k = 7, 2, 3
    ids = rng.integers(0, 6, (steps, batch, k)).astype(np.int32)
    parents = rng.integers(0, k, (steps, batch, k)).astype(np.int32)
    np.testing.assert_array_equal(
        beam.gather_tree(torch.from_numpy(ids),
                         torch.from_numpy(parents)).numpy(),
        np.asarray(jbeam.gather_tree(jnp.asarray(ids),
                                     jnp.asarray(parents))))
    np.testing.assert_array_equal(
        beam.beam_search_decode(torch.from_numpy(ids),
                                torch.from_numpy(parents), 2).numpy(),
        np.asarray(jbeam.beam_search_decode(jnp.asarray(ids),
                                            jnp.asarray(parents), 2)))


@pytest.mark.parametrize("penalty", [0.0, 0.6])
def test_decode_beam_matches_jax(pair, penalty):
    jm, pm = pair
    # logits spread wide enough that the k-th and (k+1)-th candidates of
    # every step differ by far more than the two engines' fp32 noise (a
    # random model's near-uniform softmax would leave near ties)
    w = np.asarray(jm.param_dict()["out_proj.weight"]) * 8.0
    jm.set_state_dict({"out_proj.weight": jnp.asarray(w)})
    pm.set_state_dict({"out_proj.weight": w})
    src = _batch(seed=5)[0]
    jseq, jscore = jm.decode_beam(jnp.asarray(src), beam_size=4,
                                  max_len=12, length_penalty=penalty)
    pm.eval()
    seq, score = pm.decode_beam(_t(src), beam_size=4, max_len=12,
                                length_penalty=penalty)
    assert seq.shape == (B, 4, 12) and seq.dtype == torch.int32
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    assert np.max(np.abs(score.numpy() - np.asarray(jscore))) <= 1e-4
