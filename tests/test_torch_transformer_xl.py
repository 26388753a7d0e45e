"""PyTorch port: ``models.transformer_xl`` against the JAX package on the
CPU at tiny widths, dropout 0.

``_rel_shift`` equal to the JAX shift; ``RelMultiHeadAttention`` with
``mem_valid`` 0, partial and full, and ``TransformerXL`` over three
segments (each reading the memories of the one before): outputs, the
memories, ``valid`` and every parameter's gradient within ``TOL`` of the
reference's largest entry (fp32, sums in another order).
``TransformerXLTrainStep`` over 4 segments of one stream against the JAX
step's losses and parameters (under Adam the relative projection's
softmax-invariant rows within ``R_STEP_SHARE`` of a step), and the port's versions of the JAX
``test_transformer_xl_*`` properties (``tests/test_model_zoo_extra.py``).
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import paddle_tpu as jpt  # noqa: E402
from paddle_tpu.models import transformer_xl as jtxl  # noqa: E402

from paddle_tpu_torch.convert import load_jax_params  # noqa: E402
from paddle_tpu_torch.models import transformer_xl as ptxl  # noqa: E402
from paddle_tpu_torch.optimizer import SGD, Adam  # noqa: E402

TOL = 2e-5
CFG = dict(vocab_size=40, d_model=32, n_heads=2, d_ff=64, n_layers=2,
           mem_len=8, dropout=0.0)


def _close(got, want, what="", tol=TOL):
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = max(float(np.max(np.abs(w), initial=0.0)), 1e-30)
    err = float(np.max(np.abs(g - w), initial=0.0)) / scale
    assert err <= tol, (what, err)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _pair(cfg=CFG, seed=0):
    jpt.seed(seed)
    jm = jtxl.TransformerXL(jtxl.TransformerXLConfig(**cfg))
    pm = ptxl.TransformerXL(ptxl.TransformerXLConfig(**cfg), device="cpu")
    load_jax_params(pm, _np(jm.param_dict()))
    return jm, pm


def test_rel_shift_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 5, 9)).astype(
        np.float32)
    got = ptxl._rel_shift(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jtxl._rel_shift(
                                      jnp.asarray(x))))


@pytest.mark.parametrize("valid", [0, 3, 6])
def test_rel_attention_matches_jax(valid):
    """Memory of 6 slots of which ``valid`` are real, 5 new positions."""
    jpt.seed(1)
    ja = jtxl.RelMultiHeadAttention(16, 2, 0.0)
    pa = ptxl.RelMultiHeadAttention(16, 2, 0.0, device="cpu")
    rng = np.random.default_rng(valid)
    params = {k: np.asarray(v) for k, v in ja.param_dict().items()}
    # nonzero u / v, so both biases reach the output
    params["u"] = rng.standard_normal(params["u"].shape).astype(np.float32)
    params["v"] = rng.standard_normal(params["v"].shape).astype(np.float32)
    load_jax_params(pa, params)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    mem = rng.standard_normal((2, 6, 16)).astype(np.float32)
    ctx = np.concatenate([mem, x], axis=1)
    rel = rng.standard_normal((11, 16)).astype(np.float32)
    w = rng.standard_normal((2, 5, 16)).astype(np.float32)

    @jax.jit
    def f(p, x, ctx):
        with ja.bind(p):
            o = ja(x, ctx, jnp.asarray(valid, jnp.int32), jnp.asarray(rel))
        return jnp.sum(o * w), o

    (_, jo), (jg, jgx, jgc) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jnp.asarray(ctx))
    tx = torch.from_numpy(x).requires_grad_()
    tc = torch.from_numpy(ctx).requires_grad_()
    po = pa(tx, tc, torch.tensor(valid, dtype=torch.int32),
            torch.from_numpy(rel))
    (po * torch.from_numpy(w)).sum().backward()
    _close(po, jo, "out")
    _close(tx.grad, jgx, "dx")
    _close(tc.grad, jgc, "dctx")
    for n, p in pa.named_parameters():
        _close(p.grad, jg[n], f"d {n}")
    # the empty slots get no gradient: nothing reads them
    assert not tc.grad[:, :6 - valid].any()


def test_transformer_xl_three_segments_match_jax():
    """Logits, memories and valid after each of three segments, and the
    gradients of a loss over all three (the memories detached)."""
    jm, pm = _pair()
    rng = np.random.default_rng(2)
    segs = [rng.integers(0, 40, (2, 5)) for _ in range(3)]
    tgts = [rng.integers(0, 40, (2, 5)) for _ in range(3)]

    @jax.jit
    def f(p):
        with jm.bind(p):
            mems, total, outs = None, 0.0, []
            for ids, tgt in zip(segs, tgts):
                loss, mems2 = jm.loss(jnp.asarray(ids), jnp.asarray(tgt),
                                      mems)
                logits, _ = jm(jnp.asarray(ids), mems)
                outs.append((logits, mems2))
                mems = mems2
                total = total + loss
        return total, outs

    (jl, jouts), jg = jax.value_and_grad(f, has_aux=True)(jm.param_dict())
    mems, total = None, 0.0
    for (ids, tgt), (jlog, jmem) in zip(zip(segs, tgts), jouts):
        ids_t = torch.from_numpy(ids)
        logits, _ = pm(ids_t, mems)
        loss, mems = pm.loss(ids_t, torch.from_numpy(tgt), mems)
        total = total + loss
        _close(logits, jlog, "logits")
        assert int(mems["valid"]) == int(jmem["valid"])
        for a, b in zip(mems["layers"], jmem["layers"]):
            _close(a, b, "memory")
    assert [int(j[1]["valid"]) for j in jouts] == [5, 8, 8]
    total.backward()
    _close(total, jl, "loss")
    for n, p in pm.named_parameters():
        _close(p.grad, jg[n], f"d {n}")


def _stream(rng, b, t, segments, vocab):
    base = rng.integers(0, vocab, (b, 1))
    return (base + np.arange(t * segments + 1)) % vocab


# Adam's step on ``attn.r.weight``: the rows that the relative sinusoid's
# slowest cosines feed (nearly constant over 14 distances) add a nearly
# constant logit to a query's row, which the softmax ignores; their
# gradient is fp32 noise on either side, and Adam turns noise into
# steps. They are held within a tenth of one step per segment; every
# other parameter within TOL of its largest entry or a two-hundredth of
# one step (a near-zero gradient entry's noise moves Adam's update by a
# few thousandths of a step, as in ``test_torch_parallel.py``). SGD holds
# every parameter within TOL.
R_STEP_SHARE = 0.1
ADAM_STEP_SHARE = 1 / 200


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_train_step_matches_jax_over_four_segments(opt):
    jm, pm = _pair()
    lr = 2e-3 if opt == "adam" else 0.5
    jopt = jpt.optimizer.Adam(learning_rate=lr) if opt == "adam" else \
        jpt.optimizer.SGD(learning_rate=lr)
    popt = Adam(learning_rate=lr) if opt == "adam" else SGD(learning_rate=lr)
    jstep = jtxl.TransformerXLTrainStep(jm, jopt, batch_size=3)
    pstep = ptxl.TransformerXLTrainStep(pm, popt, batch_size=3)
    rng = np.random.default_rng(3)
    t = 6
    stream = _stream(rng, 3, t, 4, 40)
    for s in range(4):
        ids = stream[:, s * t:(s + 1) * t]
        tgt = stream[:, s * t + 1:(s + 1) * t + 1]
        jl = float(jstep(jnp.asarray(ids, jnp.int32),
                         jnp.asarray(tgt))["loss"])
        pl = float(pstep(torch.from_numpy(ids), torch.from_numpy(tgt))[
            "loss"])
        _close(np.asarray(pl), np.asarray(jl), f"loss {s}")
        assert int(pstep.mems["valid"]) == int(jstep.state["mems"]["valid"])
    for n, p in pm.named_parameters():
        if opt == "adam" and n.endswith("attn.r.weight"):
            gap = np.abs(p.detach().numpy()
                         - np.asarray(jstep.state["params"][n])).max()
            assert gap <= R_STEP_SHARE * lr * 4, (n, gap)
            continue
        want = np.asarray(jstep.state["params"][n])
        if opt == "adam":
            np.testing.assert_allclose(
                p.detach().numpy(), want, rtol=0, err_msg=n,
                atol=max(TOL * np.abs(want).max(), ADAM_STEP_SHARE * lr))
            continue
        _close(p, want, n)
    for a, b in zip(pstep.mems["layers"], jstep.state["mems"]["layers"]):
        _close(a, b, "memory")


def test_reset_mems_empties_in_place():
    """After ``reset_mems`` a step equals a fresh step's first (same
    weights, same segment), and the buffers kept their addresses."""
    _, pm = _pair()
    pstep = ptxl.TransformerXLTrainStep(pm, Adam(learning_rate=0.0),
                                        batch_size=2)
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 40, (2, 5)))
    first = float(pstep(ids, ids)["loss"])
    pstep(ids, ids)
    ptrs = [m.data_ptr() for m in pstep.mems["layers"]]
    pstep.reset_mems(2)
    assert [m.data_ptr() for m in pstep.mems["layers"]] == ptrs
    assert int(pstep.mems["valid"]) == 0
    assert float(pstep(ids, ids)["loss"]) == first


# -- the JAX package's properties (tests/test_model_zoo_extra.py) -------------

def test_memory_recurrence_and_causality():
    """Segment 2's predictions depend on segment 1's content through the
    memories; a token's logits do not depend on later tokens."""
    _, pm = _pair()
    pm.eval()
    rng = np.random.default_rng(0)
    seg1a, seg1b, seg2 = (torch.from_numpy(rng.integers(0, 40, (2, 8)))
                          for _ in range(3))
    with torch.no_grad():
        _, mems_a = pm(seg1a)
        _, mems_b = pm(seg1b)
        out_a, _ = pm(seg2, mems_a)
        out_b, _ = pm(seg2, mems_b)
        assert not torch.allclose(out_a, out_b)
        mut = seg2.clone()
        mut[:, -1] = (mut[:, -1] + 1) % 40
        out_mut, _ = pm(mut, mems_a)
    np.testing.assert_allclose(out_a[:, :-1].numpy(),
                               out_mut[:, :-1].numpy(), atol=1e-5)


def test_trains_with_carried_memory():
    cfg = dict(CFG, vocab_size=30)
    pm = ptxl.TransformerXL(ptxl.TransformerXLConfig(**cfg), device="cpu")
    step = ptxl.TransformerXLTrainStep(pm, Adam(learning_rate=2e-3),
                                       batch_size=4)
    stream = _stream(np.random.default_rng(0), 4, 8, 6, 30)
    losses = []
    for s in range(6):
        ids = torch.from_numpy(stream[:, s * 8:(s + 1) * 8])
        tgt = torch.from_numpy(stream[:, s * 8 + 1:(s + 1) * 8 + 1])
        losses.append(float(step(ids, tgt)["loss"]))
    assert losses[-1] < losses[0], losses


def test_empty_memory_is_inert():
    """valid = 0: garbage in the zero-padded slots changes nothing."""
    cfg = dict(CFG, vocab_size=20, d_model=16, d_ff=32, n_layers=1,
               mem_len=4)
    _, pm = _pair(cfg)
    pm.eval()
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 20, (2, 5)))
    fresh = pm.init_mems(2)
    garbage = {"layers": [torch.full_like(m, 13.7)
                          for m in fresh["layers"]],
               "valid": fresh["valid"]}
    with torch.no_grad():
        out_a, _ = pm(ids, fresh)
        out_b, _ = pm(ids, garbage)
    np.testing.assert_allclose(out_a.numpy(), out_b.numpy(), atol=1e-6)
