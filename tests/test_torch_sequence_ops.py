"""PyTorch port: the recurrent and sequence stack's ops (``ops.sequence``,
``crf``, ``rnn_functional``, ``sampling``, ``sparse``, the CTC losses)
and the optimizers' row-sparse updates against the JAX package on the
CPU.

The cases are ``testing/op_cases.py``'s ``SEQ_CASES`` (one parametrised
test): outputs agree within ``RTOL``/``ATOL`` (fp32, sums in another
order) and integer/bool outputs exactly (values: the port gives int64
where JAX with x64 off gives int32). The CTC gradients agree within
``GRAD_TOL`` of the largest entry and are finite, the infeasible row's
included. The sampled ops cannot match threefry's bits: they are checked
by shape, dtype and the same draw from the same seed; NCE runs against
JAX on given negatives. ``SGD``'s and ``Adam``'s ``update_sparse`` agree
with the JAX optimizers' on unique rows within ``RTOL``, and lazy Adam
equals the port's dense update on the touched rows bit for bit and
leaves the other rows and moments exactly as they were.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from paddle_tpu import optimizer as jopt  # noqa: E402
from paddle_tpu.ops import crf as j_crf  # noqa: E402
from paddle_tpu.ops import loss as j_loss  # noqa: E402
from paddle_tpu.ops import rnn_functional as j_rf  # noqa: E402
from paddle_tpu.ops import sampling as j_samp  # noqa: E402
from paddle_tpu.ops import sequence as j_seq  # noqa: E402
from paddle_tpu.ops import sparse as j_sparse  # noqa: E402

from paddle_tpu_torch import nn as pnn  # noqa: E402
from paddle_tpu_torch import ops as pops  # noqa: E402
from paddle_tpu_torch import optimizer as popt  # noqa: E402
from paddle_tpu_torch.ops import crf as t_crf  # noqa: E402
from paddle_tpu_torch.ops import loss as t_loss  # noqa: E402
from paddle_tpu_torch.ops import rnn_functional as t_rf  # noqa: E402
from paddle_tpu_torch.ops import sampling as t_samp  # noqa: E402
from paddle_tpu_torch.ops import sequence as t_seq  # noqa: E402
from paddle_tpu_torch.ops import sparse as t_sparse  # noqa: E402
from paddle_tpu_torch.testing import op_cases as C  # noqa: E402

RTOL, ATOL = 2e-5, 1e-6
GRAD_TOL = 1e-5
MODS = {"sequence": (j_seq, t_seq), "crf": (j_crf, t_crf),
        "rnn_functional": (j_rf, t_rf), "sampling": (j_samp, t_samp),
        "sparse": (j_sparse, t_sparse), "loss": (j_loss, t_loss)}


def _j(v):
    if isinstance(v, np.ndarray):
        return jnp.asarray(v)
    if isinstance(v, list) and v and isinstance(v[0], np.ndarray):
        return [jnp.asarray(a) for a in v]
    if isinstance(v, list) and v and isinstance(v[0], dict):
        return [{k: jnp.asarray(a) for k, a in d.items()} for d in v]
    return v


def _t(v):
    if isinstance(v, np.ndarray):
        return torch.from_numpy(v.copy())
    if isinstance(v, list) and v and isinstance(v[0], np.ndarray):
        return [torch.from_numpy(a.copy()) for a in v]
    if isinstance(v, list) and v and isinstance(v[0], dict):
        return [{k: torch.from_numpy(a.copy()) for k, a in d.items()}
                for d in v]
    return v


def _flat(out):
    if isinstance(out, dict):
        return [a for k in sorted(out) for a in _flat(out[k])]
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
                                       equal_nan=True, err_msg=what)
        else:
            np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("mod,name,args,kw", C.SEQ_CASES,
                         ids=[f"{c[0]}.{c[1]}-{i}"
                              for i, c in enumerate(C.SEQ_CASES)])
def test_seq_op_matches_jax(mod, name, args, kw):
    jmod, tmod = MODS[mod]
    want = getattr(jmod, name)(*(_j(a) for a in args),
                               **{k: _j(v) for k, v in kw.items()})
    got = getattr(tmod, name)(*(_t(a) for a in args),
                              **{k: _t(v) for k, v in kw.items()})
    _agree(got, want, f"{mod}.{name}")


@pytest.mark.parametrize("run", C.sparse_runs(),
                         ids=lambda r: r.__name__)
def test_sparse_matches_jax(run):
    _agree(run(t_sparse, lambda a: torch.from_numpy(a.copy())),
           run(j_sparse, jnp.asarray), run.__name__)


def test_every_public_function_has_a_case():
    covered = {c[1] for c in C.SEQ_CASES} | C.SEQ_RANDOM \
        | {r.__name__ for r in C.sparse_runs()} | {"RowSlices"}
    assert set(C.SEQ_MODULES) <= set(MODS)
    for mod in C.SEQ_MODULES:
        missing = set(MODS[mod][1].__all__) - covered
        assert not missing, (mod, sorted(missing))
        # the port's module has every public function of the JAX one
        jnames = {n for n in dir(MODS[mod][0]) if not n.startswith("_")
                  and callable(getattr(MODS[mod][0], n))
                  and getattr(getattr(MODS[mod][0], n), "__module__",
                              "") == MODS[mod][0].__name__}
        assert jnames <= set(MODS[mod][1].__all__), (mod, jnames)
    for name in ("ctc_loss", "warpctc", "sequence_mask", "RowSlices",
                 "linear_chain_crf", "nce_loss", "dynamic_lstm",
                 "embedding_grad", "hash_bucket"):
        assert hasattr(pops, name), name


def _ctc_grad(fn, lp):
    """(loss, d log_probs) of ``fn`` on the JAX side and the port's."""
    jl, jg = jax.value_and_grad(lambda x: jnp.sum(fn(j_loss, x, jnp)))(
        jnp.asarray(lp))
    x = torch.from_numpy(lp.copy()).requires_grad_(True)
    tl = torch.sum(fn(t_loss, x, torch))
    tl.backward()
    return float(tl), x.grad.numpy(), float(jl), np.asarray(jg)


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_ctc_gradients_match_jax(reduction):
    def fn(m, x, lib):
        a = (lambda v: torch.from_numpy(v)) if lib is torch \
            else jnp.asarray
        out = m.ctc_loss(x, a(C.CTC_LAB), a(C.CTC_INLEN),
                         a(C.CTC_LABLEN), reduction=reduction)
        # the infeasible row (1e30) would swamp the sum: weigh it out
        return out * a(np.array([1.0, 1.0, 1.0, 0.0], np.float32)) \
            if reduction == "none" else out

    tl, tg, jl, jg = _ctc_grad(fn, C.CTC_LP)
    assert np.isfinite(tg).all() and np.isfinite(jg).all()
    scale = np.abs(jg).max()
    assert np.abs(tg - jg).max() <= GRAD_TOL * scale
    np.testing.assert_allclose(tl, jl, rtol=RTOL)


def test_ctc_layer_and_warpctc_against_torch():
    """``CTCLoss`` is ``ctc_loss``; on feasible non-empty labels the
    losses equal ``torch.nn.functional.ctc_loss``'s (a yardstick only); a
    label longer than its input gives ~1e30 (torch: inf); an empty label
    counts its one path twice, as the JAX package does (log 2 below
    torch's)."""
    lp = torch.from_numpy(C.CTC_LP)
    args = [torch.from_numpy(a) for a in (C.CTC_LAB, C.CTC_INLEN,
                                          C.CTC_LABLEN)]
    per = pnn.CTCLoss(reduction="none")(lp, *args)
    ref = torch.nn.functional.ctc_loss(lp, *args, reduction="none")
    torch.testing.assert_close(per[:2], ref[:2], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(per[2], ref[2] - np.log(2.0), rtol=1e-5,
                               atol=1e-5)
    assert per[3] > 1e29 and torch.isinf(ref[3])
    torch.testing.assert_close(pops.warpctc(lp, *args), per)
    mean = pnn.CTCLoss()(lp[:, :3], *(a[:3] for a in args))
    torch.testing.assert_close(
        mean, (per[:3] / args[2][:3].clamp(min=1)).mean())


def test_sampled_ops_by_shape_and_seed():
    x = torch.from_numpy(C.F2)
    w = torch.from_numpy(C.NCE_W)
    lab = torch.tensor([2, 7, 10])
    for sampler in ("uniform", "log_uniform"):
        a = pops.nce_loss(x, w, lab, 11, 5, sampler=sampler, key=3)
        b = pops.nce_loss(x, w, lab, 11, 5, sampler=sampler, key=3)
        jw = j_samp.nce_loss(jnp.asarray(C.F2), jnp.asarray(C.NCE_W),
                             jnp.asarray(lab.numpy()), 11, 5,
                             sampler=sampler)
        assert a.shape == jw.shape and a.dtype == torch.float32
        assert torch.equal(a, b) and torch.isfinite(a).all()
    s1 = pops.sampled_softmax_with_cross_entropy(x, w, lab, 11, 6, key=4)
    s2 = pops.sampled_softmax_with_cross_entropy(x, w, lab, 11, 6, key=4)
    s3 = pops.sampled_softmax_with_cross_entropy(x, w, lab, 11, 6, key=5)
    js = j_samp.sampled_softmax_with_cross_entropy(
        jnp.asarray(C.F2), jnp.asarray(C.NCE_W), jnp.asarray(lab.numpy()),
        11, 6)
    assert s1.shape == js.shape and torch.equal(s1, s2)
    assert torch.isfinite(s1).all() and not torch.equal(s1, s3)


ROWS_U = np.array([4, 0, 2], np.int64)
VALS = np.random.default_rng(5).normal(size=(3, 3)).astype(np.float32)
P0 = np.random.default_rng(6).normal(size=(6, 3)).astype(np.float32)


def _port_step(opt, p0, rows, vals, steps=2):
    p = torch.from_numpy(p0.copy())
    state = opt.init({"w": p})
    for _ in range(steps):
        opt.apply_gradients({"w": p}, {"w": t_sparse.RowSlices(
            torch.from_numpy(rows), torch.from_numpy(vals), 6)}, state)
    return p, state


def _jax_step(opt, p0, rows, vals, steps=2):
    p = jnp.asarray(p0)
    slots = opt.init_slots(p)
    for k in range(1, steps + 1):
        p, slots = opt.update_sparse(
            p, j_sparse.RowSlices(jnp.asarray(rows), jnp.asarray(vals), 6),
            slots, 0.1, jnp.asarray(k, jnp.int32))
    return p, slots


@pytest.mark.parametrize("name,kw", [("SGD", {}), ("Adam", {}),
                                     ("Adam", {"lazy_mode": True})])
def test_update_sparse_matches_jax(name, kw):
    p, state = _port_step(getattr(popt, name)(0.1, **kw), P0, ROWS_U, VALS)
    jp, jslots = _jax_step(getattr(jopt, name)(0.1, **kw), P0, ROWS_U,
                           VALS)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=RTOL,
                               atol=ATOL)
    for k, v in jslots.items():
        np.testing.assert_allclose(state["slots"]["w"][k].numpy(),
                                   np.asarray(v), rtol=RTOL, atol=ATOL)


W0 = np.random.default_rng(8).normal(size=(3, 2)).astype(np.float32)
GW = np.random.default_rng(9).normal(size=(3, 2)).astype(np.float32)


@pytest.mark.parametrize("name,kw,clip,arg", [
    ("SGD", {}, "ClipGradByGlobalNorm", 0.5),
    ("Adam", {"lazy_mode": True}, "ClipGradByGlobalNorm", 0.5),
    ("SGD", {}, "ClipGradByNorm", 0.5),
    ("SGD", {}, "ClipGradByValue", 0.3)])
def test_sparse_gradient_is_clipped_as_in_jax(name, kw, clip, arg):
    """A RowSlices gradient joins ``grad_clip`` beside a dense one: its
    values feed the global norm and are scaled or clamped, as in the JAX
    package (the clip binds, so a gradient left out would differ)."""
    import importlib
    j_clip = importlib.import_module("paddle_tpu.clip")
    t_clip = importlib.import_module("paddle_tpu_torch.clip")
    opt = getattr(popt, name)(0.1, grad_clip=getattr(t_clip, clip)(arg),
                              **kw)
    params = {"emb": torch.from_numpy(P0.copy()),
              "w": torch.from_numpy(W0.copy())}
    state = opt.init(params)
    jo = getattr(jopt, name)(0.1, grad_clip=getattr(j_clip, clip)(arg),
                             **kw)
    jparams = {"emb": jnp.asarray(P0), "w": jnp.asarray(W0)}
    jstate = jo.init(jparams)
    for _ in range(2):
        opt.apply_gradients(params, {
            "emb": t_sparse.RowSlices(torch.from_numpy(ROWS_U),
                                      torch.from_numpy(VALS), 6),
            "w": torch.from_numpy(GW)}, state)
        jparams, jstate = jo.apply_gradients(jparams, {
            "emb": j_sparse.RowSlices(jnp.asarray(ROWS_U),
                                      jnp.asarray(VALS), 6),
            "w": jnp.asarray(GW)}, jstate)
    for k in params:
        np.testing.assert_allclose(params[k].numpy(),
                                   np.asarray(jparams[k]), rtol=RTOL,
                                   atol=ATOL)
    unclipped = P0.copy()
    unclipped[ROWS_U] -= 0.2 * VALS
    if name == "SGD":
        assert not np.allclose(params["emb"].numpy(), unclipped)


def test_sparse_updates_touch_only_their_rows():
    """Duplicate rows merge first; SGD and lazy Adam equal the dense
    update of the merged gradient on the touched rows bit for bit and
    leave the others, moments included, exactly as they were."""
    rows = np.array([4, 0, 4, 2, 4], np.int64)
    vals = np.random.default_rng(7).normal(size=(5, 3)).astype(np.float32)
    dense_g = t_sparse.to_dense(t_sparse.merge_rows(t_sparse.RowSlices(
        torch.from_numpy(rows), torch.from_numpy(vals), 6)))
    touched = np.zeros(6, bool)
    touched[rows] = True
    for opt_s, opt_d in ((popt.SGD(0.1), popt.SGD(0.1)),
                         (popt.Adam(0.1, lazy_mode=True), popt.Adam(0.1))):
        p, state = _port_step(opt_s, P0, rows, vals, steps=1)
        q = torch.from_numpy(P0.copy())
        dstate = opt_d.init({"w": q})
        opt_d.apply_gradients({"w": q}, {"w": dense_g}, dstate)
        assert torch.equal(p[touched], q[touched])
        assert torch.equal(p[~touched], torch.from_numpy(P0)[~touched])
        for k, v in state["slots"]["w"].items():
            assert torch.equal(v[touched], dstate["slots"]["w"][k][touched])
            assert not v[~touched].any()
    # the skip guard: ok False leaves everything as it was
    opt = popt.Adam(0.1, lazy_mode=True)
    p = torch.from_numpy(P0.copy())
    state = opt.init({"w": p})
    opt.apply_gradients({"w": p}, {"w": t_sparse.RowSlices(
        torch.from_numpy(rows), torch.from_numpy(vals), 6)}, state,
        ok=torch.tensor(False))
    assert torch.equal(p, torch.from_numpy(P0))
    assert not state["slots"]["w"]["m"].any()
