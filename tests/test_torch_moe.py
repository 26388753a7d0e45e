"""PyTorch port: ``nn.MoELayer``, ``moe_param_rule`` and expert
parallelism in ``ShardedTrainStep``, against the JAX package on the CPU.

``MoELayer`` at top-1 and top-2, at a capacity that drops choices and
with tied gate probabilities: the output, ``aux_loss`` and every
parameter's gradient within ``TOL`` of the reference's largest entry
(the port dispatches by index where the JAX layer multiplies one-hot
einsums: the same sums in another order). ``TrainStep`` over
``tests/test_moe.py``'s ``MoENet``, 5 Adam steps, within ``TOL``.

The expert-parallel cases run in four Gloo processes (``paddle_tpu_torch.
testing.dist_worker``, job ``moe``, one job for the module; the cases are
``dist_worker.MOE_CASES``) against the JAX ``ShardedTrainStep`` with
``moe_param_rule("ep")`` on four of the conftest's eight CPU devices, at
dp 1 x ep 4 and dp 2 x ep 2, under Adam and under SGD (whose update
shows a gradient's scale: a gate gradient summed ``ep`` times fails
them), and under SGD with the load-balance term in the loss (the layer's
``aux``, against the JAX layer's traced ``aux_loss``): losses,
``aux_loss`` and every whole parameter within ``TOL``;
which choices are kept equal to the JAX layer's routing; each rank
holding ``E / ep`` experts.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402
from test_moe import MoENet as JaxMoENet  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu.nn import MoELayer as JaxMoE  # noqa: E402
from paddle_tpu.nn import moe_param_rule as jax_moe_rule  # noqa: E402
from paddle_tpu.ops import loss as JL  # noqa: E402
from paddle_tpu.parallel import ShardedTrainStep as JaxSharded  # noqa: E402
from paddle_tpu.parallel import create_mesh as jax_mesh  # noqa: E402
from paddle_tpu.static import TrainStep as JaxTrainStep  # noqa: E402

from paddle_tpu_torch.convert import load_jax_params  # noqa: E402
from paddle_tpu_torch.nn import MoELayer, moe_param_rule  # noqa: E402
from paddle_tpu_torch.ops import loss as L  # noqa: E402
from paddle_tpu_torch.optimizer import Adam  # noqa: E402
from paddle_tpu_torch.static import TrainStep  # noqa: E402
from paddle_tpu_torch.testing import dist_worker as W  # noqa: E402

TOL = 2e-5
WORLD = 4


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


def _load(pmodel, jmodel):
    load_jax_params(pmodel, _np(jmodel.param_dict()),
                    _np(jmodel.buffer_dict()))


@pytest.mark.parametrize("top_k,cf,tied", [(1, 4.0, False),
                                           (2, 1.25, False),
                                           (2, 0.5, False),
                                           (2, 1.0, True)])
def test_moe_layer_matches_jax(top_k, cf, tied):
    """Output, gradients and aux_loss; cf 0.5 drops choices, ``tied``
    makes every gate probability equal (a zero gate weight): the choices
    go to the lowest expert indices, as ``jax.lax.top_k`` gives them."""
    jpt.seed(3)
    jm = JaxMoE(8, 16, num_experts=4, top_k=top_k, capacity_factor=cf)
    pm = MoELayer(8, 16, num_experts=4, top_k=top_k, capacity_factor=cf,
                  device="cpu")
    params = jm.param_dict()
    if tied:
        params = dict(params, gate_weight=jnp.zeros_like(
            params["gate_weight"]))
    load_jax_params(pm, _np(params), _np(jm.buffer_dict()))
    x = np.random.default_rng(top_k).normal(0, 1, (3, 5, 8)).astype(
        np.float32)
    w = np.random.default_rng(7).normal(0, 1, (3, 5, 8)).astype(np.float32)

    @jax.jit
    def f(p, x):
        with jm.bind(p, jm.buffer_dict()) as cap:
            y = jm(x)
        return jnp.sum(y * w), (y, cap.buffers["aux_loss"])

    (_, (jy, jaux)), jg = jax.value_and_grad(f, has_aux=True)(
        params, jnp.asarray(x))
    py = pm(torch.from_numpy(x))
    (py * torch.from_numpy(w)).sum().backward()
    _close(py, jy, "y")
    _close(pm.aux_loss, jaux, "aux_loss")
    for n, p in pm.named_parameters():
        if tied and n == "gate_weight":
            # softmax of equal logits: the gate's gradient is the sum of
            # cancelling terms, noise on both sides
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[n]),
                                       atol=1e-6)
            continue
        _close(p.grad, jg[n], f"d {n}")
    n_tok, cap = 15, pm.capacity(15)
    assert cap == max(1, int(np.ceil(cf * n_tok * top_k / 4)))
    if cf < 1:
        keep = pm.route(torch.from_numpy(x).reshape(n_tok, 8)).keep
        assert bool((~keep).any())


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_aux_gradient_matches_jax(top_k):
    """``aux`` carries the load-balance term's gradient: d aux / d
    (gate weight, x) against ``jax.grad`` of the JAX layer's traced
    ``aux_loss``; the experts' weights take none."""
    jpt.seed(5)
    jm = JaxMoE(8, 16, num_experts=4, top_k=top_k, capacity_factor=1.25)
    pm = MoELayer(8, 16, num_experts=4, top_k=top_k, capacity_factor=1.25,
                  device="cpu")
    _load(pm, jm)
    x = np.random.default_rng(11).normal(0, 1, (3, 5, 8)).astype(
        np.float32)

    @jax.jit
    def f(p, x):
        with jm.bind(p, jm.buffer_dict()) as cap:
            jm(x)
        return cap.buffers["aux_loss"]

    jaux, (jg, jgx) = jax.value_and_grad(f, argnums=(0, 1))(
        jm.param_dict(), jnp.asarray(x))
    px = torch.from_numpy(x).requires_grad_()
    pm(px)
    pm.aux.backward()
    _close(pm.aux, jaux, "aux")
    _close(pm.aux_loss, jaux, "aux_loss")
    _close(pm.gate_weight.grad, jg["gate_weight"], "d gate_weight")
    _close(px.grad, jgx, "d x")
    assert float(np.abs(np.asarray(jg["gate_weight"])).max()) > 0
    for n in ("w_in", "b_in", "w_out", "b_out"):
        assert getattr(pm, n).grad is None, n
        assert float(np.abs(np.asarray(jg[n])).max()) == 0.0, n


def test_moe_routing_ties_go_to_the_lower_expert():
    pm = MoELayer(4, 8, num_experts=4, top_k=2, capacity_factor=8.0,
                  device="cpu")
    with torch.no_grad():
        pm.gate_weight.zero_()
    r = pm.route(torch.ones(5, 4))
    np.testing.assert_array_equal(r.expert.numpy(), [[0, 1]] * 5)
    np.testing.assert_array_equal(r.position.numpy(),
                                  np.stack([np.arange(5)] * 2, 1))


def _data(n=16):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (n, 6, 8)).astype(np.float32)
    y = rng.integers(0, 4, (n,)).astype(np.int64)
    return x, y


class JaxMoEAuxNet(JaxMoENet):
    """MoENet returning the layer's traced ``aux_loss`` beside the
    logits, as the JAX layer's note says to train with it."""

    def forward(self, x):
        return super().forward(x), self.moe.aux_loss


def _jax_loss(aux):
    if aux:
        return lambda o, t: JL.cross_entropy(o[0], t) + W.MOE_AUX_W * o[1]
    return lambda o, t: JL.cross_entropy(o, t)


@pytest.mark.parametrize("aux", [False, True])
def test_moe_train_step_matches_jax(aux):
    """``TrainStep`` over MoENet, 5 Adam steps: losses, parameters and the
    aux_loss buffer against the JAX ``TrainStep``; with ``aux`` the loss
    adds the load-balance term the net returns."""
    x, y = _data()
    jpt.seed(0)
    jnet = JaxMoEAuxNet() if aux else JaxMoENet()
    pnet = W.moe_net("cpu", aux=aux)
    _load(pnet, jnet)
    jstep = JaxTrainStep(jnet, jpt.optimizer.Adam(3e-3), _jax_loss(aux))
    pstep = TrainStep(pnet, Adam(3e-3), W.moe_loss(aux))
    for i in range(5):
        jl = float(jstep(x, labels=y)["loss"])
        pl = float(pstep(torch.from_numpy(x), labels=torch.from_numpy(y))[
            "loss"])
        _close(np.asarray(pl), np.asarray(jl), f"loss {i}")
    for n, p in pnet.named_parameters():
        _close(p, jstep.state["params"][n], n)
    _close(pnet.moe.aux_loss, jstep.state["buffers"]["moe.aux_loss"], "aux")


def test_moe_param_rule_matches_jax():
    jr, pr = jax_moe_rule("ep"), moe_param_rule("ep")

    class V:
        def __init__(self, shape):
            self.shape = shape

    for name, shape in (("moe.w_in", (4, 8, 16)), ("moe.b_in", (4, 16)),
                        ("moe.gate_weight", (8, 4)), ("emb_in.weight",
                                                      (16, 8)),
                        ("moe.w_out", (4,)), ("moe.b_out", (4, 8))):
        assert tuple(pr(name, V(shape))) == tuple(jr(name, V(shape))), name


# -- expert parallelism --------------------------------------------------------

def _inputs():
    x, y = _data(W.MOE_ROWS)
    inputs = {"moe_x": x, "moe_y": y}
    jpt.seed(0)
    jnet = JaxMoENet()
    for d in (jnet.param_dict(), jnet.buffer_dict()):
        for k, v in d.items():
            inputs[f"moe/{k}"] = np.asarray(v)
    return inputs


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    inputs = _inputs()
    outs = W.run_job("moe", tmp_path_factory.mktemp("moe"), WORLD, inputs,
                     timeout_s=300)
    return inputs, outs


def _jax_net(inputs, cf, aux=False):
    jpt.seed(0)
    jnet = JaxMoEAuxNet() if aux else JaxMoENet()
    jnet.moe.capacity_factor = cf
    return jnet


def _jax_routing(inputs, cf):
    """The JAX layer's choices on the global batch at the initial
    weights: its gate, ``jax.lax.top_k`` and the k-major slot count of
    ``paddle_tpu/nn/layers/moe.py``."""
    jnet = _jax_net(inputs, cf)
    h = np.asarray(jnet.embed(jnp.asarray(inputs["moe_x"]))).reshape(-1, 16)
    probs = jax.nn.softmax(jnp.asarray(h) @ jnet.moe.gate_weight, axis=-1)
    _, top_e = jax.lax.top_k(probs, 2)
    top_e = np.asarray(top_e)
    n = len(top_e)
    cap = int(np.ceil(cf * n * 2 / 4))
    seen = np.zeros(4, np.int64)
    pos = np.zeros_like(top_e)
    for k in range(2):
        for i in range(n):
            pos[i, k] = seen[top_e[i, k]]
            seen[top_e[i, k]] += 1
    return top_e, pos < cap


def _by_dp(outs, key):
    """A per-row output of the ranks of expert index 0, in dp order."""
    rows = sorted((int(o[f"{key.split('/')[0]}/dp_index"]), o[key])
                  for o in outs if int(o[f"{key.split('/')[0]}/ep_index"])
                  == 0)
    return np.concatenate([v for _, v in rows])


@pytest.mark.parametrize("case", sorted(W.MOE_CASES))
def test_expert_parallel_matches_jax(job, case):
    inputs, outs = job
    spec = W.MOE_CASES[case]
    aux_on = bool(spec.get("aux"))
    jnet = _jax_net(inputs, spec["cf"], aux_on)
    mesh = jax_mesh(spec["axes"], allow_submesh=True)
    opt = jpt.optimizer.SGD(W.MOE_SGD_LR) if spec.get("sgd") else \
        jpt.optimizer.Adam(W.MOE_LR)
    jstep = JaxSharded(jnet, opt, _jax_loss(aux_on), mesh,
                       batch_spec=JP("dp"), param_rule=jax_moe_rule("ep"))
    assert tuple(jstep.state_specs["params"]["moe.w_in"]) == (
        "ep", None, None)
    losses, aux = [], []
    for _ in range(W.MOE_STEPS):
        losses.append(float(jstep(inputs["moe_x"],
                                  labels=inputs["moe_y"])["loss"]))
        aux.append(float(jstep.state["buffers"]["moe.aux_loss"]))
    params = _np(jstep.state["params"])
    top_e, keep = _jax_routing(inputs, spec["cf"])
    assert bool((~keep).any()) == case.endswith("_drop")
    for r, out in enumerate(outs):
        _close(out[f"{case}/loss"], losses, f"{case} loss r{r}")
        _close(out[f"{case}/aux"][:, 0], aux, f"{case} aux r{r}")
        for n, w in params.items():
            _close(out[f"{case}/param/{n}"], w, f"{case} {n} r{r}")
    np.testing.assert_array_equal(_by_dp(outs, f"{case}/expert"), top_e)
    np.testing.assert_array_equal(_by_dp(outs, f"{case}/keep"), keep)
    # each rank's dropped choices over its rows, summed over dp, are the
    # global batch's dropped choices
    first = sum(int(o[f"{case}/dropped"][0, 0]) for o in outs
                if int(o[f"{case}/ep_index"]) == 0)
    assert first == int((~keep).sum())


@pytest.mark.parametrize("case", ["ep4", "dp2_ep2"])
def test_a_rank_holds_its_experts(job, case):
    """The bytes: a rank holds E / ep experts of each stacked weight, the
    rest whole."""
    inputs, outs = job
    ep = W.MOE_CASES[case]["axes"]["ep"]
    for out in outs:
        held = {k.split("/held_shape/")[1]: tuple(int(v) for v in s)
                for k, s in out.items()
                if k.startswith(f"{case}/held_shape/")}
        for n, shape in held.items():
            want = inputs[f"moe/{n}"].shape
            if n.split(".")[-1] in ("w_in", "w_out", "b_in", "b_out"):
                want = (want[0] // ep,) + want[1:]
            assert shape == want, (n, shape, want)


def test_refused_combinations_name_the_parameter(job):
    _, outs = job
    for out in outs:
        for tag in W.MOE_ERRORS:
            msg = str(out[f"moe_error/{tag}"])
            assert "'moe.w_in'" in msg or "'moe.b_in'" in msg, (tag, msg)
            assert "expert" in msg, (tag, msg)
