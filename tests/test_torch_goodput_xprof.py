"""PyTorch port: the goodput ledger and the program cards against the JAX
package.

The JAX suite's ledger tests run against the port with the clock faked
(no wall-time bound), the same ``measure``/``attribute`` sequence gives
both packages' ledgers equal snapshots, the straggler policy flags the
same hosts, a checkpoint's host-blocking time lands in ``checkpoint``,
and a captured step's seconds in ``jit_compile_cold``. A tiny BERT's
program card on the CPU counts the analytic matmul FLOPs of one training
step (forward plus backward) to 0.1%, with the JAX card's XLA count
printed beside it; the hand-written kernels' own counts reach the card
from a forward and a backward, with the formulas of ``chip_smoke.py``'s
bounds; analytics change no bit of the state.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as pt  # noqa: E402
from paddle_tpu import observability as jax_obs  # noqa: E402
from paddle_tpu.models import BertConfig as JaxBertConfig  # noqa: E402
from paddle_tpu.models import BertForPretraining as JaxBert  # noqa: E402
from paddle_tpu.models import pretraining_loss as jax_loss  # noqa: E402
from paddle_tpu.observability import goodput as jax_goodput  # noqa: E402
from paddle_tpu.observability import metrics as jax_metrics  # noqa: E402
from paddle_tpu.optimizer import AdamW as JaxAdamW  # noqa: E402
from paddle_tpu.static import TrainStep as JaxTrainStep  # noqa: E402

import chip_smoke  # noqa: E402
import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu_torch import io as pio  # noqa: E402
from paddle_tpu_torch import observability as obs  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.models import (BertConfig,  # noqa: E402
                                     BertForPretraining, pretraining_loss)
from paddle_tpu_torch.observability import goodput, xprof  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402
from paddle_tpu_torch.static import TrainStep  # noqa: E402

SMALL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=128,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             max_position_embeddings=64)
B, T, P = 2, 32, 6
# the card's count against the analytic one: both count the same
# products exactly, so the limit only absorbs a formula's rounding
FLOPS_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _isolated():
    jax_on = jax_metrics.enabled()
    # both registries start empty: a test file run earlier in this
    # process may have left instruments in either
    obs.reset_all()
    jax_obs.reset_all()
    try:
        yield
    finally:
        ptt.set_flags({"enable_metrics": False, "program_analytics": True})
        pt.set_flags({"enable_metrics": False, "metrics_port": 0,
                      "program_analytics": True})
        obs.reset_all()
        jax_obs.reset_all()
        jax_metrics.set_enabled(jax_on)


@pytest.fixture
def metrics_on():
    ptt.set_flags({"enable_metrics": True})
    yield


class FakeClock:
    """``time`` for a goodput module: ``perf_counter`` reads a settable
    stamp."""

    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def perf_counter(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture
def clocks(monkeypatch):
    c = {"port": FakeClock(), "jax": FakeClock()}
    monkeypatch.setattr(goodput, "time", c["port"])
    monkeypatch.setattr(jax_goodput, "time", c["jax"])
    return c


# -- the ledger (the JAX suite's cases, clock faked) --------------------------

def test_goodput_ledger_exclusive_buckets(metrics_on, clocks):
    clk = clocks["port"]
    led = goodput.GoodputLedger()
    led.start()
    led.attribute("data_wait", 0.05)
    with led.measure("eval"):
        clk.advance(0.02)
        with led.measure("checkpoint"):  # nested: self-time only
            clk.advance(0.03)
    led.attribute("step_compute", 0.1)
    clk.advance(0.2)
    led.stop()
    snap = led.snapshot()
    assert snap["buckets"]["eval"] == pytest.approx(0.02)
    assert snap["buckets"]["checkpoint"] == pytest.approx(0.03)
    assert snap["wall_seconds"] == pytest.approx(0.25)
    assert sum(snap["buckets"].values()) == \
        pytest.approx(snap["wall_seconds"], rel=1e-9)
    assert sum(snap["ratios"].values()) == pytest.approx(1.0, abs=1e-9)
    assert snap["goodput_ratio"] == pytest.approx(0.1 / 0.25)
    led.start()
    led.attribute("step_compute", 0.05)
    clk.advance(0.05)
    led.stop()
    snap2 = led.snapshot()
    assert snap2["buckets"]["step_compute"] == pytest.approx(0.15)
    assert sum(snap2["buckets"].values()) == \
        pytest.approx(snap2["wall_seconds"], rel=1e-9)


def test_goodput_ledger_publishes_registry_series(metrics_on):
    led = goodput.GoodputLedger()
    led.start()
    led.attribute("step_compute", 0.2)
    led.attribute("jit_compile_cold", 0.1)
    led.stop()
    led.publish()
    assert obs.counter("goodput_seconds_total").value() == \
        pytest.approx(0.2)
    bad = obs.counter("badput_seconds_total")
    assert bad.value(bucket="jit_compile_cold") == pytest.approx(0.1)
    assert bad.value(bucket="jit_compile_cache_hit") == 0.0
    assert 0 < obs.gauge("goodput_ratio").value() < 1
    assert obs.counter("compile_cache_hits_total").value() == 0.0


def test_goodput_ledger_seeds_restart_idle(metrics_on, monkeypatch):
    monkeypatch.setenv("PT_RESTART_IDLE_S", "2.5")
    monkeypatch.setenv("PT_ELASTIC_ATTEMPT", "1")
    led = goodput.GoodputLedger()
    led.start()
    led.stop()
    snap = led.snapshot()
    assert snap["buckets"]["restart_idle"] >= 2.5
    led.start()
    led.stop()
    assert led.snapshot()["buckets"]["restart_idle"] == \
        snap["buckets"]["restart_idle"]


def test_measure_is_a_no_op_off_or_stopped(clocks):
    led = goodput.GoodputLedger()
    with led.measure("eval"):  # not running
        clocks["port"].advance(1.0)
    ptt.set_flags({"enable_metrics": False})
    led.start()
    with led.measure("eval"):  # metrics off
        clocks["port"].advance(1.0)
    assert led.snapshot()["buckets"]["eval"] == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshot_equals_jax_for_the_same_sequence(metrics_on, clocks,
                                                   seed):
    """The same seeded start/measure/attribute/stop sequence, each
    package under its own fake clock advanced alike: equal snapshots."""
    jax_metrics.set_enabled(True)
    snaps = []
    for mod, clk in ((jax_goodput, clocks["jax"]),
                     (goodput, clocks["port"])):
        rng = np.random.default_rng(seed)
        led = mod.GoodputLedger()
        led.start()
        for _ in range(30):
            op = int(rng.integers(0, 4))
            dt = float(np.round(rng.exponential(0.01), 6))
            bucket = str(rng.choice([b for b in mod.BUCKETS
                                     if b != "other"]))
            if op == 0:
                led.attribute(bucket, dt)
            elif op == 1:
                with led.measure(bucket, flight_event=False):
                    clk.advance(dt)
                    if rng.random() < 0.5:
                        with led.measure("checkpoint",
                                         flight_event=False):
                            clk.advance(dt / 2)
            elif op == 2:
                clk.advance(dt)
            else:
                led.stop()
                clk.advance(dt)
                led.start()
        led.stop()
        snaps.append(led.snapshot())
    assert snaps[1] == snaps[0]
    assert tuple(goodput.BUCKETS) == tuple(jax_goodput.BUCKETS)


@pytest.mark.parametrize("times, factor", [
    ([1.0, 1.0, 1.0, 5.0], 2.0), ([1.0, 1.0, 1.0, 1.4], 1.5),
    ([1.0], 2.0), ([1.0, 9.0], 0.0), ([0.0, 0.0], 2.0),
    ([3.0, 1.0, 1.2, 7.5, 1.1], 1.5)])
def test_flag_stragglers_matches_jax(times, factor):
    assert goodput.flag_stragglers(times, factor) \
        == jax_goodput.flag_stragglers(times, factor)


def test_compile_bucket_always_cold_by_design():
    assert goodput.classify_compile_bucket({"hits": 0}) == \
        "jit_compile_cold"
    assert goodput.compile_cache_stats() == {"hits": 0, "misses": 0}


class _Graph:
    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


class _EagerGraphs:
    """The captured step's backend on the CPU: the warm-up runs the step,
    the capture keeps the body, a replay runs it."""

    def warm_up(self, fn):
        return fn()

    def capture(self, fn, generator=None, table_rows=0):
        return _Graph(fn), []


def _linear_step(compiled: bool):
    from paddle_tpu_torch.nn.layers import Linear
    from paddle_tpu_torch.ops.loss import cross_entropy
    from paddle_tpu_torch.optimizer import Adam
    torch.manual_seed(0)
    step = TrainStep(Linear(4, 2, device="cpu"), Adam(0.01),
                     lambda o, y: cross_entropy(o, y))
    if compiled:
        step.compiled, step._backend = True, _EagerGraphs()
    return step


def test_capture_seconds_are_compile_seconds(metrics_on):
    step = _linear_step(compiled=True)
    y = torch.tensor([0, 1, 1, 0])
    before = goodput.compile_seconds_total()
    step(torch.randn(4, 4), labels=y)
    first = goodput.compile_seconds_total() - before
    step(torch.randn(4, 4), labels=y)  # a replay: no compile time
    assert goodput.compile_seconds_total() - before == first > 0
    rec = obs.recompile_tracker().get("TrainStep(Linear)").stats()
    assert sum(rec["compile_times_s"]) == pytest.approx(
        goodput.compile_seconds_total())


def test_checkpoint_host_time_charged_to_ledger(metrics_on, tmp_path):
    led = obs.goodput_ledger()
    led.start()
    try:
        ck = pio.AsyncCheckpointer(str(tmp_path))
        state = {"w": torch.arange(6.0)}
        ck.save(state, step=1)
        ck.wait()
        ck.save(state, step=2)
        ck.wait()
        snap = led.snapshot()
        assert snap["buckets"]["checkpoint"] > 0
        kinds = [e for e in obs.flight_recorder().events()
                 if e["kind"] == "ledger"]
        assert kinds and all(e["bucket"] == "checkpoint" for e in kinds)
        assert os.path.isdir(tmp_path / "ckpt-2")
    finally:
        led.stop()


# -- program cards --------------------------------------------------------------

def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (B, T))
    types = rng.integers(0, 2, (B, T))
    mask = np.ones((B, T), np.int64)
    pos = np.sort(rng.permuted(np.broadcast_to(np.arange(T), (B, T)),
                               axis=1)[:, :P], axis=1)
    mlm = rng.integers(0, 512, (B, P))
    nsp = rng.integers(0, 2, (B,))
    return ids, types, mask, pos, mlm, nsp


def _analytic_step_flops(cfg: dict) -> float:
    """Matrix products of one BERT pretraining step, forward x 3 (the
    forward product plus its two backward products): per layer the four
    projections, the two FFN products and the two attention products;
    the pooler and the NSP classifier on the [CLS] rows; the MLM
    transform and decoder on the masked rows."""
    h, i, v = cfg["hidden_size"], cfg["intermediate_size"], \
        cfg["vocab_size"]
    n, m = B * T, B * P
    layer = 4 * 2 * n * h * h + 2 * 2 * n * h * i + 2 * 2 * B * T * T * h
    heads = 2 * B * h * h + 2 * B * h * 2 + 2 * m * h * h + 2 * m * h * v
    return 3.0 * (cfg["num_hidden_layers"] * layer + heads)


def test_tiny_bert_card_counts_the_analytic_flops(metrics_on, capsys):
    model = BertForPretraining(BertConfig(**SMALL), device="cpu")
    step = TrainStep(model, AdamW(1e-3), pretraining_loss)
    ids, types, mask, pos, mlm, nsp = (torch.from_numpy(a)
                                       for a in _batch())
    step(ids, types, mask, pos, labels=(mlm, nsp))
    card = obs.program_cards().latest("TrainStep(BertForPretraining)")
    want = _analytic_step_flops(SMALL)
    assert card["flops"] == pytest.approx(want, rel=FLOPS_RTOL)
    assert xprof.flops_of("TrainStep(BertForPretraining)") == card["flops"]
    assert card["unavailable"] == xprof.BYTES_UNAVAILABLE
    assert card["signature"].startswith("(int64[2, 32]")
    assert obs.gauge("program_flops").value(
        fn="TrainStep(BertForPretraining)") == card["flops"]
    # the JAX card of the same step: XLA's cost model over its program
    pt.set_flags({"enable_metrics": True, "metrics_port": -1})
    jm = JaxBert(JaxBertConfig(**SMALL))
    jstep = JaxTrainStep(jm, JaxAdamW(learning_rate=1e-3),
                         lambda out, a, b: jax_loss(out, a, b))
    jb = [jnp.asarray(a.astype(np.int32)) for a in _batch()[:4]]
    jstep(*jb, labels=(jnp.asarray(_batch()[4]),
                       jnp.asarray(_batch()[5])))
    jcard = jax_obs.program_cards().latest("TrainStep(BertForPretraining)")
    with capsys.disabled():
        print(f"\ntiny BERT step FLOPs: port card {card['flops']:.6g}, "
              f"analytic matmuls {want:.6g}, JAX card (XLA cost model) "
              f"{jcard.get('flops') if jcard else None}")


def test_one_card_per_signature_and_captured_steps_card(metrics_on):
    step = _linear_step(compiled=True)
    y = torch.tensor([0, 1, 1, 0])
    for n in (4, 4, 3):
        step(torch.randn(n, 4), labels=y[:n])
    cards = obs.program_cards().get("TrainStep(Linear)")
    assert sorted(cards) == ["(float32[3, 4],int64[3])",
                             "(float32[4, 4],int64[4])"]
    # forward 2*n*4*2, backward dW only (the input needs no gradient)
    assert cards["(float32[4, 4],int64[4])"]["flops"] == 2 * (2 * 4 * 4 * 2)
    eager = _linear_step(compiled=False)
    for n in (4, 4):
        eager(torch.randn(n, 4), labels=y[:n])
    assert list(obs.program_cards().get("TrainStep(Linear)")) \
        == list(cards)  # the eager twin's card replaced the same key


def test_analytics_flag_gates_the_card(metrics_on):
    ptt.set_flags({"program_analytics": False})
    step = _linear_step(compiled=False)
    step(torch.randn(4, 4), labels=torch.tensor([0, 1, 1, 0]))
    assert obs.program_cards().snapshot() == {}
    assert xprof.flops_of("TrainStep(Linear)") is None
    ptt.set_flags({"program_analytics": True, "enable_metrics": False})
    step(torch.randn(3, 4), labels=torch.tensor([0, 1, 1]))
    assert obs.program_cards().snapshot() == {}


class _KernelLike(torch.autograd.Function):
    """A stand-in for a ctypes kernel wrapper: an elementwise op (no
    FLOP formula) that reports its FLOPs by hand, forward and
    backward."""

    @staticmethod
    def forward(ctx, x):
        xprof.add_kernel_flops("test_kernel_fwd", 1000)
        return x * 2.0

    @staticmethod
    def backward(ctx, g):
        xprof.add_kernel_flops("test_kernel_bwd", 3000)
        return g * 2.0


def test_kernel_flops_reach_the_card_from_forward_and_backward(metrics_on):
    from paddle_tpu_torch.nn.layers import Linear
    from paddle_tpu_torch.optimizer import Adam
    torch.manual_seed(0)
    lin = Linear(4, 2, device="cpu")
    step = TrainStep(lin, Adam(0.01),
                     lambda o: _KernelLike.apply(o).square().mean())
    step(torch.randn(5, 4))
    card = obs.program_cards().latest("TrainStep(Linear)")
    assert card["flops_by_op"]["test_kernel_fwd"] == 1000
    assert card["flops_by_op"]["test_kernel_bwd"] == 3000
    assert card["cost_analysis"]["flops_cuda_kernels"] == 4000
    assert card["flops"] == 4000 + 2 * (2 * 5 * 4 * 2)
    # outside a harvest the wrappers' reports go nowhere
    assert not xprof.counting()
    xprof.add_kernel_flops("test_kernel_fwd", 1)


@pytest.mark.parametrize("b, h, tq, tk, d, causal", [
    (8, 12, 512, 512, 64, False), (2, 3, 100, 100, 64, True),
    (1, 2, 64, 200, 32, True), (1, 2, 200, 64, 128, True)])
def test_flash_kernel_counts_are_the_bounds_formulas(b, h, tq, tk, d,
                                                     causal):
    bounds = chip_smoke.flash_bounds(b, h, tq, tk, d, causal, False)
    e = fa.score_entries(b, h, tq, tk, causal)
    for name, products in (("flash_attention_fwd", 2),
                           ("flash_attention_bwd_dq", 3),
                           ("flash_attention_bwd_dkv", 4),
                           ("flash_attention_bwd_fused", 5)):
        assert 2 * products * e * d == bounds[name][1], name


def test_analytics_change_no_bit_of_the_state():
    """One step of a tiny BERT with program analytics on and one with
    them off, from the same weights: every parameter and moment equal
    bit for bit."""
    states = []
    for analytics in (True, False):
        ptt.set_flags({"enable_metrics": True,
                       "program_analytics": analytics})
        model = BertForPretraining(BertConfig(**SMALL), device="cpu",
                                   seed=3)
        step = TrainStep(model, AdamW(1e-3), pretraining_loss)
        ids, types, mask, pos, mlm, nsp = (torch.from_numpy(a)
                                           for a in _batch(1))
        loss = step(ids, types, mask, pos, labels=(mlm, nsp))["loss"]
        states.append((float(loss), {k: v.clone() for k, v in
                                     pio.flatten(step.state_dict()).items()}))
    assert (obs.program_cards().latest("TrainStep(BertForPretraining)")
            is not None)
    assert states[0][0] == states[1][0]
    for k, v in states[0][1].items():
        assert torch.equal(v, states[1][1][k]), k
