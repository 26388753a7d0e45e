"""PyTorch port: ``inference.Config``/``Predictor``/``Tensor``/``clone`` and
``Server(predictor)`` against the JAX package's, on the CPU.

Mirrors ``tests/test_inference.py`` (predictor against eager, bucket
padding and slicing, bad row shapes, clone, the server end to end and
batching concurrent requests) on the port, with the JAX MLP's weights
moved in; then the small BERT of ``tests/test_torch_jit.py`` through
both packages' ``jit.save`` -> ``Predictor.run`` at batches 1, 3 and 8
with buckets; the bucket graphs' bookkeeping with a stand-in for the
card's CUDA graph backend (as ``tests/test_torch_compiled_step.py``
does for ``TrainStep``); a JAX ``Client`` against a port server; the
error paths and the server's telemetry names against the JAX server's.
"""

import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as pt  # noqa: E402
from paddle_tpu import inference as jinf  # noqa: E402
from paddle_tpu import jit as jax_jit  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.models import BertConfig as JaxBertConfig  # noqa: E402
from paddle_tpu.models import BertModel as JaxBertModel  # noqa: E402

import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu_torch import inference as pinf, jit  # noqa: E402
from paddle_tpu_torch import native  # noqa: E402
from paddle_tpu_torch.convert import load_jax_params  # noqa: E402
from paddle_tpu_torch.models import BertConfig, BertModel  # noqa: E402
from paddle_tpu_torch.nn import Linear  # noqa: E402

SMALL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=128,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             max_position_embeddings=64)
T = 32
# tests/test_torch_bert.py's tolerance (two fp32 encoder layers summed
# in another order than XLA's); the MLP's is tests/test_inference.py's
LOGIT_TOL = 2e-5
MLP_TOL = 1e-5
WAIT_S = 30.0


class _JaxNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(8, 16)
        self.fc2 = jnn.Linear(16, 3)

    def forward(self, x):
        return self.fc2(jnn.functional.relu(self.fc1(x)))


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = Linear(8, 16, device="cpu")
        self.fc2 = Linear(16, 3, device="cpu")

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _jax_params(layer):
    return {k: np.asarray(v) for k, v in layer.param_dict().items()}


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """(port dir, JAX dir, x, eager output) of the MLP, both packages
    exporting the same weights."""
    root = tmp_path_factory.mktemp("inf")
    pt.seed(7)
    jm = _JaxNet()
    net = load_jax_params(_Net(), _jax_params(jm))
    spec = [jit.InputSpec([None, 8], name="feats")]
    jit.save(net, str(root / "port"), input_spec=spec)
    jax_jit.save(jm, str(root / "jax"),
                 input_spec=[jax_jit.InputSpec([None, 8], name="feats")])
    x = np.random.default_rng(0).normal(size=(5, 8)).astype(np.float32)
    with torch.no_grad():
        want = net(torch.from_numpy(x)).numpy()
    return str(root / "port"), str(root / "jax"), x, want


def _pred(d, **kw):
    cfg = pinf.Config(d, device="cpu")
    for k, v in kw.items():
        getattr(cfg, k)(v)
    return pinf.create_predictor(cfg)


class _Replayer:
    def __init__(self, fn):
        self.fn = fn
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.fn()


class _EagerGraphs:
    """Stands in for the card's graph backend on the CPU: the warm-up
    runs the program, the capture keeps the body without running it (as
    a capture records and runs nothing), a replay runs it."""

    def __init__(self):
        self.warm_ups = 0
        self.graphs = []

    def warm_up(self, fn):
        self.warm_ups += 1
        return fn()

    def capture(self, fn, generator, table_rows):
        self.graphs.append(_Replayer(fn))
        return self.graphs[-1], []


def _graphed(pred):
    backend = _EagerGraphs()
    pred._shared._backend = backend
    return backend


# ---------------------------------------------------------------------------
# tests/test_inference.py on the port
# ---------------------------------------------------------------------------

def test_predictor_matches_eager(artifact):
    d, _, x, want = artifact
    pred = _pred(d)
    assert pred.get_input_names() == ["feats"]
    assert pred.device == torch.device("cpu")
    h = pred.get_input_handle("feats")
    h.copy_from_cpu(x)
    outs = pred.run()
    np.testing.assert_allclose(outs[0], want, rtol=MLP_TOL, atol=MLP_TOL)
    handle = pred.get_output_handle(pred.get_output_names()[0])
    # the output handle holds a device tensor until copy_to_cpu
    assert isinstance(handle._value, torch.Tensor)
    np.testing.assert_array_equal(handle.copy_to_cpu(), outs[0])
    assert handle.shape == (5, 3)


def test_predictor_matches_jax_predictor(artifact):
    d, jd, x, _ = artifact
    pred, jpred = _pred(d), jinf.create_predictor(jinf.Config(jd))
    for rows in (1, 3, 5):
        np.testing.assert_allclose(pred.run([x[:rows]])[0],
                                   jpred.run([x[:rows]])[0],
                                   rtol=MLP_TOL, atol=MLP_TOL)


def test_batch_bucketing_pads_and_slices(artifact):
    d, _, x, want = artifact
    pred = _pred(d, set_batch_buckets=[4, 8, 64])
    backend = _graphed(pred)
    outs = pred.run([x])  # batch 5 -> bucket 8, sliced back to 5
    assert outs[0].shape == (5, 3)
    np.testing.assert_allclose(outs[0], want, rtol=MLP_TOL, atol=MLP_TOL)
    outs3 = pred.run([x[:3]])  # bucket 4: a second graph
    np.testing.assert_allclose(outs3[0], want[:3], rtol=MLP_TOL,
                               atol=MLP_TOL)
    outs2 = pred.run([x[:2]])  # bucket 4 again: a replay, no capture
    np.testing.assert_allclose(outs2[0], want[:2], rtol=MLP_TOL,
                               atol=MLP_TOL)
    assert pred.captures == 2 and backend.warm_ups == 2
    assert sorted(k[0][0][0] for k in pred._shared.graphs) == [4, 8]
    assert [g.replays for g in backend.graphs] == [0, 1]
    # a batch above the largest bucket keeps its own shape: one more graph
    big = np.repeat(x, 14, axis=0)[:70]
    assert pred.run([big])[0].shape == (70, 3)
    assert pred.captures == 3
    assert (70, 8) in [k[0][0] for k in pred._shared.graphs]


def test_padding_repeats_the_last_row(artifact):
    d, _, x, _ = artifact
    pred = _pred(d, set_batch_buckets=[8])
    seen = []
    module = pred._shared.module

    def recording(params, buffers, *args):
        seen.append(args[0].clone())
        return module(params, buffers, *args)

    pred._shared.module = recording
    pred.run([x[:3]])
    assert seen[0].shape == (8, 8)
    assert torch.equal(seen[0][:3], torch.from_numpy(x[:3]))
    assert torch.equal(seen[0][3:], torch.from_numpy(x[2:3]).expand(5, 8))


def test_ir_optim_off_runs_the_exact_shape(artifact):
    d, _, x, want = artifact
    pred = _pred(d, switch_ir_optim=False)
    backend = _graphed(pred)
    seen = []
    module = pred._shared.module

    def recording(params, buffers, *args):
        seen.append(tuple(args[0].shape))
        return module(params, buffers, *args)

    pred._shared.module = recording
    for rows in (5, 3):
        np.testing.assert_allclose(pred.run([x[:rows]])[0], want[:rows],
                                   rtol=MLP_TOL, atol=MLP_TOL)
    assert seen == [(5, 8), (3, 8)]
    assert pred.captures == 0 and not backend.graphs


def test_predictor_rejects_bad_row_shape(artifact):
    d, _, _, _ = artifact
    pred = _pred(d)
    h = pred.get_input_handle("feats")
    jh = jinf.Tensor("feats", (None, 8), "float32")
    for bad, match in ((np.zeros((2, 9), np.float32), "does not match"),
                       (np.zeros((2, 8, 1), np.float32), "rank 3")):
        with pytest.raises(ValueError, match=match) as port_err:
            h.copy_from_cpu(bad)
        with pytest.raises(ValueError) as jax_err:
            jh.copy_from_cpu(bad)
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="inputs not set"):
        _pred(d).run()
    with pytest.raises(ValueError, match="dtype torch.int64 does not match"):
        pred.run([np.zeros((2, 8), np.int64)])
    # another float width is taken as the spec's, as the JAX export does
    assert pred.run([np.zeros((2, 8), np.float64)])[0].dtype == np.float32


def test_clone_shares_weights_graphs_and_lock(artifact):
    d, _, x, want = artifact
    pred = _pred(d)
    _graphed(pred)
    pred.run([x])
    clone = pred.clone()
    assert clone._shared is pred._shared
    assert clone._shared.params is pred._shared.params
    assert clone._shared.run_lock is pred._shared.run_lock
    outs = clone.run([x])
    np.testing.assert_allclose(outs[0], want, rtol=MLP_TOL, atol=MLP_TOL)
    assert clone.captures == pred.captures == 1
    # handles are the clone's own
    assert clone.get_input_handle("feats") is not \
        pred.get_input_handle("feats")


def test_concurrent_clones(artifact):
    d, _, x, want = artifact
    pred = _pred(d)
    clones = [pred.clone() for _ in range(4)]
    errs = []

    def worker(p, rows):
        try:
            for _ in range(5):
                out = p.run([x[:rows]])[0]
                np.testing.assert_allclose(out, want[:rows], rtol=MLP_TOL,
                                           atol=MLP_TOL)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(c, i + 1))
               for i, c in enumerate(clones)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs


def test_enable_profile_counts_runs(artifact):
    d, _, x, _ = artifact
    pred = _pred(d)
    pred.config.enable_profile()
    runs0 = native.stat_get("inference.runs")
    us0 = native.stat_get("inference.us")
    pred.run([x])
    pred.run([x[:2]])
    assert native.stat_get("inference.runs") - runs0 == 2
    assert native.stat_get("inference.us") > us0


def test_config_parity_surface(tmp_path):
    cfg, jcfg = pinf.Config(str(tmp_path)), jinf.Config(str(tmp_path))
    for c in (cfg, jcfg):
        c.switch_ir_optim(False)
        c.enable_memory_optim(False)
        c.set_precision(pinf.PrecisionType.Half)
        c.set_max_batch_size(48)
        c.disable_glog_info()
    for attr in ("_ir_optim", "_memory_optim", "_precision",
                 "_max_batch_size"):
        assert getattr(cfg, attr) == getattr(jcfg, attr)
    assert cfg.batch_buckets() == jcfg.batch_buckets() == [
        1, 2, 4, 8, 16, 32, 48]
    for name in ("Float32", "Half", "Bfloat16", "Int8"):
        assert getattr(pinf.PrecisionType, name) == getattr(
            jinf.PrecisionType, name)
    assert cfg._device is None  # the card, as resolve_device reads it


def test_predictor_on_the_card_needs_one(artifact):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pinf.create_predictor(pinf.Config(artifact[0]))


# ---------------------------------------------------------------------------
# BERT through both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bert(tmp_path_factory):
    """(port predictor dir, JAX predictor dir, port model) of a small
    BERT, both exporting ``input_ids`` alone (the JAX ``jit.save`` mixes
    symbolic scopes with more than one polymorphic input)."""
    root = tmp_path_factory.mktemp("bert")
    pt.seed(0)
    jm = JaxBertModel(JaxBertConfig(**SMALL))
    pm = load_jax_params(BertModel(BertConfig(**SMALL), device="cpu"),
                         _jax_params(jm)).eval()
    jit.save(pm, str(root / "port"),
             input_spec=[jit.InputSpec([None, T], "int64",
                                       name="input_ids")])
    jax_jit.save(jm, str(root / "jax"),
                 input_spec=[jax_jit.InputSpec([None, T], "int32",
                                               name="input_ids")])
    return str(root / "port"), str(root / "jax"), pm


def test_bert_predictor_matches_jax_predictor(bert):
    d, jd, pm = bert
    pred = _pred(d, set_batch_buckets=[2, 4, 8])
    backend = _graphed(pred)
    jcfg = jinf.Config(jd)
    jcfg.set_batch_buckets([2, 4, 8])
    jpred = jinf.create_predictor(jcfg)
    rng = np.random.default_rng(4)
    for b in (1, 3, 8):
        ids = rng.integers(0, SMALL["vocab_size"], (b, T))
        got = pred.run([ids])
        want = jpred.run([ids.astype(np.int32)])
        assert [g.shape for g in got] == [(b, T, 64), (b, 64)]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=LOGIT_TOL, atol=LOGIT_TOL)
        with torch.no_grad():
            padded = np.concatenate([ids, np.repeat(ids[-1:], {1: 1, 3: 1,
                                                               8: 0}[b],
                                                    axis=0)])
            eager = pm(torch.from_numpy(padded))
        for g, e in zip(got, eager):
            np.testing.assert_array_equal(g, e[:b].numpy())
    assert pred.captures == 3 and len(backend.graphs) == 3


# ---------------------------------------------------------------------------
# Server(predictor)
# ---------------------------------------------------------------------------

def test_server_end_to_end(artifact):
    d, _, x, want = artifact
    pred = _pred(d)
    with pinf.Server(pred, max_batch=8, wait_ms=20) as srv:
        with pinf.Client(port=srv.port, timeout_s=WAIT_S) as cli:
            outs = cli.infer([x])
            np.testing.assert_allclose(outs[0], want, rtol=MLP_TOL,
                                       atol=MLP_TOL)


@pytest.mark.parametrize("client", ["port", "jax"])
def test_server_batches_concurrent_requests(artifact, client):
    d, _, x, want = artifact
    cls = pinf.Client if client == "port" else jinf.Client
    pred = _pred(d)
    with pinf.Server(pred, max_batch=16, wait_ms=100) as srv:
        n_clients = 6
        results = [None] * n_clients
        errs = []

        def worker(i):
            try:
                with cls(port=srv.port, timeout_s=WAIT_S) as cli:
                    rows = 1 + (i % 3)
                    results[i] = (rows, cli.infer([x[:rows]])[0])
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errs
        for rows, out in results:
            assert out.shape == (rows, 3)
            np.testing.assert_allclose(out, want[:rows], rtol=MLP_TOL,
                                       atol=MLP_TOL)
    # read once the loop has stopped: a request is counted after its
    # reply goes out, as in the JAX server
    assert srv.n_requests == n_clients
    # the 100 ms window merges the six concurrent requests
    assert srv.n_batches < n_clients


def test_jax_client_gets_bert_tensors_from_a_port_server(bert):
    d, jd, _ = bert
    pred = _pred(d)
    jpred = jinf.create_predictor(jinf.Config(jd))
    rng = np.random.default_rng(6)
    ids = rng.integers(0, SMALL["vocab_size"], (3, T))
    with pinf.Server(pred, max_batch=8, wait_ms=5) as srv:
        with jinf.Client(port=srv.port, timeout_s=WAIT_S) as cli:
            got = cli.infer([ids])
    want = jpred.run([ids.astype(np.int32)])
    assert [g.dtype for g in got] == [np.float32, np.float32]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_server_error_paths_keep_serving(artifact):
    d, _, x, want = artifact
    with pinf.Server(_pred(d), max_batch=8, wait_ms=5) as srv:
        with pinf.Client(port=srv.port, timeout_s=WAIT_S) as cli:
            with pytest.raises(RuntimeError, match="leading batch dim"):
                cli.infer([np.float32(1.0).reshape(())])
            with pytest.raises(RuntimeError, match="does not match spec"):
                cli.infer([np.zeros((2, 9), np.float32)])
            np.testing.assert_allclose(cli.infer([x])[0], want,
                                       rtol=MLP_TOL, atol=MLP_TOL)
    # read once the loop has stopped (a request counts after its reply)
    assert srv.n_errors == 1 and srv.n_requests == 1


def test_server_without_a_predictor_answers_tensor_requests_so():
    with pinf.Server(None) as srv:
        with pinf.Client(port=srv.port, timeout_s=WAIT_S) as cli:
            with pytest.raises(RuntimeError, match="no predictor"):
                cli.infer([np.zeros((1, 2), np.float32)])


def _serve_and_read(inf_mod, obs_mod, pred, x):
    """One ok request batch, one decode_error and one execute_error
    through ``inf_mod``'s server over ``pred``; returns (the batch stats
    of the STATS reply, the metrics, the request outcomes)."""
    with inf_mod.Server(pred, max_batch=8, wait_ms=5) as srv:
        with inf_mod.Client(port=srv.port, timeout_s=WAIT_S) as cli:
            before = cli.stats()
            cli.infer([x[:3]])
            for bad in ([np.float32(1.0).reshape(())],
                        [np.zeros((2, 9), np.float32)]):
                with pytest.raises(RuntimeError):
                    cli.infer(bad)
            after = cli.stats()
    # the counters this run moved: STATS also lists, unmoved, every
    # counter an earlier server of the same process registered (a JAX
    # serving test run before this one on the worker registers batch
    # sizes 1 and 2 in the JAX library only)
    stats = {k: after[k] - before.get(k, 0) for k in after
             if k.startswith("serving.batch")
             and after[k] != before.get(k, 0)}
    snap = obs_mod.registry().snapshot()
    metrics = {}
    for name in ("serving_batch_size", "serving_requests_total",
                 "serving_errors_total", "serving_e2e_ms",
                 "serving_compute_ms"):
        series = snap.get(name, {"series": []})["series"]
        metrics[name] = [s.get("count", s.get("value")) for s in series]
    outcomes = [r["outcome"] for r in obs_mod.reqtrace.recent()
                if not r.get("stream")]
    return stats, metrics, outcomes


def test_server_telemetry_matches_jax(artifact):
    from paddle_tpu import observability as jax_obs
    from paddle_tpu_torch import observability as obs
    d, jd, x, _ = artifact
    pt.set_flags({"enable_metrics": True, "metrics_port": -1})
    ptt.set_flags({"enable_metrics": True, "metrics_port": -1})
    jax_obs.reset_all()
    obs.reset_all()
    try:
        jax_view = _serve_and_read(jinf, jax_obs,
                                   jinf.create_predictor(jinf.Config(jd)),
                                   x)
        port_view = _serve_and_read(pinf, obs, _pred(d), x)
    finally:
        pt.set_flags({"enable_metrics": False, "metrics_port": 0})
        ptt.set_flags({"enable_metrics": False, "metrics_port": 0})
        jax_obs.reset_all()
        obs.reset_all()
    assert port_view == jax_view
    stats, metrics, outcomes = port_view
    assert stats["serving.batches_total"] == 1
    assert stats["serving.batch_rows_total"] == 3
    assert stats["serving.batch_size_le_4"] == 1
    assert stats.get("serving.batch_size_le_2", 0) == 0
    assert stats["serving.batch_errors_total"] == 1
    assert metrics["serving_batch_size"] == [1]
    assert metrics["serving_requests_total"] == [1]
    assert metrics["serving_errors_total"] == [1]
    assert metrics["serving_e2e_ms"] == [1]
    assert outcomes == ["ok", "decode_error", "execute_error"]


def test_server_serves_predictor_and_engine_side_by_side(artifact):
    """A server with both halves: stream frames to the engine, tensor
    frames to the predictor."""
    from paddle_tpu_torch.models import GPTConfig, GPTLanguageModel
    from paddle_tpu_torch.serving_llm import LLMEngine
    d, _, x, want = artifact
    gpt = GPTLanguageModel(GPTConfig(vocab_size=64, hidden_size=32,
                                     num_layers=1, num_heads=2,
                                     intermediate_size=64,
                                     max_position_embeddings=64),
                           device="cpu")
    eng = LLMEngine(gpt, device="cpu", block_size=4, pool_blocks=16)
    with pinf.Server(_pred(d), llm_engine=eng, wait_ms=5) as srv:
        with pinf.Client(port=srv.port, timeout_s=WAIT_S) as cli:
            assert len(cli.generate([1, 2, 3], max_new_tokens=3)) == 3
            np.testing.assert_allclose(cli.infer([x])[0], want,
                                       rtol=MLP_TOL, atol=MLP_TOL)
    deadline = time.time() + WAIT_S
    while eng.allocator.num_used and time.time() < deadline:
        time.sleep(0.01)
    assert eng.allocator.num_used == 0
