"""PyTorch port: the verify entry (``paddle_tpu_torch.verify``) on the CPU.

The CPU test runs have no CUDA device, so the kernel checks cannot run
for real: ``run_verification()`` must say so (``ok: false``, "no CUDA
device") in its artifact and exit non-zero, and nothing may pretend to
have checked a kernel. What runs here: the 10-step MLP + SGD parity
through
``TrainStep`` on the CPU (against its numpy re-derivation, and against
the JAX package's ``TrainStep`` on the same weights within ``TOL``), and
the kernel-check harness itself with each CUDA wrapper replaced by its
plain version: every check passes, and a wrapper off by 1% is named as
a failure.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as pt  # noqa: E402
from paddle_tpu.static import TrainStep as JaxTrainStep  # noqa: E402

from paddle_tpu_torch import nn, verify  # noqa: E402
from paddle_tpu_torch.convert import load_jax_params  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.kernels import fused_adam as adam  # noqa: E402
from paddle_tpu_torch.kernels import fused_softmax_xent as fx  # noqa: E402
from paddle_tpu_torch.kernels import layer_norm as ln  # noqa: E402
from paddle_tpu_torch.kernels import paged_attention as pa  # noqa: E402
from paddle_tpu_torch.optimizer import SGD  # noqa: E402
from paddle_tpu_torch.static import TrainStep  # noqa: E402

# fp32 forward/backward of a 8-32-4 MLP, ten SGD steps, sums in another
# order than XLA's
TOL = 1e-6


def test_train_parity_runs_on_the_cpu_when_asked():
    res = verify.train_parity_10steps(device="cpu")
    assert res["ok"] and res["device"] == "cpu"
    assert res["max_rel_err"] < 1e-5
    assert res["losses"][-1] < res["losses"][0] and len(res["losses"]) == 10


def test_parity_model_trains_like_the_jax_one():
    """The parity check's model and optimizer step for step against the
    JAX package's ``verify`` model (Sequential Linear-Tanh-Linear, SGD
    0.1, MSE) on the same weights and data."""
    pt.seed(0)
    jnet = pt.nn.Sequential(pt.nn.Linear(8, 32), pt.nn.Tanh(),
                            pt.nn.Linear(32, 4))
    pnet = nn.Sequential(nn.Linear(8, 32, device="cpu"), nn.Tanh(),
                         nn.Linear(32, 4, device="cpu"))
    load_jax_params(pnet, {k: np.asarray(v)
                           for k, v in jnet.param_dict().items()})
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (16, 8)).astype(np.float32)
    t = rng.normal(0, 1, (16, 4)).astype(np.float32)
    jstep = JaxTrainStep(jnet, pt.optimizer.SGD(learning_rate=0.1),
                         lambda out, y: ((out - y) ** 2).mean())
    pstep = TrainStep(pnet, SGD(learning_rate=0.1),
                      lambda out, y: ((out - y) ** 2).mean())
    jl = [float(jstep(jnp.asarray(x), labels=jnp.asarray(t))["loss"])
          for _ in range(10)]
    pl = [float(pstep(torch.from_numpy(x), labels=torch.from_numpy(t))
                ["loss"]) for _ in range(10)]
    assert np.max(np.abs(np.array(pl) - np.array(jl))) <= TOL
    jstep.sync_to_model()
    own = pnet.state_dict()
    for k, v in jnet.param_dict().items():
        assert np.max(np.abs(own[k].numpy() - np.asarray(v))) <= TOL, k


def test_no_cuda_device_writes_ok_false(tmp_path):
    path = tmp_path / "VERIFY_CUDA.json"
    res = verify.run_verification(str(path))
    assert res["ok"] is False and res["kernels_ok"] is False
    assert res["reason"] == "no CUDA device"
    assert not res["train_parity"]["ok"]
    assert json.loads(path.read_text()) == res
    assert verify.default_artifact_path().endswith(
        "paddle_tpu_torch/_build/VERIFY_CUDA.json")


def test_entry_point_exits_non_zero_without_a_card(tmp_path):
    path = tmp_path / "artifact.json"
    r = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.verify",
                        str(path)], capture_output=True, text=True,
                       timeout=120, cwd=str(verify._PKG + "/.."))
    assert r.returncode == 1, r.stderr[-2000:]
    assert json.loads(path.read_text())["ok"] is False


@pytest.fixture
def plain_wrappers(monkeypatch):
    """Every CUDA wrapper the checks call, replaced by its plain
    version (the harness's own test: a card is not needed for it)."""
    o_ln, o_fa = ln.layer_norm, fa.flash_attention
    o_lse, o_fx = fa.flash_attention_with_lse, fx.fused_linear_xent
    monkeypatch.setattr(ln, "layer_norm", lambda x, w, b, eps: o_ln(
        x, w, b, eps, forward=ln.layer_norm_plain))
    monkeypatch.setattr(pa, "paged_attention",
                        pa.paged_attention_split_plain)
    monkeypatch.setattr(pa, "paged_attention_multiquery",
                        pa.paged_attention_multiquery_split_plain)
    monkeypatch.setattr(fa, "flash_attention", lambda *a, kernels=None,
                        **k: o_fa(*a, kernels=fa.PLAIN_KERNELS, **k))
    monkeypatch.setattr(fa, "flash_attention_with_lse",
                        lambda *a, kernels=None, **k: o_lse(
                            *a, kernels=fa.PLAIN_KERNELS, **k))
    monkeypatch.setattr(fx, "fused_linear_xent", lambda *a, kernels=None,
                        **k: o_fx(*a, kernels=fx.PLAIN_KERNELS, **k))
    monkeypatch.setattr(adam, "adam_multi", adam.adam_multi_plain)
    return o_fa


def test_kernel_checks_pass_on_plain_stand_ins(plain_wrappers):
    assert verify.validate_kernels(device="cpu") == []


def test_kernel_checks_name_a_wrong_kernel(plain_wrappers, monkeypatch):
    wrong = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention", lambda q, k, v, *a, **kw:
                        wrong(q, k, v, *a, **kw)
                        * (1.01 if "kernels" not in kw else 1.0))
    monkeypatch.setattr(adam, "adam_multi", lambda p, *a, **kw: [
        t.mul_(1 + 2 ** -20) for t in p] and adam.adam_multi_plain(
        p, *a, **kw))
    failures = verify.validate_kernels(device="cpu")
    assert [f.split(":")[0] for f in failures] == [
        "flash_attention_split_bwd", "flash_attention_fused_bwd",
        "adam_leaf", "adam_flat"]


def test_kernels_source_hash_is_stable():
    h = verify.kernels_source_hash()
    assert h == verify.kernels_source_hash() and len(h) == 16
    int(h, 16)
