"""PyTorch port: ``incubate.auto_checkpoint`` and ``sysconfig`` against
the JAX package on the CPU.

- ``TrainEpochRange``: the JAX test's resume (a crash after epoch 2
  resumes at epoch 2 with epoch 1's state), the same checkpoint
  directories as the JAX range, a JAX range's checkpoint resumed by the
  port's, a ``TrainStep``'s whole state through an interruption bit for
  bit with the uninterrupted run, and SIGTERM (a forced checkpoint, then
  the signal re-raised).
- ``sysconfig``: the JAX names; ``get_include``/``get_lib`` directories
  holding the header and library; the ``compile_cache_dir`` flag
  pointing the kernel build's directory, with a library found built
  counted as a hit and one compiled as a miss.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import os
import signal

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from paddle_tpu import sysconfig as jsys  # noqa: E402
from paddle_tpu.incubate import auto_checkpoint as jacp  # noqa: E402

from paddle_tpu_torch import preemption, set_flags, sysconfig  # noqa: E402
from paddle_tpu_torch import incubate  # noqa: E402
from paddle_tpu_torch.incubate import auto_checkpoint as acp  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.nn import Linear, ReLU, Sequential  # noqa: E402
from paddle_tpu_torch.optimizer import Adam  # noqa: E402
from paddle_tpu_torch.static import TrainStep  # noqa: E402


def _counted_run(mod, d, crash_at=None, start_steps=0):
    counter = {"steps": start_steps}
    r = mod.TrainEpochRange(max_epoch=5, save_dir=d, name="job")
    r.register("ctr", lambda: {"steps": np.int64(counter["steps"])},
               lambda s: counter.update(steps=int(s["steps"])))
    seen = []
    for epoch in r:
        counter["steps"] += 10
        seen.append(epoch)
        if epoch == crash_at:
            break  # epochs 0, 1 saved; epoch 2 never is
    r._ckpt.wait()
    return r, counter, seen


def test_epoch_resume_matches_jax(tmp_path):
    dirs = {}
    for name, mod in (("jax", jacp), ("port", acp)):
        d = str(tmp_path / name)
        _, _, seen = _counted_run(mod, d, crash_at=2)
        assert seen == [0, 1, 2]
        dirs[name] = sorted(os.listdir(os.path.join(d, "job")))
        r2, counter, rest = _counted_run(mod, d, start_steps=-1)
        assert r2.restored and r2.start_epoch == 2
        assert rest == [2, 3, 4]
        assert counter["steps"] == 50  # 20 restored + three epochs
    assert dirs["port"] == dirs["jax"]


def test_port_resumes_a_jax_range(tmp_path):
    d = str(tmp_path)
    _counted_run(jacp, d, crash_at=2)
    r, counter, rest = _counted_run(acp, d, start_steps=-1)
    assert r.start_epoch == 2 and rest == [2, 3, 4]
    assert counter["steps"] == 50


def test_requires_dir(monkeypatch):
    monkeypatch.delenv("PT_CHECKPOINT_DIR", raising=False)
    with pytest.raises(ValueError, match="save_dir"):
        acp.TrainEpochRange(max_epoch=1)
    assert incubate.train_epoch_range is acp.train_epoch_range
    assert set(acp.__all__) == set(jacp.__all__)


def _train_step(seed):
    torch.manual_seed(seed)
    net = Sequential(Linear(8, 16, device="cpu"), ReLU(),
                     Linear(16, 2, device="cpu"))
    return TrainStep(net, Adam(1e-2), torch.nn.functional.cross_entropy,
                     seed=0)


def _fit(step, d, epochs, x, y):
    r = acp.train_epoch_range(epochs, save_dir=d, name="run")
    r.register("train", step.state_dict, step.set_state_dict)
    for _ in r:
        for i in range(0, 32, 8):
            step(x[i:i + 8], labels=y[i:i + 8])
    return r


def test_train_step_resume_is_bit_for_bit(tmp_path):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (32, 8)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 2, (32,)))
    full = _train_step(0)
    _fit(full, str(tmp_path / "a"), 3, x, y)
    first = _train_step(0)
    _fit(first, str(tmp_path / "b"), 1, x, y)
    resumed = _train_step(1)  # another init: the restore brings it back
    r = _fit(resumed, str(tmp_path / "b"), 3, x, y)
    assert r.start_epoch == 1
    from paddle_tpu_torch import io
    a, b = io.flatten(full.state_dict()), io.flatten(resumed.state_dict())
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_sigterm_forces_a_checkpoint_and_reraises(tmp_path):
    d = str(tmp_path)
    seen = []
    with preemption.guard() as outer:
        r = acp.TrainEpochRange(max_epoch=5, save_dir=d, name="job",
                                save_interval=10)
        r.register("ctr", lambda: {"n": np.int64(len(seen))})
        with pytest.raises(preemption.PreemptedError):
            for epoch in r:
                seen.append(epoch)
                if epoch == 1:
                    os.kill(os.getpid(), signal.SIGTERM)
        assert outer.preempted
    assert seen == [0, 1]
    # off the interval, yet epoch 1's end was saved before the re-raise
    assert sorted(os.listdir(os.path.join(d, "job"))) == ["ckpt-2"]


def test_sysconfig_names_and_paths():
    assert set(sysconfig.__all__) == set(jsys.__all__)
    inc = sysconfig.get_include()
    assert os.path.isfile(os.path.join(inc, "ptnative.h"))
    lib = sysconfig.get_lib()
    assert os.path.isfile(os.path.join(lib, "libptnative.so"))


@pytest.fixture
def build_dir():
    saved = (_build.BUILD_DIR, dict(_build.cache_stats),
             sysconfig._FLAG_APPLIED_DIR)
    try:
        yield
    finally:
        set_flags({"compile_cache_dir": ""})
        _build.BUILD_DIR = saved[0]
        _build.cache_stats.clear()
        _build.cache_stats.update(saved[1])
        sysconfig._FLAG_APPLIED_DIR = saved[2]


def test_compile_cache_flag_points_the_kernel_build(tmp_path, build_dir,
                                                   monkeypatch):
    cache = tmp_path / "kernels"
    set_flags({"compile_cache_dir": str(cache)})  # applied at once
    assert _build.BUILD_DIR == cache and cache.is_dir()
    before = sysconfig.compile_cache_stats()
    # a library found built is a hit (no nvcc runs)
    target = _build._target("layer_norm")
    assert target.parent == cache
    target.write_bytes(b"")
    assert _build._start("layer_norm") is None
    # one not built is a miss: it compiles (here the compiler is absent)
    target.unlink()

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._start("layer_norm")
    after = sysconfig.compile_cache_stats()
    assert after == {"hits": before["hits"] + 1,
                     "misses": before["misses"] + 1}
    # the flag's value is applied once; enable_compile_cache moves it on
    sysconfig.apply_compile_cache_flag()
    assert _build.BUILD_DIR == cache
    sysconfig.enable_compile_cache(str(tmp_path / "other"))
    assert _build.BUILD_DIR == tmp_path / "other"
