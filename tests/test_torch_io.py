"""PyTorch port: checkpoint v3 (``paddle_tpu_torch.io``), the train
step's checkpointable state and preemption, against the JAX package on
the CPU.

- Cross-loading: a JAX ``TrainStep`` trains 3 steps and saves its state
  with ``paddle_tpu.io.save``; the port restores it
  (``TrainStep.set_state_dict(io.load(path))``) and both packages run 2
  more steps from there. The reverse: a port checkpoint is loaded by
  ``paddle_tpu.io.load(path, target=jax_step.state)`` and JAX continues
  beside the port. In fp32 per leaf and under ``fused_state``, held to
  the ten-step trajectory test's fp32 limits (``tests/test_torch_bert.py``:
  losses within 1e-5, parameters within 1e-5, the key-projection bias
  aside). With bf16 parameters and fp32 masters the run goes on for 7
  steps after the checkpoint, to the ten steps on which the bf16 bounds
  of ``tests/test_torch_train_bf16.py`` were set: losses within 2e-2
  relative, the median master entry of every leaf within 5% of the
  largest entry of its change since step 0, at most 2% of the entries
  beyond.
- Port-to-port resume with dropout 0.1, bit for bit: the run stopped at
  step 3, saved, rebuilt from scratch and restored equals the
  uninterrupted run in every loss, parameter, master, moment and the
  generator.
- Format and integrity: the two packages' manifests list the same
  leaves with the same shapes and dtypes (the port's ``generator`` in
  place of JAX's ``rng``), each package's ``verify`` accepts the other's
  checkpoint, and the port's own counterparts of the ``paddle_tpu.io``
  tests of ``tests/test_fault_tolerance.py``; the preemption guard.

A small BERT (2 layers, hidden 64, 2 heads, vocab 512, seq 32).
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import json
import os
import signal
import threading
import time
import zlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as pt  # noqa: E402
from paddle_tpu import io as jax_io  # noqa: E402
from paddle_tpu.models import BertConfig as JaxBertConfig  # noqa: E402
from paddle_tpu.models import BertForPretraining as JaxBert  # noqa: E402
from paddle_tpu.models import pretraining_loss as jax_pretraining_loss  # noqa: E402,E501
from paddle_tpu.optimizer import AdamW as JaxAdamW  # noqa: E402
from paddle_tpu.static import TrainStep as JaxTrainStep  # noqa: E402

from paddle_tpu_torch import amp, convert, io, preemption  # noqa: E402
from paddle_tpu_torch import set_flags  # noqa: E402
from paddle_tpu_torch.convert import load_jax_params  # noqa: E402
from paddle_tpu_torch.models import (BertConfig,  # noqa: E402
                                     BertForPretraining, pretraining_loss)
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402
from paddle_tpu_torch.static import TrainStep  # noqa: E402
from paddle_tpu_torch.static import seed_from_key_bits  # noqa: E402

SMALL = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=128,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             max_position_embeddings=64)
DROPOUT = dict(SMALL, hidden_dropout_prob=0.1,
               attention_probs_dropout_prob=0.1)
B, T, P = 2, 32, 6
OPT = dict(learning_rate=1e-3, weight_decay=0.01)
# fp32 (tests/test_torch_bert.py's ten-step trajectory limits)
LOSS_TOL = 1e-5
PARAM_TOL = 1e-5
# bf16 (tests/test_torch_train_bf16.py's bounds)
LOSS_RTOL = 2e-2
MASTER_TOL = 0.05
OUTLIER_SHARE = 0.02


def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (B, T)).astype(np.int32)
    types = rng.integers(0, 2, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, 24:] = 0
    pos = np.sort(rng.permuted(np.broadcast_to(np.arange(T), (B, T)),
                               axis=1)[:, :P], axis=1).astype(np.int32)
    mlm = rng.integers(0, 512, (B, P)).astype(np.int64)
    mlm[0, 1] = -100
    nsp = rng.integers(0, 2, (B,)).astype(np.int64)
    return ids, types, mask, pos, mlm, nsp


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _jax_step_on(jstep, i):
    ids, types, mask, pos, mlm, nsp = _batch(i)
    return float(jstep(jnp.asarray(ids), jnp.asarray(types),
                       jnp.asarray(mask), jnp.asarray(pos),
                       labels=(jnp.asarray(mlm), jnp.asarray(nsp)))["loss"])


def _port_step_on(pstep, i):
    ids, types, mask, pos, mlm, nsp = _batch(i)
    return float(pstep(_t(ids), _t(types), _t(mask), _t(pos),
                       labels=(_t(mlm), _t(nsp)))["loss"])


def _jax_pair(dtype, fused_state):
    """A JAX model and step, and a port model (random weights of its own)
    and step of the same configuration."""
    pt.seed(0)
    jm = JaxBert(JaxBertConfig(**SMALL))
    pm = BertForPretraining(BertConfig(**SMALL), device="cpu", seed=5)
    if dtype == "bfloat16":
        jm.to(dtype="bfloat16")
        pm = amp.cast_model_to_low_precision(pm, "bfloat16")
    jstep = JaxTrainStep(jm, JaxAdamW(fused_state=fused_state, **OPT),
                         lambda out, m, n: jax_pretraining_loss(out, m, n))
    pstep = TrainStep(pm, AdamW(fused_state=fused_state, **OPT),
                      pretraining_loss)
    return jstep, pstep


def _jax_params(jstep):
    return {k: np.asarray(v, np.float32)
            for k, v in jstep.state["params"].items()}


def _masters(state, names):
    """fp32 masters by name from either package's optimizer state."""
    if "fused" in state:
        flat = np.asarray(state["fused"]["master"], np.float32)
        out, off = {}, 0
        for n in sorted(names):
            k = int(np.prod(names[n]))
            out[n] = flat[off:off + k].reshape(names[n])
            off += k
        return out
    return {n: np.asarray(s["master"], np.float32)
            for n, s in state["slots"].items()}


def _port_opt_numpy(pstep):
    return {"step": pstep.state["step"].numpy(),
            "slots": {n: {k: t.float().numpy() for k, t in s.items()}
                      for n, s in pstep.state["slots"].items()},
            **({"fused": {k: t.numpy() for k, t in
                          pstep.state["fused"].items()}}
               if "fused" in pstep.state else {})}


def _hold(jstep, pstep, jl, pl, dtype, start):
    """The port's steps against JAX's from the same checkpoint."""
    jl, pl = np.array(jl), np.array(pl)
    assert np.all(np.isfinite(pl))
    jp = _jax_params(jstep)
    own = {n: p.detach().float().numpy() for n, p in
           pstep.model.named_parameters()}
    assert set(jp) == set(own)
    if dtype == "float32":
        assert np.max(np.abs(pl - jl)) <= LOSS_TOL, (pl, jl)
        for n, v in jp.items():
            if n.endswith("k_proj.bias"):
                continue  # an exactly-zero gradient: both step on noise
            assert np.max(np.abs(own[n] - v)) <= PARAM_TOL, n
        return
    assert np.max(np.abs(pl - jl) / np.abs(jl)) <= LOSS_RTOL, (pl, jl)
    shapes = {n: v.shape for n, v in jp.items()}
    jm_ = _masters(jstep.state["opt"], shapes)
    pm_ = _masters(_port_opt_numpy(pstep), shapes)
    outliers = total = 0
    for n in shapes:
        if n.endswith("k_proj.bias"):
            continue
        change = np.max(np.abs(jm_[n] - start[n]))
        gap = np.abs(pm_[n] - jm_[n]) / change
        assert np.median(gap) <= MASTER_TOL, (n, np.median(gap))
        outliers += int(np.sum(gap > MASTER_TOL))
        total += gap.size
    assert outliers <= OUTLIER_SHARE * total, (outliers, total)


def _after(dtype):
    """The steps both packages run after the checkpoint at step 3."""
    return range(3, 5 if dtype == "float32" else 10)


KINDS = [("float32", False), ("float32", True), ("bfloat16", False),
         ("bfloat16", True)]


# -- cross-loading ---------------------------------------------------------

@pytest.mark.parametrize("dtype,fused_state", KINDS)
def test_a_jax_checkpoint_resumes_in_the_port(tmp_path, dtype, fused_state):
    jstep, pstep = _jax_pair(dtype, fused_state)
    start = _jax_params(jstep)
    for i in range(3):
        _jax_step_on(jstep, i)
    path = str(tmp_path / "jax_ckpt")
    jax_io.save(jstep.state, path, step=3,
                host_state={"global_step": 3, "epoch": 0,
                            "batch_in_epoch": 3})
    assert io.verify(path) == []
    assert io.load_host_state(path)["global_step"] == 3
    flat = io.load(path)
    assert flat["rng"].dtype == torch.uint32
    pstep.set_state_dict(flat)
    # the generator is seeded from the key's bits by the documented rule
    want = torch.Generator().manual_seed(seed_from_key_bits(
        np.asarray(jax.random.key_data(jstep.state["rng"]))))
    assert torch.equal(pstep.generator.get_state(), want.get_state())
    assert int(pstep.state["step"]) == 3
    jl = [_jax_step_on(jstep, i) for i in _after(dtype)]
    pl = [_port_step_on(pstep, i) for i in _after(dtype)]
    _hold(jstep, pstep, jl, pl, dtype, start)


@pytest.mark.parametrize("dtype,fused_state", KINDS)
def test_a_port_checkpoint_continues_in_jax(tmp_path, dtype, fused_state):
    jstep, pstep = _jax_pair(dtype, fused_state)
    start = {n: p.detach().float().numpy().copy()
             for n, p in pstep.model.named_parameters()}
    for i in range(3):
        _port_step_on(pstep, i)
    path = str(tmp_path / "port_ckpt")
    io.save(pstep.state_dict(), path, step=3)
    assert jax_io.verify(path) == []
    rng = jstep.state["rng"]
    jstep.state = jax_io.load(path, target=jstep.state)
    # the port's generator leaf is not JAX's: the JAX step keeps its key
    assert np.array_equal(jax.random.key_data(jstep.state["rng"]),
                          jax.random.key_data(rng))
    assert int(jstep.state["opt"]["step"]) == 3
    jl = [_jax_step_on(jstep, i) for i in _after(dtype)]
    pl = [_port_step_on(pstep, i) for i in _after(dtype)]
    _hold(jstep, pstep, jl, pl, dtype, start)


@pytest.mark.parametrize("fused_state", [False, True])
def test_the_whole_state_crosses_in_memory(fused_state):
    # convert.train_state_from_jax / train_state_to_jax, without a file
    jstep, pstep = _jax_pair("bfloat16", fused_state)
    for i in range(2):
        _jax_step_on(jstep, i)
    tree = jax.tree.map(np.asarray, {**jstep.state, "rng": jax.random
                                     .key_data(jstep.state["rng"])})
    pstep.set_state_dict(convert.train_state_from_jax(tree))
    back = convert.train_state_to_jax(pstep.state_dict())
    assert "generator" not in back and set(back) == {"params", "buffers",
                                                     "opt"}
    for (path, a), (path2, b) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(
                {k: jstep.state[k] for k in back})[0]):
        assert path == path2
        assert a.dtype == np.asarray(b).dtype, path
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), path


def test_set_state_dict_names_what_does_not_fit(tmp_path):
    _, pstep = _jax_pair("float32", False)
    tree = pstep.state_dict()
    bad = {**io.flatten(tree)}
    del bad["opt/step"]
    bad["params/extra"] = torch.zeros(2)
    name = "bert.pooler.bias"
    bad[f"params/{name}"] = torch.zeros(3)
    with pytest.raises(ValueError) as ei:
        pstep.set_state_dict(bad)
    msg = str(ei.value)
    assert "opt/step" in msg and "params/extra" in msg and name in msg


# -- port-to-port resume, bit for bit --------------------------------------

def _port_run(seed_model=0):
    model = BertForPretraining(BertConfig(**DROPOUT), device="cpu",
                               seed=seed_model)
    return TrainStep(model, AdamW(fused_state=True, **OPT),
                     pretraining_loss, seed=7)


def test_port_resume_is_bit_for_bit_with_dropout(tmp_path):
    whole = _port_run()
    want = [_port_step_on(whole, i) for i in range(5)]

    first = _port_run()
    got = [_port_step_on(first, i) for i in range(3)]
    ck = io.AsyncCheckpointer(str(tmp_path / "ck"))
    at_save = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
               for k, v in io.flatten(first.state_dict()).items()}
    ck.save(first.state_dict(), step=3,
            host_state={"global_step": 3, "epoch": 0, "batch_in_epoch": 3})
    # the next step runs at once, while the writer works, and rewrites
    # the tensors the save reads in place
    got.append(_port_step_on(first, 3))
    ck.wait()
    saved = io.load(str(tmp_path / "ck" / "ckpt-3"))
    assert set(saved) == set(at_save)
    for k, v in at_save.items():
        assert torch.equal(saved[k], v), k  # not torn by step 4

    # a fresh process: model, step and checkpointer built anew
    resumed = _port_run(seed_model=11)
    ck2 = io.AsyncCheckpointer(str(tmp_path / "ck"))
    flat, at = ck2.restore_latest()
    assert at == 3 and ck2.host_state()["batch_in_epoch"] == 3
    resumed.set_state_dict(flat)
    got_resumed = [_port_step_on(resumed, i) for i in (3, 4)]
    assert got[3] == want[3] and got[:3] == want[:3]
    assert got_resumed == want[3:]
    a, b = io.flatten(whole.state_dict()), io.flatten(resumed.state_dict())
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_restore_writes_in_place():
    # a captured graph reads fixed addresses: a restore must not swap
    # tensors under it
    src, dst = _port_run(), _port_run(seed_model=3)
    _port_step_on(src, 0)
    before = {k: t.data_ptr() for k, t in io.flatten(
        dst.state_dict()).items() if k != "generator"}
    dst.set_state_dict(src.state_dict())
    after = io.flatten(dst.state_dict())
    assert {k: after[k].data_ptr() for k in before} == before
    for k, t in io.flatten(src.state_dict()).items():
        assert torch.equal(after[k], t), k


# -- format ---------------------------------------------------------------

@pytest.mark.parametrize("dtype,fused_state", KINDS)
def test_manifests_list_the_same_leaves_and_verify_crosses(tmp_path, dtype,
                                                          fused_state):
    jstep, pstep = _jax_pair(dtype, fused_state)
    jax_io.save(jstep.state, str(tmp_path / "j"), step=0)
    io.save(pstep.state_dict(), str(tmp_path / "p"), step=0)

    def leaves(name):
        with open(tmp_path / name / "manifest.json") as f:
            m = json.load(f)
        assert m["__paddle_tpu_ckpt__"] == 3
        return {k: (v["shape"], v["dtype"]) for k, v in m["leaves"].items()}

    j, p = leaves("j"), leaves("p")
    assert j.pop("rng")[1].startswith("prng_key:")
    assert p.pop("generator")[1] == "uint8"
    assert j == p
    if dtype == "bfloat16":
        assert {d for _, d in p.values()} >= {"bfloat16", "float32",
                                              "int32"}
    assert list(j) == list(p)  # the same flatten order
    assert jax_io.verify(str(tmp_path / "p")) == []
    assert io.verify(str(tmp_path / "j")) == []


def test_bf16_and_key_leaves_round_trip(tmp_path):
    x = torch.randn(5, 7).to(torch.bfloat16)
    io.save({"w": x, "n": 3}, str(tmp_path / "a"))
    flat = io.load(str(tmp_path / "a"))
    assert flat["w"].dtype == torch.bfloat16 and torch.equal(flat["w"], x)
    assert flat["n"].dtype == torch.int64 and int(flat["n"]) == 3
    jflat = jax_io.load(str(tmp_path / "a"))
    assert str(jflat["w"].dtype) == "bfloat16"
    assert np.array_equal(jflat["w"].view(np.uint16),
                          x.view(torch.int16).numpy().view(np.uint16))
    jax_io.save({"rng": jax.random.key(5)}, str(tmp_path / "k"))
    bits = io.load(str(tmp_path / "k"))["rng"]
    assert bits.dtype == torch.uint32 and bits.tolist() == [0, 5]
    assert seed_from_key_bits(bits) == 5


def test_load_with_target_keeps_the_structure_and_missing_leaves(tmp_path):
    tree = {"a": torch.ones(2), "b": [torch.zeros(3), torch.ones(1)]}
    io.save({"a": torch.full((2,), 2.0), "b": [torch.full((3,), 3.0)]},
            str(tmp_path / "c"))
    got = io.load(str(tmp_path / "c"), target=tree)
    assert isinstance(got["b"], list)
    assert torch.equal(got["a"], torch.full((2,), 2.0))
    assert torch.equal(got["b"][0], torch.full((3,), 3.0))
    assert got["b"][1] is tree["b"][1]


def test_save_dygraph_round_trip(tmp_path):
    sd = {"w": torch.arange(6.0).reshape(2, 3)}
    io.save_dygraph(sd, str(tmp_path / "m"))
    assert os.path.isdir(str(tmp_path / "m.pdparams"))
    got, opt = io.load_dygraph(str(tmp_path / "m"))
    assert opt is None and torch.equal(got["w"], sd["w"])


# -- integrity (the port's counterparts of tests/test_fault_tolerance.py) --

def _save_one(tmp_path, step=1):
    path = str(tmp_path / f"ckpt-{step}")
    io.save({"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "b": torch.ones(3, dtype=torch.float64)}, path, step=step)
    return path


def test_save_writes_integrity_format(tmp_path):
    path = _save_one(tmp_path)
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["__paddle_tpu_ckpt__"] == 3
    for meta in manifest["leaves"].values():
        assert meta["nbytes"] > 0 and "crc32" in meta
    commit = json.load(open(os.path.join(path, "COMMIT")))
    with open(os.path.join(path, "manifest.json"), "rb") as f:
        assert commit["manifest_crc32"] == zlib.crc32(f.read())
    assert io.verify(path) == []
    assert io.is_committed(path)
    assert sorted(os.listdir(os.path.join(path, "data"))) == ["b.npy",
                                                              "w.npy"]


def test_load_missing_leaf_names_checkpoint_and_leaf(tmp_path):
    path = _save_one(tmp_path)
    os.remove(os.path.join(path, "data", "w.npy"))
    with pytest.raises(ValueError) as ei:
        io.load(path)
    msg = str(ei.value)
    assert path in msg and "'w'" in msg and "verify" in msg


def test_load_size_mismatch_detected_even_unverified(tmp_path):
    path = _save_one(tmp_path)
    with open(os.path.join(path, "data", "w.npy"), "ab") as f:
        f.write(b"xx")
    with pytest.raises(ValueError, match="bytes on disk"):
        io.load(path, verify_integrity=False)


def test_load_crc_corruption_and_opt_out(tmp_path):
    path = _save_one(tmp_path)
    fpath = os.path.join(path, "data", "w.npy")
    raw = open(fpath, "rb").read()
    with open(fpath, "wb") as f:  # same size, flipped last byte
        f.write(raw[:-1] + bytes([raw[-1] ^ 0xFF]))
    with pytest.raises(ValueError, match="CRC32"):
        io.load(path)
    assert io.load(path, verify_integrity=False)["w"].shape == (2, 3)
    set_flags({"checkpoint_verify": False})
    try:
        io.load(path)
    finally:
        set_flags({"checkpoint_verify": True})
    with pytest.raises(ValueError, match="CRC32"):
        io.load(path)
    assert any("CRC32" in p for p in io.verify(path))


def test_uncommitted_checkpoint_skipped_with_fallback(tmp_path):
    ck = io.AsyncCheckpointer(str(tmp_path / "ck"))
    for s in (1, 2):
        ck.save({"w": torch.ones(3) * s}, step=s)
        ck.wait()
    os.remove(str(tmp_path / "ck" / "ckpt-2" / "COMMIT"))
    assert ck.latest_step() == 1 and ck.intact_steps() == [1]
    state, step = ck.restore_latest()
    assert step == 1 and torch.equal(state["w"], torch.ones(3))
    assert ck.verify(2)


def test_corrupt_leaf_restore_falls_back_one_step(tmp_path):
    ck = io.AsyncCheckpointer(str(tmp_path / "ck"))
    for s in (2, 4):
        ck.save({"w": torch.full((3,), float(s))}, step=s)
        ck.wait()
    leaf = str(tmp_path / "ck" / "ckpt-4" / "data" / "w.npy")
    raw = open(leaf, "rb").read()
    with open(leaf, "wb") as f:
        f.write(raw[:-1] + bytes([raw[-1] ^ 0x55]))
    state, step = ck.restore_latest()
    assert step == 2 and torch.equal(state["w"], torch.full((3,), 2.0))
    assert ck.verify(4)
    assert ck.restore(step=2)["w"][0] == 2.0


def test_async_writer_failure_surfaces_at_next_wait(tmp_path, monkeypatch):
    real = io._write
    fail = {"n": 1}

    def flaky(*a, **k):
        if fail["n"]:
            fail["n"] -= 1
            raise OSError("disk full")
        return real(*a, **k)

    monkeypatch.setattr(io, "_write", flaky)
    ck = io.AsyncCheckpointer(str(tmp_path / "ck"))
    ck.save({"w": torch.ones(2)}, step=1)
    with pytest.raises(RuntimeError, match="background checkpoint"):
        ck.wait()
    # the error is consumed: the next save works
    ck.save({"w": torch.ones(2)}, step=2)
    ck.wait()
    assert ck.latest_step() == 2


def test_async_failure_also_surfaces_at_the_next_save(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(io, "_write", lambda *a, **k: 1 / 0)
    ck = io.AsyncCheckpointer(str(tmp_path / "ck"))
    ck.save({"w": torch.ones(2)}, step=1)
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        ck.save({"w": torch.ones(2)}, step=2)


def test_v1_checkpoint_still_loads(tmp_path):
    path = _save_one(tmp_path)
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    manifest["__paddle_tpu_ckpt__"] = 1
    for meta in manifest["leaves"].values():
        meta.pop("crc32"), meta.pop("nbytes")
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    os.remove(os.path.join(path, "COMMIT"))
    assert io.is_committed(path)
    assert io.load(path)["w"].shape == (2, 3)
    assert io.verify(path) == []


def test_max_to_keep_and_stale_staging_dirs(tmp_path):
    d = tmp_path / "ck"
    ck = io.AsyncCheckpointer(str(d), max_to_keep=2)
    os.makedirs(d / "ckpt-9.tmp")  # a crashed save's leftover
    for s in (1, 2, 3):
        ck.save({"w": torch.ones(1) * s}, step=s, host_state={"s": s})
    ck.wait()
    # no save in flight: a listing reaps the leftover
    assert ck.latest_step() == 3
    assert sorted(os.listdir(d)) == ["ckpt-2", "ckpt-3"]
    assert ck.host_state() == {"s": 3} and ck.host_state(2) == {"s": 2}
    assert io.load_step(str(d / "ckpt-3")) == 3


def test_a_non_checkpoint_directory_is_refused(tmp_path):
    os.makedirs(tmp_path / "x")
    with open(tmp_path / "x" / "manifest.json", "w") as f:
        json.dump({"leaves": {}}, f)
    with pytest.raises(ValueError, match="not a paddle_tpu checkpoint"):
        io.load(str(tmp_path / "x"))
    assert not io.is_committed(str(tmp_path / "x"))
    assert io.verify(str(tmp_path / "nothing")) != []


# -- preemption ------------------------------------------------------------

def test_preemption_guard_catches_sigterm_without_dying():
    with preemption.guard() as g:
        assert g.active and not g.preempted
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 2
        while not g.preempted and time.time() < deadline:
            time.sleep(0.01)
        assert g.preempted and g.signum == int(signal.SIGTERM)
    assert signal.getsignal(signal.SIGTERM) != g._handler


def test_preemption_guard_inert_off_main_thread():
    out = {}

    def worker():
        with preemption.guard() as g:
            out["active"] = g.active
            out["preempted"] = g.preempted

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=10)
    assert out == {"active": False, "preempted": False}


def test_preemption_reraise_unwinds_through_an_outer_guard():
    with preemption.guard() as outer:
        with preemption.guard() as inner:
            os.kill(os.getpid(), signal.SIGTERM)
            deadline = time.time() + 2
            while not inner.preempted and time.time() < deadline:
                time.sleep(0.01)
            with pytest.raises(preemption.PreemptedError):
                inner.reraise()  # the outer guard catches the re-delivery
        deadline = time.time() + 2
        while not outer.preempted and time.time() < deadline:
            time.sleep(0.01)
        assert outer.preempted
