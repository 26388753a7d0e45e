"""PyTorch port: the rest of the core (places, LoD, initializers,
ParamAttr, ``Layer``, the flag registry, the staging arena's budget and
the replayed random draws) against the JAX package on the CPU."""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as pt  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.core import lod as jlod  # noqa: E402
from paddle_tpu.core import place as jplace  # noqa: E402
from paddle_tpu.nn import initializer as JI  # noqa: E402
from paddle_tpu.nn.layer import functional_call as jax_call  # noqa: E402
from paddle_tpu.optimizer import Adam as JaxAdam  # noqa: E402
from paddle_tpu.param_attr import ParamAttr as JaxParamAttr  # noqa: E402
from paddle_tpu.regularizer import L2Decay as JaxL2Decay  # noqa: E402
from paddle_tpu.static import TrainStep as JaxTrainStep  # noqa: E402

from paddle_tpu_torch import clip, get_flags, nn, set_flags  # noqa: E402
from paddle_tpu_torch.convert import load_jax_params  # noqa: E402
from paddle_tpu_torch.core import lod, place  # noqa: E402
from paddle_tpu_torch.core import random as prandom  # noqa: E402
from paddle_tpu_torch.core.arena import HostStagingArena  # noqa: E402
from paddle_tpu_torch.flags import GLOBAL_FLAGS  # noqa: E402
from paddle_tpu_torch.nn import initializer as I  # noqa: E402
from paddle_tpu_torch.optimizer import Adam  # noqa: E402
from paddle_tpu_torch.param_attr import ParamAttr  # noqa: E402
from paddle_tpu_torch.regularizer import L2Decay  # noqa: E402
from paddle_tpu_torch.static import TrainStep  # noqa: E402

jax_clip = importlib.import_module("paddle_tpu.clip")
ROOT = Path(__file__).resolve().parent.parent

# the JAX flags the port defined when their readers came (ROADMAP A): the
# ResNet path's three came with it, straggler_factor with the straggler
# detector, check_nan_inf and matmul_precision with the static Executor
# and ops.math, compile_cache_dir with sysconfig; none waits now
WAITING_FLAGS = set()


def test_flag_registry_is_the_jax_one_but_seven():
    jax_names = set(pt.flags.GLOBAL_FLAGS.names())
    port_names = set(GLOBAL_FLAGS._specs)
    assert port_names == jax_names - WAITING_FLAGS
    for name in ("selected_devices", "eager_delete_tensor_gb",
                 "transformer_remat", "attention_bthd_layout",
                 "use_fast_rng", "use_pallas_kernels",
                 "use_pallas_layer_norm", "flash_block_q", "flash_block_k",
                 "deterministic", "log_level", "io_threadpool_size",
                 "fuse_parameter_groups_size", "batch_norm_single_pass",
                 "resnet_block_remat", "resnet_space_to_depth_stem"):
        # the registered defaults, not the live values: a JAX test may
        # leave its flag set (tests/test_ops_extra.py leaves
        # batch_norm_single_pass at False) before this one runs on the
        # same worker
        assert GLOBAL_FLAGS._specs[name].default \
            == pt.flags.GLOBAL_FLAGS._specs[name].default, name
    assert prandom.fast_rng_enabled() is True


def test_places_and_device_selection():
    assert place.CPUPlace(0) == place.CPUPlace(0) != place.CUDAPlace(0)
    assert repr(place.CUDAPlace(1)) == "CUDAPlace(1)"
    assert len({place.CPUPlace(0), place.CPUPlace(0)}) == 1
    assert {type(p).__name__ for p in (jplace.CPUPlace(0),
                                       place.CPUPlace(0))} == {"CPUPlace"}
    assert isinstance(place.is_compiled_with_cuda(), bool)
    assert place.accelerator_available() == torch.cuda.is_available()
    old = get_flags("selected_devices")
    try:
        set_flags({"selected_devices": "0,2"})
        assert place.device_count() == 2
        assert place.CUDAPlace(1).torch_device() == torch.device("cuda", 2)
    finally:
        set_flags(old)
    assert place.device_count() == torch.cuda.device_count()
    if not torch.cuda.is_available():
        assert place.local_devices() == [torch.device("cpu")]
        assert place.get_device() == place.CPUPlace(0) or \
            place._current_place is not None
        with pytest.raises(RuntimeError, match="no CUDA device"):
            place.set_device("gpu:0")
    saved = place._current_place
    try:
        assert place.set_device("cpu") == place.CPUPlace(0)
        assert place.get_device() == place.CPUPlace(0)
        # a device of None now means the CPU
        assert place.resolve_device(None) == torch.device("cpu")
        assert place.resolve_device(place.CPUPlace(0)).type == "cpu"
        with pytest.raises(ValueError, match="unknown device"):
            place.set_device("tpu9")
    finally:
        place._current_place = saved


def test_lod_matches_jax():
    seqs = [[1, 2, 3], [4], [5, 6]]
    for mod in (jlod, lod):
        assert mod.create_lod_tensor(seqs, [[3, 1, 2]]).lengths.tolist() \
            == [3, 1, 2]
    a = lod.create_lod_tensor(np.arange(12).reshape(6, 2), [[2, 1], [3, 1,
                                                                     2]])
    b = jlod.create_lod_tensor(np.arange(12).reshape(6, 2), [[2, 1], [3, 1,
                                                                      2]])
    np.testing.assert_array_equal(a.data, b.data)
    assert a.recursive_seq_lens() == b.recursive_seq_lens()
    np.testing.assert_array_equal(a.flat(), b.flat())
    np.testing.assert_array_equal(a.regroup_outer().data,
                                  b.regroup_outer().data)
    r1 = lod.create_random_int_lodtensor([[2, 3]], [4], low=1, high=5,
                                         seed=3)
    r2 = jlod.create_random_int_lodtensor([[2, 3]], [4], low=1, high=5,
                                          seed=3)
    np.testing.assert_array_equal(r1.data, r2.data)
    assert r1.data.dtype == np.int64 and r1.data.max() <= 5
    with pytest.raises(ValueError, match="innermost lengths"):
        lod.create_lod_tensor(np.zeros((4, 1)), [[2, 3]])


def test_initializers_shapes_constants_and_moments():
    shape = (400, 300)
    gen = torch.Generator().manual_seed(0)
    kw = dict(device="cpu", generator=gen)
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert np.array_equal(I.Assign(w)((2, 3), **kw).numpy(),
                          np.asarray(JI.Assign(w)((2, 3))))
    assert np.array_equal(I.Constant(0.25)((3,), **kw).numpy(),
                          np.asarray(JI.Constant(0.25)((3,))))
    assert np.allclose(I.Bilinear()((2, 2, 4, 4), **kw).numpy(),
                       np.asarray(JI.Bilinear()((2, 2, 4, 4))))
    lim = np.sqrt(6.0 / sum(shape))
    x = I.XavierUniform()(shape, **kw)
    assert x.shape == shape and float(x.abs().max()) <= lim
    assert abs(float(x.std()) - lim / np.sqrt(3)) < 0.02 * lim
    x = I.XavierNormal()(shape, **kw)
    assert abs(float(x.std()) - np.sqrt(2.0 / sum(shape))) < 0.01 * float(
        x.std())
    x = I.Normal(1.0, 2.0)(shape, **kw)
    assert abs(float(x.mean()) - 1.0) < 0.02 and abs(
        float(x.std()) - 2.0) < 0.02
    x = I.TruncatedNormal(0.0, 3.0)(shape, **kw)
    jx = np.asarray(JI.TruncatedNormal(0.0, 3.0)(shape))
    assert float(x.abs().max()) <= 6.0 + 1e-5
    assert abs(float(x.std()) - jx.std()) < 0.03
    x = I.KaimingUniform()(shape, **kw)
    assert float(x.abs().max()) <= np.sqrt(2.0) * np.sqrt(3.0 / 400)
    x = I.Orthogonal()((6, 4), **kw)
    assert torch.allclose(x.T @ x, torch.eye(4), atol=1e-5)
    with pytest.raises(ValueError, match="Assign init shape"):
        I.Assign(w)((3, 2), **kw)


def _attr_nets(w1, w2):
    jnet = jnn.Sequential(
        jnn.Linear(6, 4, weight_attr=JaxParamAttr(
            initializer=JI.Assign(w1), regularizer=JaxL2Decay(0.5),
            need_clip=False), bias_attr=JaxParamAttr(
                initializer=JI.Constant(0.3))),
        jnn.Linear(4, 3, weight_attr=JaxParamAttr(
            initializer=JI.Assign(w2), trainable=False), bias_attr=False))
    pnet = nn.Sequential(
        nn.Linear(6, 4, weight_attr=ParamAttr(
            initializer=I.Assign(w1), regularizer=L2Decay(0.5),
            need_clip=False), bias_attr=ParamAttr(
                initializer=I.Constant(0.3)), device="cpu"),
        nn.Linear(4, 3, weight_attr=ParamAttr(
            initializer=I.Assign(w2), trainable=False), bias_attr=False,
            device="cpu"))
    return jnet, pnet


def test_param_attr_reaches_the_optimizer_as_in_jax():
    rng = np.random.default_rng(0)
    w1 = rng.standard_normal((6, 4)).astype(np.float32)
    w2 = rng.standard_normal((4, 3)).astype(np.float32)
    jnet, pnet = _attr_nets(w1, w2)
    frozen = pnet[1].weight
    assert not frozen.requires_grad and pnet[1].bias is None
    assert pnet[0].weight.regularizer.coeff == 0.5
    assert pnet[0].weight.need_clip is False
    assert float(pnet[0].bias.detach()[0]) == pytest.approx(0.3)
    assert set(jnet.param_dict()) == {"0.weight", "0.bias"}
    jstep = JaxTrainStep(jnet, JaxAdam(
        1e-2, grad_clip=jax_clip.ClipGradByGlobalNorm(0.01)),
        lambda out, y: jnp.mean((out - y) ** 2))
    pstep = TrainStep(pnet, Adam(
        1e-2, grad_clip=clip.ClipGradByGlobalNorm(0.01)),
        lambda out, y: ((out - y) ** 2).mean())
    assert set(pstep.params) == {"0.weight", "0.bias"}
    for i in range(3):
        x = rng.standard_normal((5, 6)).astype(np.float32)
        y = rng.standard_normal((5, 3)).astype(np.float32)
        jl = float(jstep(jnp.asarray(x), labels=(jnp.asarray(y),))["loss"])
        pl = float(pstep(torch.from_numpy(x),
                         labels=(torch.from_numpy(y),))["loss"])
        assert abs(jl - pl) <= 1e-5
    jstep.sync_to_model()
    own = dict(pnet.named_parameters())
    for name, v in jnet.state_dict().items():
        assert np.max(np.abs(own[name].detach().numpy()
                             - np.asarray(v))) <= 1e-5, name
    assert np.array_equal(frozen.detach().numpy(), w2)


def test_layer_names_state_and_hooks_match_jax():
    kw = dict(d_model=16, nhead=2, num_encoder_layers=1,
              num_decoder_layers=1, dim_feedforward=32, dropout=0.0,
              normalize_before=True)
    pt.seed(0)
    jm = jnn.Transformer(**kw)
    pm = nn.Transformer(**kw, device="cpu")
    assert list(pm.param_dict()) == list(jm.param_dict())
    assert [n for n, _ in pm.named_sublayers()] == \
        [n for n, _ in jm.named_sublayers()]
    assert list(pm.state_dict()) == list(jm.state_dict())
    assert pm.buffer_dict() == {}
    pm.set_state_dict({k: np.asarray(v) for k, v in
                       jm.state_dict().items()})
    for k, v in jm.state_dict().items():
        assert np.array_equal(pm.state_dict()[k].numpy(), np.asarray(v))
    with pytest.raises(KeyError, match="nope"):
        pm.set_state_dict({"nope": np.zeros(1)})
    pm.set_state_dict({"nope": np.zeros(1)}, strict=False)
    # torch's own state_dict arguments still reach torch
    assert set(pm.state_dict(prefix="m.")) == {f"m.{k}" for k in
                                               jm.state_dict()}
    src = torch.randn(2, 5, 16)
    tgt = torch.randn(2, 3, 16)
    base = pm(src, tgt)
    h1 = pm.register_forward_pre_hook(lambda layer, args: (args[0] * 0.0,
                                                           args[1]))
    h2 = pm.register_forward_post_hook(lambda layer, args, out: out + 1.0)
    hooked = pm(src, tgt)
    assert torch.allclose(hooked, pm(torch.zeros_like(src), tgt))
    h1.remove()
    h2.remove()
    assert torch.equal(pm(src, tgt), base)
    # to(dtype) casts the parameters only, as the JAX Layer.to does
    ln = nn.LayerNorm(4, weight_attr=False, device="cpu")
    assert "weight" not in dict(ln.named_parameters())
    ln.to("bfloat16")
    assert ln.bias.dtype == torch.bfloat16 and ln.weight.dtype == \
        torch.float32
    ln.astype(torch.float32)
    assert ln.bias.dtype == torch.float32
    assert ln.to("cpu") is ln


def test_layer_list_parameter_list_and_functional_call():
    layers = nn.LayerList([nn.Linear(3, 3, device="cpu") for _ in range(2)])
    assert [n for n, _ in layers.named_parameters()][:2] == ["0.weight",
                                                             "0.bias"]
    assert isinstance(layers, nn.Layer) and len(layers) == 2
    plist = nn.ParameterList([torch.zeros(2), torch.ones(3)])
    assert list(plist.param_dict()) == ["0", "1"]
    assert plist[1].shape == (3,)
    pt.seed(0)
    jl = jnn.Linear(4, 2)
    pl = nn.Linear(4, 2, device="cpu")
    load_jax_params(pl, {k: np.asarray(v) for k, v in
                         jl.param_dict().items()})
    w = np.full((4, 2), 0.5, np.float32)
    x = np.arange(8, dtype=np.float32).reshape(2, 4)
    want = jax_call(jl, {"weight": jnp.asarray(w)}, None, jnp.asarray(x))
    got = nn.functional_call(pl, {"weight": torch.from_numpy(w)}, None,
                             torch.from_numpy(x))
    assert np.allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)
    # the layer keeps its own weight
    assert not np.array_equal(pl.weight.detach().numpy(), w)
    out, bufs = nn.functional_call(pl, {}, None, torch.from_numpy(x),
                                   capture_buffers=True)
    assert bufs == {} and out.shape == (2, 2)


def test_arena_free_list_honours_the_delete_budget():
    old = get_flags("eager_delete_tensor_gb")
    try:
        for budget, kept in ((0.0, 2), (4 * 4096 / (1 << 30), 4)):
            set_flags({"eager_delete_tensor_gb": budget})
            arena = HostStagingArena(block_bytes=4096, depth=2, pin=False)
            for _ in range(6):  # six blocks in one generation
                arena.stage([torch.ones(1000) for _ in range(6)])
            arena.advance(None)
            assert len(arena._free) == kept
            assert arena.stats["blocks_released"] == 36 - kept
    finally:
        set_flags(old)


def test_replay_draws_records_then_replays():
    gen = torch.Generator().manual_seed(0)
    tape = prandom.DrawTape()
    with prandom.rng_scope(dropout=gen):
        with prandom.replay_draws(tape):
            a = prandom.draw("dropout", "cpu",
                             lambda g: torch.rand(3, generator=g))
        state = gen.get_state()
        with prandom.replay_draws(tape):
            b = prandom.draw("dropout", "cpu",
                             lambda g: torch.rand(3, generator=g))
            with pytest.raises(RuntimeError, match="more than the 1"):
                prandom.draw("dropout", "cpu",
                             lambda g: torch.rand(3, generator=g))
    assert b is a and torch.equal(gen.get_state(), state)


def test_new_modules_import_nothing_of_jax():
    for rel in ("core/lod.py", "core/place.py", "nn/initializer.py",
                "nn/layer.py", "param_attr.py", "ops/beam.py",
                "models/transformer_seq2seq.py", "data/dataset.py",
                "data/data_generator.py"):
        text = (ROOT / "paddle_tpu_torch" / rel).read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|paddle_tpu)\b",
                             text, re.M), rel
