"""PyTorch port: the flash kernels' head-dim plan and the default device
of every layer and model constructor.

Head dims: the CUDA flash kernels are built for every multiple of 16 up
to 128 and for 256, 384 and 512, and run a head dim above 512 as slices
of one of them; ``flash_attention`` zero-pads any other head dim to the
kernels' and keeps the scale of the unpadded dim. The CUDA route runs
only on the card (``chip_smoke.py`` holds D = 40, 48, 80, 96, 112, 256,
320, 384, 512, 640 and 1024 against the plain version there); here the
plan is checked as a pure function, and the padding identity on the
plain version the kernels are held against.

Devices: an entry point runs on the card unless the caller asks for the
CPU, so every constructor that takes ``device`` raises without a GPU when
none is given.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import BertConfig, GPTConfig
from paddle_tpu_torch.models import bert as bert_mod
from paddle_tpu_torch.models import gpt_lm as gpt_mod
from paddle_tpu_torch import nn as pnn


@pytest.mark.parametrize("d,kd,route_128", [
    (8, 16, "fused"), (40, 48, "fused"), (48, 48, "fused"),
    (64, 64, "fused"), (72, 80, "split"), (96, 96, "split"),
    (120, 128, "split"), (128, 128, "split"), (136, 256, "split"),
    (256, 256, "split"), (300, 384, "split"), (384, 384, "split"),
    (400, 512, "split"), (512, 512, "split")])
def test_flash_head_dim_plan(d, kd, route_128):
    # the kernels' head dim, and the backward route at 128 rows: the fused
    # kernel holds 128 rows up to D = 64, 64 up to 128, and none at 256
    assert fa.kernel_head_dim(d) == kd
    assert kd in fa.HEAD_DIMS
    assert fa.backward_route(128, 128, d) == route_128
    assert fa.backward_route(64, 64, d) == ("split" if kd > 128
                                            else "fused")


@pytest.mark.parametrize("d,slices,width", [
    (520, 2, 384), (640, 2, 384), (768, 2, 384), (1024, 2, 512),
    (1100, 3, 384), (1536, 3, 512)])
def test_flash_head_dim_slices_above_512(d, slices, width):
    # above 512 the kernels run ceil(d / 512) slices of a built head dim,
    # zero-padded up to slices * width, always on the split backward route;
    # the wrapper passes the padded dim to the kernel entry, whose device
    # check is what raises on CPU tensors
    assert fa.head_dim_plan(d) == (slices, width)
    assert width in fa.HEAD_DIMS and width * (slices - 1) < d
    assert fa.kernel_head_dim(d) == slices * width >= d
    assert fa.head_dim_plan(slices * width) == (slices, width)
    assert fa.fused_rows(d) == 0
    assert fa.backward_route(16, 16, d) == "split"
    q = torch.zeros(1, 4, 2, d)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q, bthd=True)


@pytest.mark.parametrize("d", [384, 512])
def test_flash_head_dims_384_512(d):
    # built, so the wrapper passes them to the kernel entry unpadded: on
    # CPU tensors that entry's device check is what raises
    assert d in fa.HEAD_DIMS and fa.kernel_head_dim(d) == d
    assert fa.kernel_head_dim(d - 8) == d
    assert fa.fused_rows(d) == 0  # the split backward route
    q = torch.zeros(1, 4, 2, d)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q, bthd=True)


@pytest.mark.parametrize("d", [8, 40, 136, 300])
def test_zero_padded_head_dim_is_the_same_attention(d):
    # what the wrapper does around the kernels: pad q, k, v with zero
    # columns to the kernels' head dim, keep 1/sqrt(d), slice the output;
    # on the plain version the kernels are held against, with dropout
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 20, 2, d),
                                                    np.float32))
               .requires_grad_() for _ in range(3))
    seed = torch.tensor([77], dtype=torch.int32)
    kw = dict(causal=True, dropout_p=0.1, seed=seed, bthd=True)
    want = fa.flash_attention_plain(q, k, v, **kw)
    pad = fa.kernel_head_dim(d) - d
    got = fa.flash_attention_plain(
        *(torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v)),
        scale=1.0 / math.sqrt(d), **kw)[..., :d]
    assert float((got - want).detach().abs().max()) <= 1e-6
    ct = torch.from_numpy(rng.standard_normal(want.shape, np.float32))
    gw = torch.autograd.grad(want, (q, k, v), ct)
    gg = torch.autograd.grad(got, (q, k, v), ct)
    for a, b in zip(gw, gg):
        assert float((a - b).abs().max()) <= 1e-5


_BERT = BertConfig(vocab_size=64, hidden_size=16, num_hidden_layers=1,
                   num_attention_heads=2, intermediate_size=32,
                   max_position_embeddings=16)
_GPT = GPTConfig(vocab_size=64, hidden_size=16, num_layers=1,
                 num_heads=2, intermediate_size=32,
                 max_position_embeddings=16)
CONSTRUCTORS = {
    "Linear": lambda **kw: pnn.Linear(4, 4, **kw),
    "Embedding": lambda **kw: pnn.Embedding(8, 4, **kw),
    "LayerNorm": lambda **kw: pnn.LayerNorm(4, **kw),
    "MultiHeadAttention": lambda **kw: pnn.MultiHeadAttention(8, 2, **kw),
    "TransformerEncoderLayer": lambda **kw: pnn.TransformerEncoderLayer(
        8, 2, 16, **kw),
    "BertEmbeddings": lambda **kw: bert_mod.BertEmbeddings(_BERT, **kw),
    "BertModel": lambda **kw: bert_mod.BertModel(_BERT, **kw),
    "BertPretrainingHeads": lambda **kw: bert_mod.BertPretrainingHeads(
        _BERT, **kw),
    "BertForPretraining": lambda **kw: bert_mod.BertForPretraining(
        _BERT, **kw),
    "GPTBlock": lambda **kw: gpt_mod.GPTBlock(_GPT, **kw),
    "GPTLanguageModel": lambda **kw: gpt_mod.GPTLanguageModel(_GPT, **kw),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructors_default_to_cuda(name):
    make = CONSTRUCTORS[name]
    # asked for, the CPU works
    assert all(p.device.type == "cpu"
               for p in make(device="cpu").parameters())
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
