"""The fluid ``layers`` namespace of the PyTorch package.

Counterpart of ``paddle_tpu.layers``, the reference's ``fluid.layers``
surface (ref: python/paddle/fluid/layers/__init__.py). A fluid user's op
spellings (``elementwise_add``, ``reduce_sum(dim=...)``,
``resize_bilinear``, ``cosine_decay`` ...) resolve here to the port's
ops. Names with fluid semantics are defined in this module with their
signature adapters; the rest of the reference's aggregated ``__all__``
resolves through the module ``__getattr__`` to ``ops.nn_functional``,
then the root namespace. ``DynamicRNN``/``StaticRNN`` raise, naming the
working equivalent.

Graph-construction constructs translate as in the JAX package:

- the lr schedules return ``optimizer.lr`` schedulers, which the
  optimizers evaluate on the device from their step counter;
- ``create_parameter``/``create_global_var``/``fill_constant`` return
  live tensors (on the card unless ``set_device('cpu')`` or
  ``force_cpu``);
- ``Print`` and ``Assert`` on a tensor read the host. In a static scope
  (``jit.to_static``, ``static.Program``) that keeps the signature eager
  (``dy2static.convert_ops.note_eager``), as a tensor ``while`` does; in
  a CUDA graph capture they raise, where the JAX ones ride
  ``jax.debug`` through ``jit``;
- ``py_reader`` returns a generator-backed adapter.
"""

from __future__ import annotations

import builtins as _builtins
import math as _pymath
from typing import Callable, Optional, Sequence

import torch

from ..core.dtype import convert_dtype
from ..core.place import resolve_device
from ..dy2static import convert_ops as _cf_ops
from ..ops import (activation as _act, beam as _beam,
                   control_flow as _cf, conv_extra as _convx, crf as _crf,
                   detection as _det, loss as _loss,
                   manipulation as _manip, math as _math,
                   metrics_ops as _mops, nn_functional as _F,
                   random_ops as _rand, rnn_functional as _rnn,
                   sampling as _samp, sequence as _seq)
from ..optimizer import lr as _lr

builtins_range = _builtins.range

# ---------------------------------------------------------------- elementwise
# (ref: layers/nn.py elementwise_*: fluid's axis-based broadcast)


def _elementwise(fn):
    def op(x, y, axis: int = -1, act: Optional[str] = None, name=None):
        if axis != -1 and y.ndim < x.ndim:
            # y's dims align with x from `axis` (numpy's right-alignment
            # is fluid's axis=-1 alone)
            y = y.reshape(tuple(y.shape) + (1,) * (x.ndim - axis - y.ndim))
        out = fn(x, y)
        if act is not None:
            out = getattr(_act, act)(out)
        return out
    return op


elementwise_add = _elementwise(torch.add)
elementwise_sub = _elementwise(torch.subtract)
elementwise_mul = _elementwise(torch.multiply)
elementwise_div = _elementwise(torch.true_divide)
elementwise_max = _elementwise(torch.maximum)
elementwise_min = _elementwise(torch.minimum)
elementwise_mod = _elementwise(torch.remainder)
elementwise_floordiv = _elementwise(torch.floor_divide)
elementwise_pow = _elementwise(torch.pow)

# ------------------------------------------------------------------ reductions
# (ref: layers/nn.py reduce_*: the `dim` / `keep_dim` spellings)


def _reduce(fn):
    def op(input, dim=None, keep_dim: bool = False, name=None):
        if dim is None:
            out = fn(input)
            return out.reshape((1,) * input.ndim) if keep_dim else out
        dims = tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)
        return fn(input, dim=dims, keepdim=keep_dim)
    return op


def _over(fn):
    """A torch reduction that takes one dim at a time, over several."""
    def op(x, dim=None, keepdim: bool = False):
        if dim is None:
            return fn(x)
        for d in sorted((d % x.ndim for d in dim), reverse=True):
            x = fn(x, dim=d, keepdim=keepdim)
        return x
    return op


reduce_sum = _reduce(torch.sum)
reduce_mean = _reduce(torch.mean)
reduce_max = _reduce(torch.amax)
reduce_min = _reduce(torch.amin)
reduce_prod = _reduce(_over(torch.prod))
reduce_all = _reduce(_over(torch.all))
reduce_any = _reduce(_over(torch.any))

# ------------------------------------------------------------------- resizing
# (ref: layers/nn.py image_resize / resize_bilinear / resize_nearest ...)


def image_resize(input, out_shape=None, scale=None, resample: str = "BILINEAR",
                 align_corners: bool = True, align_mode: int = 1,
                 data_format: str = "NCHW", name=None):
    mode = {"BILINEAR": "bilinear", "NEAREST": "nearest",
            "TRILINEAR": "trilinear", "LINEAR": "linear",
            "BICUBIC": "bicubic"}[resample.upper()]
    return _F.interpolate(input, size=out_shape, scale_factor=scale,
                          mode=mode, align_corners=align_corners,
                          data_format=data_format)


def resize_bilinear(input, out_shape=None, scale=None, align_corners=True,
                    align_mode=1, name=None):
    return image_resize(input, out_shape, scale, "BILINEAR", align_corners,
                        align_mode)


def resize_nearest(input, out_shape=None, scale=None, align_corners=True,
                   name=None):
    return image_resize(input, out_shape, scale, "NEAREST", align_corners)


def resize_trilinear(input, out_shape=None, scale=None, align_corners=True,
                     name=None):
    return image_resize(input, out_shape, scale, "TRILINEAR", align_corners)


def resize_linear(input, out_shape=None, scale=None, align_corners=True,
                  name=None):
    return image_resize(input, out_shape, scale, "LINEAR", align_corners,
                        data_format="NCW")


def image_resize_short(input, out_short_len: int, resample="BILINEAR"):
    h, w = input.shape[2], input.shape[3]
    short, long_ = (h, w) if h < w else (w, h)
    scaled = int(_builtins.round(long_ * out_short_len / short))
    out = (out_short_len, scaled) if h < w else (scaled, out_short_len)
    return image_resize(input, out_shape=out, resample=resample)


grid_sampler = _F.grid_sample

# -------------------------------------------------------------- lr schedules
# (ref: layers/learning_rate_scheduler.py: lr Variables there, scheduler
# objects the optimizers consume here)


def noam_decay(d_model: int, warmup_steps: int, learning_rate: float = 1.0):
    return _lr.NoamDecay(d_model, warmup_steps, learning_rate)


def exponential_decay(learning_rate: float, decay_steps: int,
                      decay_rate: float, staircase: bool = False):
    return _DecayEvery(_lr.ExponentialDecay(learning_rate, decay_rate),
                       decay_steps, staircase)


def natural_exp_decay(learning_rate: float, decay_steps: int,
                      decay_rate: float, staircase: bool = False):
    return _DecayEvery(_lr.NaturalExpDecay(learning_rate, decay_rate),
                       decay_steps, staircase)


def inverse_time_decay(learning_rate: float, decay_steps: int,
                       decay_rate: float, staircase: bool = False):
    return _DecayEvery(_lr.InverseTimeDecay(learning_rate, decay_rate),
                       decay_steps, staircase)


def polynomial_decay(learning_rate: float, decay_steps: int,
                     end_learning_rate: float = 0.0001, power: float = 1.0,
                     cycle: bool = False):
    return _lr.PolynomialDecay(learning_rate, decay_steps,
                               end_lr=end_learning_rate, power=power,
                               cycle=cycle)


def piecewise_decay(boundaries: Sequence[int], values: Sequence[float]):
    return _lr.PiecewiseDecay(boundaries, values)


def cosine_decay(learning_rate: float, step_each_epoch: int, epochs: int):
    return _lr.CosineAnnealingDecay(learning_rate,
                                    T_max=step_each_epoch * epochs)


def linear_lr_warmup(learning_rate, warmup_steps: int, start_lr: float,
                     end_lr: float):
    return _lr.LinearWarmup(learning_rate, warmup_steps, start_lr, end_lr)


class _DecayEvery(_lr.LRScheduler):
    """fluid's decay_steps/staircase over a per-step scheduler: the inner
    one sees ``step / decay_steps`` in fp32 (floored when staircase), on
    the device of the step counter."""

    def __init__(self, inner, decay_steps: int, staircase: bool):
        self.inner = inner
        self.decay_steps = decay_steps
        self.staircase = staircase
        super().__init__(inner.base_lr)

    def lr_at(self, step):
        t = _lr._f32(step) / self.decay_steps
        if self.staircase:
            t = torch.floor(t)
        return self.inner.lr_at(t)


# ------------------------------------------------------------- control flow
# (ref: layers/control_flow.py; ops.control_flow runs them)

While = _cf.while_loop
while_loop = _cf.while_loop
cond = _cf.cond
case = _cf.case
switch_case = _cf.switch_case
Switch = _cf.switch_case
IfElse = _cf.cond


def _host_read(what: str) -> None:
    """A host read of a tensor: a static scope's signature turns eager,
    and inside a CUDA graph capture it raises (a read there would break
    the capture)."""
    _cf_ops.note_eager(what)
    if _cf_ops.capturing():
        raise RuntimeError(
            f"{what} reads the host inside a CUDA graph capture; run the "
            f"step eagerly (compiled=False) to print or assert in it")


def Print(input, message: str = "", summarize: int = 20, name=None,
          **kwargs):
    """(ref: control_flow.py Print) prints ``message`` and the tensor and
    returns it (a host read: see the module note)."""
    _host_read("layers.Print")
    value = input.detach().cpu().numpy() \
        if isinstance(input, torch.Tensor) else input
    print(f"{message} {value}")
    return input


def Assert(cond_value, data=None, summarize: int = 20, name=None):
    """(ref: control_flow.py Assert) raises AssertionError when the
    condition is false (on a tensor, a host read: see the module
    note)."""
    if isinstance(cond_value, torch.Tensor):
        _host_read("layers.Assert")
    if not bool(cond_value):
        raise AssertionError(f"layers.Assert failed: {data}")


def is_empty(x, name=None):
    return _manip.is_empty(x)


# -------------------------------------------------------- tensor constructors
# (ref: layers/tensor.py; Scope-registered Variables become live tensors)


def _place(force_cpu: bool = False) -> torch.device:
    return torch.device("cpu") if force_cpu else resolve_device(None)


def create_tensor(dtype, name=None, persistable: bool = False):
    return torch.zeros((), dtype=convert_dtype(dtype), device=_place())


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias: bool = False, default_initializer=None):
    from ..nn import initializer as I
    init = default_initializer or (I.Constant(0.0) if is_bias
                                   else I.XavierNormal())
    param = torch.nn.Parameter(init(tuple(shape), dtype, _place()))
    if name is not None:
        param.param_name = name
    return param


def create_global_var(shape, value, dtype, persistable: bool = False,
                      force_cpu: bool = False, name=None):
    return torch.full(tuple(shape), value, dtype=convert_dtype(dtype),
                      device=_place(force_cpu))


def autoincreased_step_counter(counter_name=None, begin: int = 1,
                               step: int = 1):
    """(ref: layers/tensor.py) a host-side monotonic counter; a
    ``TrainStep`` keeps its step in the optimizer state, so this is for
    eager orchestration code."""
    return _StepCounter(begin, step)


class _StepCounter:
    def __init__(self, begin: int, step: int):
        self.value = begin
        self.step = step

    def __call__(self) -> int:
        v = self.value
        self.value += self.step
        return v


def fill_constant(shape, dtype, value, force_cpu: bool = False, out=None):
    return torch.full(tuple(shape), value, dtype=convert_dtype(dtype),
                      device=_place(force_cpu))


# ------------------------------------------------------------------ data feed
# (ref: layers/io.py py_reader / create_py_reader_by_data / double_buffer;
# data.DeviceLoader prefetches, these adapt the call pattern)


class _PyReader:
    def __init__(self, capacity: int, shapes, dtypes):
        self.capacity = capacity
        self.shapes = shapes
        self.dtypes = dtypes
        self._gen = None

    def decorate_paddle_reader(self, reader: Callable):
        self._gen = reader

    decorate_sample_list_generator = decorate_paddle_reader
    decorate_batch_generator = decorate_paddle_reader

    def start(self):
        if self._gen is None:
            raise ValueError("py_reader: call decorate_paddle_reader first")
        self._it = iter(self._gen())

    def reset(self):
        # fluid's per-epoch pattern: reset() then start() re-arms it
        self._it = None

    def __iter__(self):
        if getattr(self, "_it", None) is None:
            raise ValueError("py_reader: call start() before iterating "
                             "(and after each reset())")
        return self._it

    def __next__(self):
        return next(iter(self))


def py_reader(capacity: int, shapes, dtypes, lod_levels=None,
              name=None, use_double_buffer: bool = True):
    return _PyReader(capacity, shapes, dtypes)


def create_py_reader_by_data(capacity: int, feed_list, name=None,
                             use_double_buffer: bool = True):
    return _PyReader(capacity, [getattr(f, "shape", None)
                                for f in feed_list], None)


def double_buffer(reader, place=None, name=None):
    return reader  # data.DeviceLoader's prefetch covers it


def read_file(reader):
    return next(iter(reader))


# ------------------------------------------------------------------- the rest
# direct re-exports under their fluid spellings

def fc(input, size: int, num_flatten_dims: int = 1, weight=None, bias=None,
       act: Optional[str] = None, name=None):
    """(ref: layers/nn.py fc) flattens the trailing dims, then the affine
    map; pass weight ``[in, size]`` and bias explicitly (the functional
    world has no LayerHelper: ``nn.Linear`` owns its parameters)."""
    lead = tuple(input.shape[:num_flatten_dims])
    flat = input.reshape(_pymath.prod(lead), -1)
    if weight is None:
        raise ValueError("layers.fc in the functional API needs an "
                         "explicit weight (or use nn.Linear)")
    out = flat @ weight
    if bias is not None:
        out = out + bias
    if act is not None:
        out = getattr(_act, act)(out)
    return out.reshape(lead + (size,))


def adaptive_pool2d(input, pool_size, pool_type="avg", name=None):
    if pool_type == "avg":
        return _F.adaptive_avg_pool2d(input, pool_size)
    return _F.adaptive_max_pool2d(input, pool_size)


def adaptive_pool3d(input, pool_size, pool_type="avg", name=None):
    return _F.adaptive_pool3d(input, pool_size, pool_type)


pool2d = _F.pool2d
pool3d = _F.pool3d
add_position_encoding = _F.add_position_encoding
similarity_focus = _F.similarity_focus
random_crop = _F.random_crop
inplace_abn = _F.inplace_abn
dice_loss = _loss.dice_loss
kldiv_loss = _loss.kl_div
smooth_l1 = _loss.smooth_l1_loss
warpctc = _loss.warpctc
edit_distance = _seq.edit_distance
ctc_greedy_decoder = _seq.ctc_greedy_decoder
mean_iou = _mops.mean_iou


def auc(input, label, num_thresholds: int = 2048, curve: str = "ROC"):
    """(ref: layers/nn.py auc) one batch's AUC; ``metric.Auc``
    accumulates over batches."""
    pos = input[:, 1] if input.ndim == 2 else input
    tp, fp = _mops.auc_stats(pos, label, num_thresholds)
    return _mops.auc_from_stats(tp, fp)


hash = _samp.hash_bucket
has_inf = _math.has_inf
has_nan = _math.has_nan
isfinite = _math.isfinite_all
sums = _math.sums
fill_constant_batch_size_like = _math.fill_constant_batch_size_like
uniform_random_batch_size_like = _math.uniform_random_batch_size_like
gaussian_random_batch_size_like = _math.gaussian_random_batch_size_like
uniform_random = _rand.uniform_random
reverse = _manip.reverse
unique_with_counts = _manip.unique_with_counts
crop_tensor = _manip.crop_tensor
size = _manip.numel
range = _manip.arange

# rnn
dynamic_lstm = _rnn.dynamic_lstm
dynamic_lstmp = _rnn.dynamic_lstmp
dynamic_gru = _rnn.dynamic_gru
lstm = _rnn.lstm
lstm_unit = _rnn.lstm_unit
gru_unit = _rnn.gru_unit

# detection.py
iou_similarity = _det.iou_similarity
box_coder = _det.box_coder
box_clip = _det.box_clip
prior_box = _det.prior_box
density_prior_box = _det.density_prior_box
anchor_generator = _det.anchor_generator
yolo_box = _det.yolo_box
yolov3_loss = _det.yolov3_loss
multiclass_nms = _det.multiclass_nms
matrix_nms = _det.matrix_nms
locality_aware_nms = _det.locality_aware_nms
bipartite_match = _det.bipartite_match
target_assign = _det.target_assign
ssd_loss = _det.ssd_loss
roi_align = _det.roi_align
roi_pool = _det.roi_pool
psroi_pool = _det.psroi_pool
prroi_pool = _det.prroi_pool
roi_perspective_transform = _det.roi_perspective_transform
deformable_conv = _convx.deformable_conv
deformable_psroi_pooling = _F.deformable_roi_pooling  # reference op name
generate_proposals = _det.generate_proposals
rpn_target_assign = _det.rpn_target_assign
retinanet_target_assign = _det.retinanet_target_assign
retinanet_detection_output = _det.retinanet_detection_output
sigmoid_focal_loss = _det.sigmoid_focal_loss
generate_proposal_labels = _det.generate_proposal_labels
generate_mask_labels = _det.generate_mask_labels
distribute_fpn_proposals = _det.distribute_fpn_proposals
collect_fpn_proposals = _det.collect_fpn_proposals
box_decoder_and_assign = _det.box_decoder_and_assign
polygon_box_transform = _det.polygon_box_transform

# sampling / search
nce = _samp.nce_loss
hsigmoid = _samp.hsigmoid_loss
beam_search = _beam.beam_search
from ..nn.decode import (BasicDecoder, BeamSearchDecoder,  # noqa: E402
                         DecodeHelper, Decoder, dynamic_decode,
                         GreedyEmbeddingHelper, SampleEmbeddingHelper,
                         TrainingHelper)
beam_search_decode = _beam.beam_search_decode
gather_tree = _beam.gather_tree

# crf
linear_chain_crf = _crf.linear_chain_crf
crf_decoding = _crf.crf_decoding

# distributions (the layers.distributions re-export)
from ..distribution import (Categorical, MultivariateNormalDiag,  # noqa: E402
                            Normal, Uniform)


def sampling_id(x, min: float = 0.0, max: float = 1.0, seed: int = 0,
                dtype="int64", key=None):
    """(ref: sampling_id_op.cc) one category index per row of a
    probability matrix, drawn by the Gumbel-max rule from ``key`` (a
    generator or an int seed; None: the ``random`` stream). The draws
    cannot be JAX's."""
    logp = torch.log(torch.clamp_min(x, 1e-20))
    u = _rand.draw_with(key, x.device, lambda g: torch.rand(
        logp.shape, generator=g, device=x.device, dtype=logp.dtype))
    tiny = torch.finfo(logp.dtype).tiny
    gumbel = -torch.log(-torch.log(torch.clamp_min(u, tiny)))
    return torch.argmax(logp + gumbel, dim=-1)


def detection_output(loc: torch.Tensor, scores: torch.Tensor,
                     prior_box: torch.Tensor, prior_box_var=None,
                     background_label: int = 0, nms_threshold: float = 0.3,
                     nms_top_k: int = 400, keep_top_k: int = 200,
                     score_threshold: float = 0.01,
                     nms_eta: float = 1.0) -> list:
    """The SSD inference head: each prior's offsets ``loc [B, P, 4]``
    decoded against it (centre-size, ``prior_box_var`` scaling them),
    then ``multiclass_nms`` of ``scores [B, P, C]``. Returns one ``(out
    [keep_top_k, 6], valid)`` per image, as the JAX layer; the images'
    NMS loops run as one batched loop."""
    pw = prior_box[:, 2] - prior_box[:, 0]
    ph = prior_box[:, 3] - prior_box[:, 1]
    pcx = prior_box[:, 0] + 0.5 * pw
    pcy = prior_box[:, 1] + 0.5 * ph
    var = prior_box_var if prior_box_var is not None \
        else torch.ones(4, dtype=loc.dtype, device=loc.device)
    d = loc * var
    cx = d[..., 0] * pw + pcx
    cy = d[..., 1] * ph + pcy
    w = torch.exp(d[..., 2]) * pw
    h = torch.exp(d[..., 3]) * ph
    dec = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    out, valid = _det._multiclass_nms(
        dec.to(torch.float32), scores.transpose(1, 2), score_threshold,
        nms_threshold, keep_top_k, nms_top_k, background_label)
    return [(out[i], valid[i]) for i in builtins_range(out.shape[0])]


# Graph-recording block APIs: the `with rnn.step():` protocol records ops
# into a sub-block, which nothing here records. The working equivalents:
_REDIRECTED = {
    "DynamicRNN": "nn.RNN / ops.control_flow.static_rnn over dense "
                  "padded sequences (+ lengths)",
    "StaticRNN": "ops.control_flow.static_rnn (a loop over the leading "
                 "axis)",
}


def __getattr__(name):
    if name in _REDIRECTED:
        raise NotImplementedError(
            f"fluid.layers.{name} is a graph-recording block API; use "
            f"{_REDIRECTED[name]} instead")
    # the rest of the reference's aggregated fluid.layers.__all__
    # resolves to ops.nn_functional first (fluid's functional
    # semantics), then the root namespace
    if not name.startswith("_"):
        obj = getattr(_F, name, None)
        if obj is None:
            import paddle_tpu_torch as _root
            obj = getattr(_root, name, None)
        if obj is not None:
            if not hasattr(_builtins, name):
                # cached for the next lookup; a builtin's name (round,
                # max, abs ...) is not, or it would shadow the builtin
                # in this module's functions
                globals()[name] = obj
            return obj
    raise AttributeError(f"module 'paddle_tpu_torch.layers' has no "
                         f"attribute {name!r}")


# ----------------------------------------------------- fluid signatures
def argmax(x, axis: int = 0):
    """(ref: fluid/layers/tensor.py:881) fluid's default axis is 0,
    unlike the root namespace's -1; int64 indices, as the reference."""
    return torch.argmax(x, dim=axis)


def argmin(x, axis: int = 0):
    """(ref: fluid/layers/tensor.py:920) fluid's default axis is 0."""
    return torch.argmin(x, dim=axis)


def expand(x, expand_times: Sequence[int], name=None):
    """(ref: fluid/layers/nn.py:10142 expand) TILES each dim by
    ``expand_times`` (paddle 2.x ``expand`` broadcasts instead)."""
    if len(expand_times) != x.ndim:
        raise ValueError(
            f"expand: expand_times has {len(expand_times)} entries for "
            f"rank-{x.ndim} input (fluid requires one per dim)")
    return x.repeat(tuple(int(t) for t in expand_times))


def expand_as(x, target_tensor, name=None):
    """(ref: fluid/layers/nn.py:10219 expand_as) tiles x to the shape of
    ``target_tensor`` (each target dim a multiple of x's)."""
    tshape = tuple(target_tensor.shape)
    if len(tshape) != x.ndim:
        raise ValueError(
            f"expand_as: rank mismatch {x.ndim} vs {len(tshape)}")
    reps = []
    for i, (s, t) in enumerate(zip(x.shape, tshape)):
        if t % s != 0:
            raise ValueError(
                f"expand_as: target dim {i} ({t}) is not a multiple of "
                f"input dim ({s})")
        reps.append(t // s)
    return x.repeat(tuple(reps))


def flatten(x, axis: int = 1, name=None):
    """(ref: fluid/layers/nn.py:9817 flatten) a 2-D matrix
    ``[prod(shape[:axis]), prod(shape[axis:])]`` (paddle 2.x flatten
    takes start/stop axes)."""
    lead = _pymath.prod(x.shape[:axis]) if axis > 0 else 1
    return x.reshape(lead, -1)


def split(input, num_or_sections, dim: int = -1, name=None):
    """(ref: fluid/layers/nn.py:4792 split) fluid's default is the LAST
    axis, unlike the root namespace's axis 0."""
    return _manip.split(input, num_or_sections, axis=dim)


def unique(x, dtype="int32"):
    """(ref: fluid/layers/nn.py:14024 unique) ``(out, index)``: ``out``
    in FIRST-OCCURRENCE order, ``index`` the inverse map (``out[index] ==
    x``) in ``dtype``. The output's size depends on the data (a host
    read)."""
    flat = x.reshape(-1)
    out_sorted, inv_sorted = torch.unique(flat, sorted=True,
                                          return_inverse=True)
    n = flat.shape[0]
    first_idx = torch.full((out_sorted.shape[0],), n, dtype=torch.int64,
                           device=flat.device).scatter_reduce(
        0, inv_sorted, torch.arange(n, device=flat.device), "amin")
    order = torch.argsort(first_idx)  # sorted-unique -> occurrence order
    rank = torch.argsort(order)  # sorted-unique idx -> new position
    return out_sorted[order], rank[inv_sorted].to(convert_dtype(dtype))


def sum(x):
    """(ref: fluid/layers/nn.py:10661 sum == sum_op/add_n) the
    elementwise sum of a LIST of same-shaped tensors (``reduce_sum``
    reduces one; so does the root namespace's ``sum``)."""
    if isinstance(x, (list, tuple)):
        out = x[0]
        for t in x[1:]:
            out = out + t
        return out
    return torch.as_tensor(x)


def cross_entropy(input, label, soft_label: bool = False,
                  ignore_index: int = -100):
    """(ref: fluid/layers/loss.py:206 cross_entropy) fluid's op takes
    PROBABILITIES (no softmax) and returns PER-SAMPLE losses shaped like
    the label (the root/nn.functional cross_entropy is the 2.x
    logits-and-mean op). ``ignore_index`` zeroes those samples (hard
    labels)."""
    logp = torch.log(torch.clamp_min(input, 1e-20))
    if soft_label:
        return -(label * logp).sum(-1, keepdim=True)
    lab = torch.as_tensor(label, device=input.device)
    if lab.ndim == input.ndim:  # fluid's [N, 1] hard labels
        lab = lab.squeeze(-1)
    safe = torch.where(lab == ignore_index, torch.zeros_like(lab),
                       lab).long()
    picked = torch.gather(logp, -1, safe[..., None])
    return torch.where((lab != ignore_index)[..., None], -picked,
                       torch.zeros_like(picked))


def dropout(x, dropout_prob: float, is_test: bool = False, seed=None,
            name=None, dropout_implementation: str = "downgrade_in_infer"):
    """(ref: fluid/layers/nn.py:1364 dropout) fluid's default is
    ``downgrade_in_infer`` (train: the mask alone, no 1/(1-p) upscale;
    infer: scaled by 1-p); 2.x/nn.functional defaults to
    ``upscale_in_train``. A fixed ``seed`` gives a fixed mask; None draws
    from the ``random`` stream."""
    mode = {"downgrade_in_infer": "downscale_in_infer",
            "downscale_in_infer": "downscale_in_infer",
            "upscale_in_train": "upscale_in_train"}.get(
        dropout_implementation)
    if mode is None:
        raise ValueError(
            f"dropout: unknown dropout_implementation "
            f"{dropout_implementation!r} (expected 'downgrade_in_infer' "
            f"or 'upscale_in_train')")
    return _F.dropout(x, dropout_prob, training=not is_test, mode=mode,
                      key=seed)


def embedding(input, size, is_sparse: bool = False,
              is_distributed: bool = False, padding_idx=None,
              param_attr=None, dtype="float32", weight=None):
    """(ref: fluid/layers/nn.py:380 embedding) pass the table (of shape
    ``size``) as ``weight`` (``nn.Embedding`` owns its table)."""
    if weight is None:
        raise ValueError(
            "layers.embedding in the functional API needs an explicit "
            "weight table (shape `size`); use nn.Embedding for a "
            "parameter-owning layer")
    if tuple(weight.shape) != tuple(size):
        raise ValueError(
            f"layers.embedding: weight shape {tuple(weight.shape)} != "
            f"size {tuple(size)}")
    return _F.embedding(input, weight, padding_idx=padding_idx)


def pad(x, paddings: Sequence[int], pad_value: float = 0.0, name=None):
    """(ref: fluid/layers/nn.py:6546 pad) a flat ``paddings`` list
    ``[before_0, after_0, before_1, after_1, ...]`` and fluid's
    ``pad_value``."""
    if len(paddings) != 2 * x.ndim:
        raise ValueError(
            f"pad: expected {2 * x.ndim} padding entries for rank "
            f"{x.ndim}, got {len(paddings)}")
    widths = []
    for i in reversed(builtins_range(x.ndim)):  # torch pads the last first
        widths += [int(paddings[2 * i]), int(paddings[2 * i + 1])]
    return torch.nn.functional.pad(x, widths, value=pad_value)


continuous_value_model = _F.continuous_value_model
deformable_roi_pooling = _F.deformable_roi_pooling
lod_append = _seq.lod_append
lod_reset = _seq.lod_reset
reorder_lod_tensor_by_rank = _seq.reorder_lod_tensor_by_rank


def rnn(cell, inputs, initial_states=None, sequence_length=None,
        time_major: bool = False, is_reverse: bool = False):
    """(ref: fluid/layers/rnn.py rnn) drives an RNNCell over a dense
    padded sequence through ``nn.RNN`` (finished rows keep their last
    state, their outputs zero). Returns ``(outputs, final_states)``."""
    from ..nn import RNN as _RNN
    driver = _RNN(cell, is_reverse=is_reverse, time_major=time_major)
    return driver(inputs, initial_states=initial_states,
                  sequence_length=sequence_length)


from ..nn import GRUCell, LSTMCell, RNNCell  # noqa: E402
from ..ops.sparse import RowSlices, merge_rows, to_dense  # noqa: E402


def merge_selected_rows(x: "RowSlices"):
    """(ref: merge_selected_rows_op.cc) sums the duplicate rows of a
    RowSlices (SelectedRows) gradient."""
    return merge_rows(x)


def get_tensor_from_selected_rows(x: "RowSlices"):
    """(ref: get_tensor_from_selected_rows_op.cc) densifies RowSlices."""
    return to_dense(x)


def load(out=None, file_path: str = "", load_as_fp16: bool = False):
    """(ref: layers/io.py load) loads one persistable tensor INTO a
    variable: a parameter ``out`` is written in place (the fluid pattern
    discards the return), and the loaded tensor is returned too."""
    from .. import io as _io
    data = _io.load(file_path)
    if isinstance(data, dict) and len(data) == 1:
        data = next(iter(data.values()))
    if load_as_fp16:
        data = data.to(torch.float16) if isinstance(data, torch.Tensor) \
            else {k: v.to(torch.float16) for k, v in data.items()}
    if out is not None:
        if not isinstance(out, torch.Tensor):
            raise TypeError(
                "layers.load: out must be a Parameter (a tensor written "
                f"in place); got {type(out).__name__}")
        with torch.no_grad():
            out.copy_(data)
        return out
    return data


def multi_box_head(inputs, image_hw, num_classes: int,
                   min_sizes, max_sizes, aspect_ratios,
                   loc_weights, conf_weights, loc_biases=None,
                   conf_biases=None, flip: bool = True,
                   clip: bool = False):
    """SSD multi-scale head (ref: layers/detection.py multi_box_head):
    each feature map's loc/conf convolutions and prior boxes,
    concatenated.

    inputs: ``[B, C_i, H_i, W_i]`` feature maps; ``*_weights``: each
    map's kernels ``[A_i*4, C_i, 3, 3]`` / ``[A_i*num_classes, C_i, 3,
    3]`` (``models.SSDLite`` builds heads as layers). Returns ``(loc [B,
    P, 4], conf [B, P, num_classes], priors [P, 4], variances [P, 4])``.
    """
    locs, confs, priors, pvars = [], [], [], []
    for i, feat in enumerate(inputs):
        b, c, fh, fw = feat.shape
        boxes, variances = _det.prior_box(
            (fh, fw), tuple(image_hw), min_sizes=[min_sizes[i]],
            max_sizes=[max_sizes[i]] if max_sizes else (),
            aspect_ratios=aspect_ratios[i]
            if isinstance(aspect_ratios[i], (list, tuple))
            else (aspect_ratios[i],), flip=flip, clip=clip,
            device=feat.device)
        a = boxes.shape[2]
        if loc_weights[i].shape[0] != a * 4 or \
                conf_weights[i].shape[0] != a * num_classes:
            raise ValueError(
                f"multi_box_head: feature map {i} has {a} priors/cell; "
                f"loc/conf weights must have {a * 4}/{a * num_classes} "
                f"output channels, got {loc_weights[i].shape[0]}/"
                f"{conf_weights[i].shape[0]}")
        lo = _F.conv2d(feat, loc_weights[i],
                       loc_biases[i] if loc_biases else None, padding=1)
        co = _F.conv2d(feat, conf_weights[i],
                       conf_biases[i] if conf_biases else None, padding=1)
        locs.append(lo.permute(0, 2, 3, 1).reshape(b, -1, 4))
        confs.append(co.permute(0, 2, 3, 1).reshape(b, -1, num_classes))
        priors.append(boxes.reshape(-1, 4))
        pvars.append(variances.reshape(-1, 4))
    return (torch.cat(locs, 1), torch.cat(confs, 1), torch.cat(priors, 0),
            torch.cat(pvars, 0))
