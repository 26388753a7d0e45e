"""The core op library's cases, shared by the CPU parity tests and the
card sweep.

``CASES`` lists one or more calls of every deterministic public function
of ``ops.math``, ``activation``, ``reduction``, ``manipulation`` and
``search`` as ``(module, function, args, kwargs)`` on numpy inputs made
from a fixed seed (ties, ``-0.0``, NaN/Inf and half-way values where the
semantics turn on them). ``tests/test_torch_ops_core.py`` runs each
through the JAX package and the port on the CPU; ``chip_smoke.py``
phase 15 (e) runs each through the port on the card and on the CPU.
``SEQ_CASES`` lists the recurrent and sequence stack's cases the same
way: every public function of ``ops.sequence``, ``crf``,
``rnn_functional`` and the deterministic ones of ``sampling`` (NCE on
given negatives), and the CTC losses of ``ops.loss`` (every reduction,
repeated labels, short inputs, a label longer than its input);
``sparse_runs`` drives ``ops.sparse`` (``SEQ_MODULES``); ``SEQ_RANDOM``
names the sampled functions, checked by shape and seed.
``tests/test_torch_sequence_ops.py`` runs them against the JAX package,
``chip_smoke.py`` phase 16 (e) on the card against the CPU.
``RANDOM``, ``CREATION``, ``CONTROL`` name the functions the random,
creation and control-flow checks cover; ``control_flow_runs`` and
``tensor_array_run`` drive ``ops.control_flow`` and ``ops.tensor_array``
(or the JAX twins: the bodies use only arithmetic both array types
have); ``RANDOM_MOMENTS`` gives each random op's call and the mean and
standard deviation its distribution has.
"""

import numpy as np

__all__ = ["CASES", "RANDOM", "CREATION", "CONTROL", "RANDOM_MOMENTS",
           "control_flow_runs", "tensor_array_run", "MODULES",
           "SEQ_MODULES", "SEQ_CASES", "SEQ_RANDOM", "sparse_runs"]

MODULES = ("math", "activation", "reduction", "manipulation", "search",
           "random_ops", "control_flow", "tensor_array")

R = np.random.default_rng(0)
X = R.normal(size=(3, 4)).astype(np.float32)
X3 = R.normal(size=(2, 3, 4)).astype(np.float32)
A = R.normal(size=(4, 5)).astype(np.float32)
POS = (np.abs(X) + 0.1).astype(np.float32)
UNIT = (R.uniform(0.05, 0.95, size=(3, 4))).astype(np.float32)
INTS = np.array([[-7, 3, 5, -2], [9, -4, 0, 6]], np.int64)
SPD = (lambda m: (m @ m.T + 4 * np.eye(4)).astype(np.float32))(
    R.normal(size=(4, 4)))
HALF = np.array([[0.5, 1.5, 2.5, -0.5], [-1.5, 3.49, -2.5, 0.0]],
                np.float32)
SPECIAL = np.array([[np.nan, np.inf, -np.inf, 1.0]], np.float32)
TIES = np.array([[1.0, -0.0, 0.0, 1.0, -2.0, 0.0],
                 [3.0, 3.0, np.nan, -1.0, 3.0, -0.0]], np.float32)
EVEN = np.array([[4.0, 1.0, 3.0, 2.0], [np.nan, 1.0, 2.0, 3.0],
                 [5.0, 5.0, -0.0, 0.0]], np.float32)
SORTED = np.array([0.0, 1.0, 1.0, 2.5, 4.0], np.float32)
BOOLS = np.array([[True, False], [True, True]])


def C(mod, name, *args, **kw):
    return (mod, name, args, kw)


CASES = [
    # math: the matmul family
    C("math", "matmul", X, A), C("math", "matmul", X.T, A, transpose_x=True),
    C("math", "matmul", X, A.T, transpose_y=True, alpha=0.5),
    C("math", "mul", X3, A, x_num_col_dims=2),
    C("math", "bmm", X3, R.normal(size=(2, 4, 5)).astype(np.float32)),
    C("math", "dot", X, POS), C("math", "addmm", A[:3], X, A, beta=0.5,
                                  alpha=2.0),
    C("math", "bilinear_tensor_product", X[:2, :3], X[:2],
      R.normal(size=(5, 3, 4)).astype(np.float32), A[0]),
    C("math", "kron", X[:2, :2], A[:2, :3]),
    C("math", "cross", A[:, :3], A[:, 2:]),
    C("math", "einsum", "ij,jk->ik", X, A),
    # elementwise binary, with the reference's axis alignment
    C("math", "add", X3, X[0, :3].reshape(3), axis=1),
    C("math", "subtract", X, POS), C("math", "multiply", X, 2.5),
    C("math", "divide", X, POS), C("math", "divide", INTS, INTS[::-1] + 11),
    C("math", "floor_divide", INTS, np.array([3, -2, 4, 5], np.int64)),
    C("math", "remainder", INTS, np.array([3, -2, 4, 5], np.int64)),
    C("math", "mod", X, 0.7), C("math", "pow", POS, 2.5),
    C("math", "elementwise_pow", POS, X[0]),
    C("math", "maximum", X, POS - 1), C("math", "minimum", X, POS - 1),
    C("math", "fmax", SPECIAL, np.zeros_like(SPECIAL)),
    C("math", "fmin", SPECIAL, np.zeros_like(SPECIAL)),
    # unary
    *[C("math", n, X) for n in ("abs", "square", "exp", "expm1", "sin",
                                "cos", "tan", "atan", "sinh", "cosh",
                                "asinh", "ceil", "floor", "trunc", "sign",
                                "erf", "neg")],
    *[C("math", n, POS) for n in ("sqrt", "rsqrt", "log", "log1p", "log2",
                                  "log10", "reciprocal", "lgamma",
                                  "digamma")],
    *[C("math", n, UNIT) for n in ("asin", "acos", "atanh", "erfinv",
                                   "logit")],
    C("math", "acosh", POS + 1), C("math", "atan2", X, POS),
    C("math", "round", HALF), C("math", "logit", UNIT, eps=0.2),
    *[C("math", n, SPECIAL) for n in ("isnan", "isinf", "isfinite",
                                      "has_inf", "has_nan",
                                      "isfinite_all")],
    C("math", "has_inf", X), C("math", "isfinite_all", X),
    C("math", "scale", X, scale=2.0, bias=1.0),
    C("math", "scale", X, scale=2.0, bias=1.0, bias_after_scale=False,
      act="relu"),
    C("math", "clip", X, -0.5, 0.5), C("math", "clip_by_norm", X, 1.0),
    C("math", "clip_by_norm", X * 1e-3, 1.0),
    C("math", "increment", X, 2.0), C("math", "stanh", X),
    C("math", "minus", X, POS), C("math", "cumsum", X),
    C("math", "cumsum", X, axis=1, reverse=True, exclusive=True),
    C("math", "cumsum", BOOLS, axis=0), C("math", "cumprod", X, axis=1),
    C("math", "logcumsumexp", X, axis=1), C("math", "cholesky", SPD),
    C("math", "cholesky", SPD, upper=True), C("math", "inverse", SPD),
    C("math", "trace", X3, offset=1, axis1=1, axis2=2),
    C("math", "tril", X, 1), C("math", "triu", X, -1),
    C("math", "diag", X[0]), C("math", "diag", X[0], offset=1,
                                 padding_value=9.0),
    C("math", "diag", X, offset=-1), C("math", "diag_embed", X, offset=1),
    *[C("math", "dist", X, POS, p=p) for p in (2.0, float("inf"),
                                                float("-inf"), 0, 1.5)],
    C("math", "matrix_power", SPD / 4, 3),
    C("math", "multiplex", [X, POS, X * 3], np.array([[2], [0], [1]])),
    C("math", "sums", [X, POS, X * 3]),
    C("math", "fill_constant_batch_size_like", X, [7, 2], "float32", 1.5,
      output_dim_idx=1),
    # activation
    *[C("activation", n, X) for n in (
        "relu", "relu6", "leaky_relu", "elu", "selu", "celu", "gelu",
        "sigmoid", "logsigmoid", "hard_sigmoid", "hard_swish",
        "hard_shrink", "soft_shrink", "softshrink", "hardshrink",
        "hard_tanh", "hardtanh", "brelu", "tanh", "tanh_shrink",
        "tanhshrink", "softplus", "soft_relu", "softsign", "swish", "silu",
        "mish", "thresholded_relu", "log_softmax", "softmax", "glu",
        "rrelu")],
    C("activation", "gelu", X, approximate=True), C("activation", "prelu", X, 0.25),
    C("activation", "softplus", X * 30, beta=2.0, threshold=10.0),
    C("activation", "leaky_relu", X, 0.2), C("activation", "celu", X, alpha=0.5),
    C("activation", "maxout", X3.reshape(2, 6, 2), groups=3, axis=1),
    C("activation", "softmax", X, axis=0),
    # reduction
    *[C("reduction", n, X) for n in ("sum", "mean", "max", "min", "prod", "any",
                               "all", "logsumexp", "frobenius_norm",
                               "p_norm", "squared_l2_norm", "l1_norm",
                               "nanmean", "nansum", "var", "std", "median",
                               "amax", "amin")],
    *[C("reduction", n, X3, axis=(0, 2), keepdim=True)
      for n in ("sum", "mean", "max", "min", "prod", "logsumexp",
                "frobenius_norm", "var", "std", "amax", "amin")],
    C("reduction", "sum", BOOLS, axis=1), C("reduction", "mean", INTS, axis=0),
    C("reduction", "any", BOOLS, axis=0), C("reduction", "all", BOOLS, axis=1),
    C("reduction", "var", X, axis=1, unbiased=False),
    C("reduction", "std", X, axis=0, unbiased=False),
    C("reduction", "median", EVEN, axis=1), C("reduction", "median", EVEN, axis=0,
                                          keepdim=True),
    C("reduction", "median", np.array([3, 1, 4, 2], np.int32)),
    C("reduction", "median", X, keepdim=True),
    *[C("reduction", "p_norm", X, p=p, axis=1) for p in (1.0, 3.0, float("inf"),
                                                    float("-inf"), 0)],
    C("reduction", "nanmean", EVEN, axis=1), C("reduction", "nansum", EVEN, axis=1),
    # manipulation
    C("manipulation", "concat", [X, POS], axis=1), C("manipulation", "split", X3, 2, axis=2),
    C("manipulation", "split", X3, [1, -1], axis=2), C("manipulation", "chunk", X3, 3, axis=2),
    C("manipulation", "reshape", X3, [0, 12]), C("manipulation", "squeeze", X[None, :, None]),
    C("manipulation", "squeeze", X[None, :, None], axis=[0, 1]),
    C("manipulation", "unsqueeze", X, [0, -1]), C("manipulation", "stack", [X, POS], axis=1),
    C("manipulation", "unstack", X3, axis=1), C("manipulation", "unbind", X3, 2),
    C("manipulation", "transpose", X3, [2, 0, 1]), C("manipulation", "swapaxes", X3, 0, 2),
    C("manipulation", "moveaxis", X3, 0, -1), C("manipulation", "tile", X, [2, 1, 3]),
    C("manipulation", "expand", X[:1], [2, 3, -1]), C("manipulation", "expand_as", X[:1], X3),
    C("manipulation", "broadcast_to", X[0], [2, 4]),
    C("manipulation", "broadcast_tensors", [X[:1], POS[:, :1]]),
    C("manipulation", "flip", X3, [0, 2]), C("manipulation", "roll", X, 2),
    C("manipulation", "roll", X, [1, -1], axis=[0, 1]), C("manipulation", "rot90", X, 3),
    C("manipulation", "flatten", X3, 1, 2), C("manipulation", "cast", X, "int32"),
    C("manipulation", "assign", X),
    C("manipulation", "gather", X, np.array([2, 0, 2]), axis=0),
    C("manipulation", "gather_nd", X3, np.array([[1, 2], [0, 0]])),
    C("manipulation", "take_along_axis", X, np.array([[0, 3], [1, 1], [2, 0]]), 1),
    C("manipulation", "index_select", X, np.array([3, 1]), axis=1),
    C("manipulation", "index_sample", X, np.array([[0, 3], [1, 1], [2, 0]])),
    C("manipulation", "scatter", X, np.array([2, 0]), POS[:2]),
    C("manipulation", "scatter", X, np.array([2, 0]), POS[:2], overwrite=False),
    C("manipulation", "scatter_nd_add", X, np.array([[1, 2], [1, 2], [0, 0]]),
      np.array([1.0, 2.0, 3.0], np.float32)),
    C("manipulation", "scatter_nd", np.array([[1], [3]]), POS[:2], [5, 4]),
    C("manipulation", "put_along_axis", X, np.array([[0], [3], [1]]), 9.0, 1),
    C("manipulation", "put_along_axis", X, np.array([[0], [3], [1]]),
      POS[:, :1], 1, reduce="add"),
    C("manipulation", "masked_select", X, X > 0),
    C("manipulation", "masked_select", X, X > 0, size=9, fill_value=-1.0),
    C("manipulation", "where_index", X > 0), C("manipulation", "nonzero", X3 > 0.5, size=8),
    C("manipulation", "unique", INTS),
    C("manipulation", "unique", INTS, return_index=True, return_inverse=True,
      return_counts=True),
    C("manipulation", "unique", np.array([3, 1, 3, 2]), return_index=True,
      return_inverse=True, return_counts=True, size=5),
    C("manipulation", "unique", np.array([3, 1, 3, 2]), size=5, fill_value=9),
    C("manipulation", "where", X > 0, X, POS), C("manipulation", "where", X > 0, X, 0.0),
    C("manipulation", "where", X > 0),
    C("manipulation", "pad", X, [1, 0, 2, 1], value=3.0),
    *[C("manipulation", "pad", X3[None], [1, 2, 0, 3], mode=m)
      for m in ("reflect", "replicate", "edge", "circular")],
    C("manipulation", "pad", X3[None], [1, 2, 2, 0], mode="constant",
      data_format="NHWC"),
    C("manipulation", "pad_constant_like", X, X[:2, :3], 5.0),
    C("manipulation", "slice", X3, [0, 2], [1, -3], [2, 4]),
    C("manipulation", "strided_slice", X3, [1, 2], [0, 3], [3, 0], [2, -2]),
    C("manipulation", "crop", X, [2, 2], [2, 3]),
    C("manipulation", "meshgrid", X[0], POS[:, 0]),
    C("manipulation", "meshgrid", X[0], POS[:, 0], indexing="xy"),
    C("manipulation", "shard_index", np.array([[1], [6], [12], [19]]), 20, 2, 1),
    C("manipulation", "shape", X3), C("manipulation", "numel", X3), C("manipulation", "rank", X3),
    C("manipulation", "full_like", X, 2.5), C("manipulation", "full_like", X, 3, "int32"),
    C("manipulation", "zeros_like", X), C("manipulation", "ones_like", X, "int64"),
    C("manipulation", "fill_zeros_like", X),
    C("manipulation", "space_to_depth", X3.reshape(1, 2, 2, 6), 2),
    C("manipulation", "pixel_shuffle", np.tile(X3.reshape(1, 8, 3), (1, 1, 1))
      .reshape(1, 8, 3, 1), 2),
    C("manipulation", "pixel_shuffle", X3.reshape(1, 3, 2, 4), 2,
      data_format="NHWC"),
    C("manipulation", "shuffle_channel", X3.reshape(1, 4, 3, 2), 2),
    C("manipulation", "temporal_shift", np.arange(96, dtype=np.float32)
      .reshape(4, 4, 3, 2), 2, 0.25),
    C("manipulation", "im2sequence", np.arange(72, dtype=np.float32)
      .reshape(2, 1, 6, 6), [2, 3], [2, 2], [1, 0, 1, 1]),
    C("manipulation", "reverse", X, 1), C("manipulation", "unique_with_counts", INTS),
    C("manipulation", "unique_with_counts", INTS, size=12, fill_value=0),
    C("manipulation", "crop_tensor", X3, [-1, 2, 3], [0, 1, 1]),
    # search
    C("search", "argsort", TIES), C("search", "argsort", TIES,
                                      descending=True),
    C("search", "argsort", X, axis=0), C("search", "sort", TIES),
    C("search", "sort", TIES, descending=True),
    C("search", "argmax", X), C("search", "argmin", X, axis=0,
                                  keepdim=True),
    C("search", "argmax", TIES[:1], dtype="int32"),
    C("search", "topk", TIES, 4), C("search", "topk", TIES, 3,
                                      largest=False),
    C("search", "topk", X, 2, axis=0), C("search", "topk", INTS, 2),
    C("search", "kthvalue", TIES, 3), C("search", "kthvalue", X, 2,
                                          axis=0, keepdim=True),
    C("search", "mode", TIES), C("search", "mode", INTS % 3, axis=0,
                                   keepdim=True),
    C("search", "searchsorted", SORTED, np.array([1.0, 3.0, -1.0, 9.0])),
    C("search", "searchsorted", SORTED, np.array([1.0, 2.5]), right=True),
    C("search", "searchsorted", np.sort(X, 1), POS[:, :2]),
    C("search", "bucketize", np.array([1.0, 3.0, 0.0], np.float32), SORTED),
    C("search", "bucketize", np.array([1.0, 3.0], np.float32), SORTED,
      right=True),
    *[C("search", n, X, np.where(X > 0, X, POS)) for n in (
        "equal", "not_equal", "less_than", "less_equal", "greater_than",
        "greater_equal", "equal_all", "allclose", "isclose")],
    C("search", "equal_all", X, X), C("search", "equal_all", X, X[:2]),
    C("search", "allclose", X, X + 1e-7), C("search", "isclose", SPECIAL,
                                             SPECIAL, equal_nan=True),
    *[C("search", n, BOOLS, BOOLS[::-1]) for n in (
        "logical_and", "logical_or", "logical_xor")],
    C("search", "logical_not", BOOLS),
    *[C("search", n, INTS, INTS[::-1]) for n in (
        "bitwise_and", "bitwise_or", "bitwise_xor")],
    C("search", "bitwise_not", INTS),
]

# the functions the random, creation and control-flow checks cover (by
# name)
RANDOM = {"uniform", "uniform_random", "gaussian", "gaussian_random",
          "normal", "standard_normal", "randn", "rand", "randint",
          "randperm", "truncated_gaussian_random", "truncated_normal",
          "bernoulli", "multinomial", "shuffle", "shuffle_batch",
          "sample_logits", "poisson", "exponential"}
CREATION = {"fill_constant", "full", "zeros", "ones", "arange", "linspace",
            "eye", "is_empty", "uniform_random_batch_size_like",
            "gaussian_random_batch_size_like"}
CONTROL = {"while_loop", "cond", "case", "switch_case", "scan",
           "fori_loop", "static_rnn", "py_func", "print_op"}



# (function, args, kwargs, mean, standard deviation) of each random op's
# distribution at these arguments (the truncated normals' from
# scipy.stats.truncnorm); ``n`` stands for the sample count
RANDOM_MOMENTS = [
    ("uniform", ("n",), {"min": -2.0, "max": 3.0}, 0.5, 1.4433756729740643),
    ("uniform_random", ("n",), {}, 0.0, 0.5773502691896258),
    ("gaussian", ("n",), {"mean": 1.0, "std": 2.0}, 1.0, 2.0),
    ("gaussian_random", ("n",), {}, 0.0, 1.0),
    ("standard_normal", ("n",), {}, 0.0, 1.0),
    ("randn", ("n",), {}, 0.0, 1.0),
    ("rand", ("n",), {}, 0.5, 0.28867513459481287),
    ("truncated_gaussian_random", ("n",), {"mean": 0.5, "std": 2.0}, 0.5,
     2.0 * 0.8796256610342398),
    ("truncated_normal", ("n",), {"a": -1.0, "b": 0.5},
     -0.20663121806153306, 0.41566002825204773),
    ("exponential", ("n",), {"rate": 2.0}, 0.5, 0.5),
    ("randint", (3, 9), {"shape": "n"}, 5.5, 1.707825127659933),
]


def control_flow_runs():
    """``[run(module, x)]``: calls of every ``ops.control_flow`` function
    but ``py_func``/``print_op`` on a [3, 4] float array ``x``, written
    with arithmetic both array types have, so the JAX module and the
    port's (on any device) run the same bodies."""

    def while_loop(m, x):
        return m.while_loop(lambda i, s: i < 4, lambda i, s: (i + 1, s + x),
                            [0, x * 0])

    def cond_python(m, x):
        return m.cond(True, lambda v: v * 2, lambda v: v - 1, x)

    def cond_tensor(m, x):
        return m.cond(x.sum() > 100, lambda v: (v * 2, v + 1),
                      lambda v: (v - 1, v * 3), x)

    def case(m, x):
        return m.case([(x.sum() > 100, lambda: x * 2),
                       (x.sum() < 100, lambda: x + 5)], default=lambda: x)

    def switch_list(m, x):
        return [m.switch_case(i, [lambda: x, lambda: x * 2, lambda: x * 3])
                for i in (0, 2, 7)]

    def switch_default(m, x):
        return [m.switch_case(i, [lambda: x, lambda: x * 2],
                              default=lambda: x - 9) for i in (1, 5, -1)]

    def switch_dict(m, x):
        return [m.switch_case(k, {1: lambda: x, 4: lambda: x * 4},
                              default=lambda: x * 0) for k in (1, 4, 3)]

    def switch_tensor(m, x):
        idx = (x[0, 0] > -1000.0) * 1  # an integer array, 1
        return m.switch_case(idx, [lambda: x, lambda: x * 2, lambda: x * 3])

    def scan(m, x):
        return m.scan(lambda c, r: (c + r, c * r), x[0] * 0 + 1, x)

    def scan_reverse(m, x):
        return m.scan(lambda c, r: (c + r, c - r), x[0], x, reverse=True)

    def fori_loop(m, x):
        return m.fori_loop(0, 3, lambda i, v: v * 2 + i, x)

    def static_rnn(m, x):
        return m.static_rnn(lambda xt, h: (xt + h, xt + h * 0.5),
                            x.reshape(1, 3, 4), x[0:1] * 0)

    return [while_loop, cond_python, cond_tensor, case, switch_list,
            switch_default, switch_dict, switch_tensor, scan, scan_reverse,
            fori_loop, static_rnn]


def tensor_array_run(m, x, **kw):
    """Every ``ops.tensor_array`` function over a [3, 4] array ``x``
    (``kw``: the port's ``device``); returns their outputs."""
    a = m.create_array(4, (4,), "float32", **kw)
    a = m.array_write(a, 1, x[0])
    a = m.write_to_array(a, 0, x[1])
    a = a.write(7, x[2])  # clamped to the last slot
    outs = [m.array_read(a, 1), m.read_from_array(a, 0), a.read(-3),
            m.array_length(a), a.stack(),
            m.tensor_array_to_tensor(a, axis=1),
            m.tensor_array_to_tensor(a, axis=0, use_stack=False)]
    seq = m.lod_tensor_to_array(x.reshape(1, 3, 4), None)
    outs += [seq.data, m.array_length(seq), m.array_to_lod_tensor(seq),
             len(a)]
    return outs


# ---------------------------------------------------------------------------
# the recurrent and sequence stack
# ---------------------------------------------------------------------------

SEQ_MODULES = ("sequence", "crf", "rnn_functional", "sampling", "sparse")

S = np.random.default_rng(23)
F3 = S.normal(size=(3, 5, 4)).astype(np.float32)
F3B = S.normal(size=(3, 3, 4)).astype(np.float32)
F2 = S.normal(size=(3, 4)).astype(np.float32)
LEN = np.array([5, 2, 0], np.int64)
LEN2 = np.array([1, 3, 2], np.int64)
IDS = S.integers(1, 9, size=(3, 6)).astype(np.int64)
IDS2 = S.integers(1, 9, size=(3, 4)).astype(np.int64)
ILEN = np.array([6, 3, 0], np.int64)


def _logp(*shape):
    z = S.normal(size=shape).astype(np.float32)
    return (z - np.log(np.exp(z).sum(-1, keepdims=True))).astype(np.float32)


# CTC: [T=7, B=4, C=5] log-probs, blank 0; row 0 repeats a label (needs a
# blank between), row 1 has a short input, row 2 an empty label, row 3 a
# label longer than its input (no alignment: ~1e30)
CTC_LP = _logp(7, 4, 5)
CTC_LAB = np.array([[1, 1, 2, 0], [3, 4, 0, 0], [0, 0, 0, 0],
                    [1, 2, 3, 4]], np.int64)
CTC_LABLEN = np.array([3, 2, 0, 4], np.int64)
CTC_INLEN = np.array([7, 4, 5, 3], np.int64)
CRF_EM = S.normal(size=(3, 5, 4)).astype(np.float32)
CRF_TR = S.normal(size=(6, 4)).astype(np.float32)
CRF_LAB = S.integers(0, 4, size=(3, 5)).astype(np.int64)
CRF_LEN = np.array([5, 3, 1], np.int64)
CHUNK_INF = np.array([[0, 1, 4, 2, 3, 3], [2, 3, 0, 1, 1, 4],
                      [1, 1, 4, 0, 2, 2]], np.int64)
CHUNK_LAB = np.array([[0, 1, 4, 2, 3, 4], [2, 3, 0, 4, 1, 4],
                      [0, 1, 4, 0, 2, 3]], np.int64)
NCE_W = S.normal(size=(11, 4)).astype(np.float32)
NCE_B = S.normal(size=(11,)).astype(np.float32)
NCE_NEG = S.integers(0, 11, size=(3, 5)).astype(np.int64)
H = 3


def _r(*shape):
    return (S.normal(size=shape) * 0.5).astype(np.float32)


SEQ_CASES = [
    C("sequence", "sequence_mask", LEN, 6),
    C("sequence", "sequence_mask", LEN2, dtype="float32"),
    *[C("sequence", "sequence_pool", F3, LEN, t, pad_value=1.5)
      for t in ("sum", "sqrt", "average", "mean", "max", "min", "first",
                "last")],
    C("sequence", "sequence_softmax", F3, LEN),
    C("sequence", "sequence_softmax", F3[..., 0], LEN2),
    C("sequence", "sequence_pad", F3, LEN, 7, pad_value=-1.0),
    C("sequence", "sequence_pad", F3, LEN, 3),
    C("sequence", "sequence_unpad", F3, LEN),
    C("sequence", "sequence_reverse", F3, LEN),
    C("sequence", "sequence_reverse", IDS, ILEN),
    C("sequence", "sequence_expand", F2, LEN2),
    C("sequence", "sequence_expand", F2, LEN2, max_len=5),
    C("sequence", "sequence_expand_dense", F2, LEN, 6),
    C("sequence", "sequence_concat", [F3, F3B], [LEN, LEN2]),
    C("sequence", "sequence_enumerate", IDS, ILEN, 3, pad_value=0),
    C("sequence", "sequence_erase", IDS, ILEN, [2, 5]),
    C("sequence", "sequence_slice", F3, LEN, np.array([1, 0, 0]),
      np.array([3, 2, 0])),
    C("sequence", "sequence_first_step", F3, LEN),
    C("sequence", "sequence_last_step", F3, LEN),
    C("sequence", "sequence_conv", F3, LEN, _r(12, 5), 3,
      context_start=-1, bias=_r(5)),
    C("sequence", "sequence_expand_as", F2, LEN2),
    C("sequence", "sequence_reshape", S.normal(size=(3, 4, 6)).astype(
        np.float32), np.array([4, 2, 0]), 12),
    C("sequence", "sequence_scatter", F2, np.array([[0, 3, 3, 1],
                                                    [2, 2, 0, 1],
                                                    [1, 0, 3, 2]]),
      _r(3, 4), np.array([4, 2, 0])),
    C("sequence", "sequence_topk_avg_pooling",
      S.normal(size=(2, 2, 3, 5)).astype(np.float32), np.array([3, 2]),
      np.array([5, 3]), [1, 3], 2),
    C("sequence", "lod_reset", F3, LEN, np.array([3, 4])),
    C("sequence", "filter_by_instag", F2, np.array([[1, 0, 0], [3, 7, 0],
                                                    [2, 2, 5]]),
      np.array([2, 7])),
    C("sequence", "edit_distance", IDS, ILEN, IDS2, np.array([4, 2, 3])),
    C("sequence", "edit_distance", IDS, ILEN, IDS2, np.array([4, 2, 3]),
      normalized=False),
    C("sequence", "ctc_greedy_decoder", _logp(3, 6, 5),
      np.array([6, 4, 0])),
    C("sequence", "ctc_greedy_decoder", _logp(3, 6, 5),
      np.array([6, 6, 2]), blank=0),
    C("sequence", "lod_append", LEN, np.array([1, 2, 3])),
    C("sequence", "reorder_lod_tensor_by_rank", F3, np.array([2, 5, 2])),
    C("sequence", "reorder_lod_tensor_by_rank", F3, LEN2, reverse=False),
    # the CTC losses
    *[C("loss", "ctc_loss", CTC_LP, CTC_LAB, CTC_INLEN, CTC_LABLEN,
        reduction=r) for r in ("none", "sum", "mean")],
    C("loss", "ctc_loss", CTC_LP[:, :3], np.minimum(CTC_LAB[:3, :3], 3),
      CTC_INLEN[:3],
      CTC_LABLEN[:3], blank=4, reduction="none"),
    C("loss", "warpctc", CTC_LP, CTC_LAB, CTC_INLEN, CTC_LABLEN),
    C("loss", "warpctc", CTC_LP, CTC_LAB, CTC_INLEN, CTC_LABLEN,
      norm_by_times=True),
    # crf
    C("crf", "linear_chain_crf", CRF_EM, CRF_TR, CRF_LAB, CRF_LEN),
    C("crf", "crf_decoding", CRF_EM, CRF_TR, CRF_LEN),
    C("crf", "chunk_eval", CHUNK_INF, CHUNK_LAB, np.array([6, 5, 4]), 2),
    C("crf", "chunk_eval", CHUNK_INF, CHUNK_LAB, np.array([6, 6, 6]), 2,
      chunk_scheme="IOE"),
    # sampling: the deterministic functions, NCE on given negatives
    C("sampling", "hsigmoid_loss", F2, _r(5, 4), np.array([0, 3, 5]), 6),
    C("sampling", "hsigmoid_loss", F2, _r(5, 4), np.array([0, 3, 5]), 6,
      bias=_r(5)),
    C("sampling", "hsigmoid_loss", F2, _r(5, 4), np.array([0, 3, 5]),
      bias=_r(5), path_table=np.array([[0, 2, -1], [0, 1, 4], [3, -1, -1]]),
      path_code=np.array([[1, 0, -1], [0, 1, 1], [1, -1, -1]])),
    C("sampling", "nce_loss", F2, NCE_W, np.array([2, 7, 10]), 11, 5,
      custom_neg_samples=NCE_NEG),
    C("sampling", "nce_loss", F2, NCE_W, np.array([2, 7, 10]), 11, 5,
      bias=NCE_B, sampler="log_uniform", custom_neg_samples=NCE_NEG),
    C("sampling", "nce_loss", F2, NCE_W, np.array([2, 7, 10]), 11, 5,
      custom_neg_samples=NCE_NEG[0]),
    C("sampling", "hash_bucket", np.array([[0], [1], [-7], [123456789],
                                           [2 ** 31 - 1]]), 1000, 3),
    C("sampling", "hash_bucket", np.array([5, 77, 4096]), 97),
    # rnn_functional, forward
    C("rnn_functional", "lstm_unit", _r(3, 4 * H), _r(3, H), _r(3, H),
      _r(H, 4 * H), _r(4 * H), forget_bias=1.0),
    C("rnn_functional", "gru_unit", _r(3, 3 * H), _r(3, H), _r(H, 3 * H),
      _r(3 * H)),
    C("rnn_functional", "dynamic_lstm", _r(3, 5, 4 * H), _r(H, 4 * H),
      _r(7 * H), LEN2, use_peepholes=True, is_reverse=True),
    C("rnn_functional", "dynamic_lstmp", _r(3, 5, 4 * H), _r(2, 4 * H),
      _r(H, 2), _r(4 * H), LEN),
    C("rnn_functional", "dynamic_gru", _r(3, 5, 3 * H), _r(H, 3 * H),
      _r(3 * H), LEN),
    C("rnn_functional", "lstm", _r(3, 5, 4), _r(2, 3, H), _r(2, 3, H),
      [{"w_ih": _r(4, 4 * H), "w_hh": _r(H, 4 * H), "b": _r(4 * H)},
       {"w_ih": _r(H, 4 * H), "w_hh": _r(H, 4 * H), "b": _r(4 * H)}],
      LEN2, num_layers=2),
]

# the sampled functions (checked by shape, device and the same draw from
# the same seed)
SEQ_RANDOM = {"sampled_softmax_with_cross_entropy"}
SPARSE_ROWS = np.array([3, 1, 3, 0, 5], np.int64)
SPARSE_VALS = S.normal(size=(5, 4)).astype(np.float32)
SPARSE_P = S.normal(size=(6, 4)).astype(np.float32)


def sparse_runs():
    """``[run(module, array)]``: calls of every ``ops.sparse`` function,
    ``array`` turning numpy into the package's arrays; each returns a
    list of arrays."""

    def rs(m, a, rows=SPARSE_ROWS, vals=SPARSE_VALS):
        return m.RowSlices(a(rows), a(vals), 6)

    def to_dense(m, a):
        return [m.to_dense(rs(m, a))]

    def merge_rows(m, a):
        s = m.merge_rows(rs(m, a))
        return [s.rows, s.values, m.to_dense(s)]

    def scatter_apply(m, a):
        return [m.scatter_apply(a(SPARSE_P), rs(m, a),
                                lambda r, v: r * 0.5 - v)]

    def embedding_grad(m, a):
        s = m.embedding_grad(a(IDS[:2, :3]), a(F3[:2, :3]), 9)
        return [s.rows, s.values, m.to_dense(s)]

    def add(m, a):
        s = m.add(rs(m, a), rs(m, a, SPARSE_ROWS[:2], SPARSE_VALS[:2]))
        return [s.rows, s.values, m.to_dense(s)]

    return [to_dense, merge_rows, scatter_apply, embedding_grad, add]
