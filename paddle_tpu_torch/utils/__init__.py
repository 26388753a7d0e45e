"""Utilities: DLPack exchange, encrypted model files, the per-op
micro-benchmark and the install check (counterpart of
``paddle_tpu.utils``)."""

from . import crypto  # noqa: F401
from . import dlpack  # noqa: F401
from . import op_bench  # noqa: F401

from .install_check import run_check  # noqa: F401
