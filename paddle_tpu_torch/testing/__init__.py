"""Testing / chaos-engineering surface.

Counterpart of ``paddle_tpu.testing``. :mod:`faults` is the
deterministic fault-injection registry behind ``FLAGS_fault_spec``: the
port's code carries the injection points (the LLM engine, the KV
allocator, the serving bridge, the checkpoint writer, the train step),
this package carries the trigger logic.
"""

from . import faults  # noqa: F401

__all__ = ["faults"]
