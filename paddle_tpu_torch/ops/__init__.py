"""Plain ops of the PyTorch package: losses, metrics and attention."""

from . import attention, loss, metrics_ops

__all__ = ["attention", "loss", "metrics_ops"]
