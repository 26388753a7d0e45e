"""Plain ops of the PyTorch package: losses and attention."""

from . import attention, loss

__all__ = ["attention", "loss"]
