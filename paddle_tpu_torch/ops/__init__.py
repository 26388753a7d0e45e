"""Plain ops of the PyTorch package: losses, metrics, attention and the
convolution, pooling and BatchNorm ops."""

from . import attention, loss, metrics_ops, nn_functional

__all__ = ["attention", "loss", "metrics_ops", "nn_functional"]
