"""``fluid.backward`` (ref: python/paddle/fluid/backward.py):
``gradients`` is ``autograd.grad``; nothing records grad ops into a
program, so ``append_backward`` raises, naming the working route."""

from ..autograd import grad as gradients  # noqa: F401


def append_backward(loss, parameter_list=None, no_grad_set=None):
    raise NotImplementedError(
        "append_backward records grad ops into a Program; here use "
        "paddle_tpu_torch.autograd.grad / value_and_grad (or "
        "paddle_tpu_torch.static.TrainStep, which runs the whole "
        "forward+backward+update step)")
