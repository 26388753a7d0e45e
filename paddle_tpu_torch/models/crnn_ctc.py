"""The CRNN-CTC OCR model (ref: the warpctc pipeline, ``warpctc_op.cc``
and ``ctc_align_op.cu``, of models like ocr_recognition).

Counterpart of ``paddle_tpu.models.crnn_ctc``: two conv + BatchNorm +
ReLU + 2x2 max-pool stages collapse the height, a bidirectional GRU
runs over the width, and a linear head gives per-frame logits over the
classes and the CTC blank (the last class, the reference's convention);
``loss`` is ``ops.loss.ctc_loss`` (``"mean"``) and ``decode``
``ops.sequence.ctc_greedy_decoder``. The JAX model's parameter and
buffer names, so its ``param_dict()`` and ``buffer_dict()`` load by
name. Weights are drawn on ``device`` (None: the card) from a generator
seeded with ``seed``.
"""

from __future__ import annotations

import torch

from ..core.place import resolve_device
from ..nn.conv import Conv2D
from ..nn.layer import Layer
from ..nn.layers import Linear
from ..nn.norm import BatchNorm2D
from ..nn.rnn import GRU
from ..ops.loss import ctc_loss
from ..ops.nn_functional import max_pool2d
from ..ops.sequence import ctc_greedy_decoder

__all__ = ["CRNNCTC"]


class CRNNCTC(Layer):
    """images [B, 1, H, W] -> logits [B, W // 4, num_classes + 1]."""

    def __init__(self, num_classes: int, height: int = 32, base: int = 32,
                 rnn_hidden: int = 64, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, generator=torch.Generator(
            device=dev).manual_seed(int(seed)))
        self.conv1 = Conv2D(1, base, 3, stride=1, padding=1, **kw)
        self.bn1 = BatchNorm2D(base, device=dev)
        self.conv2 = Conv2D(base, base * 2, 3, stride=1, padding=1, **kw)
        self.bn2 = BatchNorm2D(base * 2, device=dev)
        self.rnn = GRU(base * 2 * (height // 4), rnn_hidden,
                       direction="bidirect", **kw)
        self.head = Linear(2 * rnn_hidden, num_classes + 1, **kw)
        self.blank = num_classes

    def forward(self, images):
        h = max_pool2d(torch.relu(self.bn1(self.conv1(images))), 2, 2)
        h = max_pool2d(torch.relu(self.bn2(self.conv2(h))), 2, 2)
        b, c, hh, ww = h.shape
        seq = h.permute(0, 3, 1, 2).reshape(b, ww, c * hh)
        out, _ = self.rnn(seq)
        return self.head(out)

    def _lengths(self, images, t: int):
        return torch.full((images.shape[0],), t, dtype=torch.int64,
                          device=images.device)

    def loss(self, images, labels, label_lengths):
        logits = self.forward(images)
        log_probs = torch.log_softmax(logits, dim=-1).transpose(0, 1)
        return ctc_loss(log_probs, labels,
                        self._lengths(images, logits.shape[1]),
                        label_lengths, blank=self.blank)

    def decode(self, images):
        logits = self.forward(images)
        return ctc_greedy_decoder(torch.log_softmax(logits, dim=-1),
                                  self._lengths(images, logits.shape[1]),
                                  blank=self.blank)
