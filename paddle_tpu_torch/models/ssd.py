"""SSD single-shot detector (SSDLite).

Counterpart of ``paddle_tpu.models.ssd`` (the reference's
``multi_box_head`` + ``ssd_loss`` + ``detection_output``): four strided
conv + BN + ReLU stages, a loc and a conf head on the stride-8 and
stride-16 maps, and the prior boxes of each, computed at construction
on the CPU with ``ops.detection.prior_box`` in the JAX model's
arithmetic (they equal JAX's) and held as the buffers ``priors`` and
``prior_vars``. The JAX parameter and buffer names, so a JAX
``param_dict()`` and ``buffer_dict()`` load by name. Weights are drawn
on ``device`` (None: the card) from a generator seeded with ``seed``.
"""

from __future__ import annotations

import torch

from ..core.place import resolve_device
from ..nn.conv import Conv2D
from ..nn.layer import Layer, LayerList
from ..nn.layers import ReLU
from ..nn.norm import BatchNorm2D
from ..ops import detection as det

__all__ = ["SSDLite"]


class _ConvBNRelu(Layer):
    def __init__(self, cin: int, cout: int, stride: int = 1,
                 **kw) -> None:
        super().__init__()
        self.conv = Conv2D(cin, cout, 3, stride=stride, padding=1, **kw)
        self.bn = BatchNorm2D(cout, device=kw["device"])
        self.relu = ReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.relu(self.bn(self.conv(x)))


class SSDLite(Layer):
    """images [B, 3, S, S] -> (loc [B, P, 4], conf [B, P, C + 1]); class
    0 is the background (the reference's convention)."""

    def __init__(self, num_classes: int = 20, image_size: int = 128,
                 base: int = 32, device=None, seed: int = 0) -> None:
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, generator=torch.Generator(
            device=dev).manual_seed(int(seed)))
        self.num_classes = num_classes
        self.image_size = image_size
        c = num_classes + 1
        self.stem = _ConvBNRelu(3, base, stride=2, **kw)             # S/2
        self.s1 = _ConvBNRelu(base, base * 2, stride=2, **kw)        # S/4
        self.s2 = _ConvBNRelu(base * 2, base * 4, stride=2, **kw)    # S/8
        self.s3 = _ConvBNRelu(base * 4, base * 4, stride=2, **kw)    # S/16
        feat_strides = (8, 16)
        self.head_feats = ("s2", "s3")
        min_ratio, max_ratio = 0.2, 0.9
        priors, pvars = [], []
        self.loc_heads = LayerList()
        self.conf_heads = LayerList()
        chans = {"s2": base * 4, "s3": base * 4}
        span = max(len(feat_strides) - 1, 1)
        for i, (name, stride) in enumerate(zip(self.head_feats,
                                               feat_strides)):
            fm = image_size // stride
            s_k = min_ratio + (max_ratio - min_ratio) * i / span
            s_k1 = min_ratio + (max_ratio - min_ratio) * (i + 1) / span
            boxes, variances = det.prior_box(
                (fm, fm), (image_size, image_size),
                min_sizes=[s_k * image_size],
                max_sizes=[s_k1 * image_size], aspect_ratios=(2.0,),
                flip=True, clip=True, device="cpu")
            a = boxes.shape[2]
            priors.append(boxes.reshape(-1, 4))
            pvars.append(variances.reshape(-1, 4))
            self.loc_heads.append(Conv2D(chans[name], a * 4, 3, padding=1,
                                         **kw))
            self.conf_heads.append(Conv2D(chans[name], a * c, 3, padding=1,
                                          **kw))
        self.register_buffer("priors", torch.cat(priors).to(dev))
        self.register_buffer("prior_vars", torch.cat(pvars).to(dev))

    def forward(self, images: torch.Tensor) -> tuple:
        b = images.shape[0]
        c = self.num_classes + 1
        f2 = self.s2(self.s1(self.stem(images)))
        f3 = self.s3(f2)
        locs, confs = [], []
        for feat, lh, ch in zip((f2, f3), self.loc_heads, self.conf_heads):
            locs.append(lh(feat).permute(0, 2, 3, 1).reshape(b, -1, 4))
            confs.append(ch(feat).permute(0, 2, 3, 1).reshape(b, -1, c))
        return torch.cat(locs, 1), torch.cat(confs, 1)

    def loss(self, images: torch.Tensor, gt_box: torch.Tensor,
             gt_label: torch.Tensor) -> torch.Tensor:
        """The mean over images of ``ssd_loss``: ``gt_box [B, G, 4]``
        normalised corners (0 padded), ``gt_label [B, G]`` in 1..classes
        (-1 padded)."""
        loc, conf = self.forward(images)
        return det.ssd_loss(loc, conf, gt_box, gt_label, self.priors,
                            prior_box_var=None).mean()

    def predict(self, images: torch.Tensor, keep_top_k: int = 20,
                score_threshold: float = 0.3) -> list:
        """``layers.detection_output`` of the softmax scores: one ``(out
        [keep_top_k, 6], valid)`` per image."""
        from ..layers import detection_output
        loc, conf = self.forward(images)
        return detection_output(loc, torch.softmax(conf, -1), self.priors,
                                self.prior_vars.mean(0),
                                keep_top_k=keep_top_k,
                                score_threshold=score_threshold)
