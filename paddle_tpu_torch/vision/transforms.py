"""Vision transforms.

Counterpart of ``paddle_tpu.vision.transforms``: the ten transforms, pure
numpy on CHW float arrays, as there. They run inside ``DataLoader``
worker processes, so they touch no device (the training step does the
device work). A transform that draws (``RandomCrop``,
``RandomHorizontalFlip``, ``BrightnessTransform``) draws from
``np.random.default_rng(seed)``, the same numbers as the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["Compose", "Normalize", "Resize", "CenterCrop", "RandomCrop",
           "RandomHorizontalFlip", "Transpose", "ToCHW", "Pad",
           "BrightnessTransform"]


class Compose:
    def __init__(self, transforms: Sequence) -> None:
        self.transforms = list(transforms)

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class Normalize:
    """(ref: transforms.py Normalize) channel-wise (x - mean) / std on
    CHW float arrays."""

    def __init__(self, mean, std) -> None:
        self.mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self.std = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def __call__(self, img):
        return ((np.asarray(img, np.float32) - self.mean)
                / self.std).astype(np.float32)


def _resize_bilinear_chw(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Separable bilinear resize without PIL/cv2 (zero extra deps)."""
    c, ih, iw = img.shape
    if (ih, iw) == (h, w):
        return img
    ys = (np.arange(h) + 0.5) * ih / h - 0.5
    xs = (np.arange(w) + 0.5) * iw / w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, ih - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, iw - 1)
    y1 = np.minimum(y0 + 1, ih - 1)
    x1 = np.minimum(x0 + 1, iw - 1)
    wy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)
    wx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)
    rows0 = img[:, y0, :]
    rows1 = img[:, y1, :]
    rows = rows0 * (1 - wy)[None, :, None] + rows1 * wy[None, :, None]
    cols0 = rows[:, :, x0]
    cols1 = rows[:, :, x1]
    return (cols0 * (1 - wx)[None, None, :]
            + cols1 * wx[None, None, :]).astype(img.dtype, copy=False)


class Resize:
    def __init__(self, size) -> None:
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        img = np.asarray(img, np.float32)
        return _resize_bilinear_chw(img, self.size[0], self.size[1])


class CenterCrop:
    def __init__(self, size) -> None:
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        _, h, w = img.shape
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return img[:, i:i + th, j:j + tw]


class RandomCrop:
    def __init__(self, size, padding: int = 0,
                 seed: Optional[int] = None) -> None:
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding
        self.rng = np.random.default_rng(seed)

    def __call__(self, img):
        if self.padding:
            img = np.pad(img, ((0, 0), (self.padding, self.padding),
                               (self.padding, self.padding)))
        _, h, w = img.shape
        th, tw = self.size
        if h < th or w < tw:
            raise ValueError(
                f"RandomCrop{(th, tw)} on image {h}x{w} (after padding "
                f"{self.padding}): crop larger than input")
        i = int(self.rng.integers(0, h - th + 1))
        j = int(self.rng.integers(0, w - tw + 1))
        return img[:, i:i + th, j:j + tw]


class RandomHorizontalFlip:
    def __init__(self, prob: float = 0.5,
                 seed: Optional[int] = None) -> None:
        self.prob = prob
        self.rng = np.random.default_rng(seed)

    def __call__(self, img):
        if self.rng.random() < self.prob:
            return img[:, :, ::-1].copy()
        return img


class Transpose:
    """HWC → CHW (or any order)."""

    def __init__(self, order=(2, 0, 1)) -> None:
        self.order = order

    def __call__(self, img):
        return np.ascontiguousarray(np.transpose(img, self.order))


ToCHW = Transpose


class Pad:
    def __init__(self, padding: int) -> None:
        self.padding = padding

    def __call__(self, img):
        p = self.padding
        return np.pad(img, ((0, 0), (p, p), (p, p)))


class BrightnessTransform:
    def __init__(self, value: float, seed: Optional[int] = None) -> None:
        self.value = value
        self.rng = np.random.default_rng(seed)

    def __call__(self, img):
        alpha = 1 + self.rng.uniform(-self.value, self.value)
        return np.clip(img * alpha, 0, 1).astype(np.float32)
