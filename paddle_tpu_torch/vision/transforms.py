"""Image transforms (``paddle_tpu/vision/transforms.py``): numpy in, numpy out.

Reference parity: incubate/hapi/vision/transforms/ (Compose, Resize,
Normalize, RandomCrop, RandomHorizontalFlip, ToTensor, ...). They work on
numpy CHW arrays on the host, in the DataLoader's workers; the random ones
draw from numpy's global stream with the JAX package's calls in its order,
so one ``np.random.seed`` gives the same crops and flips in both packages.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "Compose", "Normalize", "Resize", "CenterCrop", "RandomCrop",
    "RandomHorizontalFlip", "RandomVerticalFlip", "Transpose", "ToTensor",
    "Pad", "BrightnessTransform",
]


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self.std = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def __call__(self, img):
        return (np.asarray(img, np.float32) - self.mean) / self.std


class Transpose:
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        return np.transpose(img, self.order)


class ToTensor:
    """HWC uint8 -> CHW float32 in [0,1] (passes through CHW float)."""

    def __call__(self, img):
        img = np.asarray(img)
        if img.dtype == np.uint8:
            img = img.astype("float32") / 255.0
            if img.ndim == 3 and img.shape[-1] in (1, 3, 4):
                img = np.transpose(img, (2, 0, 1))
        return img.astype("float32")


def _resize_chw(img, h, w):
    c, ih, iw = img.shape
    yi = (np.arange(h) * (ih / h)).astype(np.int64).clip(0, ih - 1)
    xi = (np.arange(w) * (iw / w)).astype(np.int64).clip(0, iw - 1)
    return img[:, yi][:, :, xi]


class Resize:
    def __init__(self, size, interpolation="nearest"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        return _resize_chw(np.asarray(img), *self.size)


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        c, h, w = img.shape
        th, tw = self.size
        i = max(0, (h - th) // 2)
        j = max(0, (w - tw) // 2)
        return img[:, i : i + th, j : j + tw]


class RandomCrop:
    def __init__(self, size, padding=0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def __call__(self, img):
        if self.padding:
            img = np.pad(
                img,
                ((0, 0), (self.padding,) * 2, (self.padding,) * 2),
                mode="constant",
            )
        c, h, w = img.shape
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return img[:, i : i + th, j : j + tw]


class RandomHorizontalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return img[:, :, ::-1].copy()
        return img


class RandomVerticalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return img[:, ::-1, :].copy()
        return img


class Pad:
    def __init__(self, padding, fill=0):
        self.padding = padding
        self.fill = fill

    def __call__(self, img):
        p = self.padding
        return np.pad(
            img, ((0, 0), (p, p), (p, p)), constant_values=self.fill
        )


class BrightnessTransform:
    def __init__(self, value):
        self.value = value

    def __call__(self, img):
        if self.value == 0:
            return img
        alpha = 1 + np.random.uniform(-self.value, self.value)
        return (img * alpha).astype(img.dtype)
