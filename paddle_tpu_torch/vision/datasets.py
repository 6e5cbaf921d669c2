"""Built-in datasets (``paddle_tpu/vision/datasets.py:29-80``): ``MNIST``.

Nothing is downloaded. ``MNIST`` reads the idx files when they are present
(the reference's gzip format, under ``$PADDLE_TPU_DATA_HOME/mnist``, by
default ``~/.cache/paddle_tpu/dataset/mnist``, or the paths given) and
otherwise synthesizes a deterministic stand-in with the same shapes,
dtypes and label space: ten class patterns drawn from a crc32 of the class
name, labels and noise from a seed per split, the JAX package's recipe
number for number, so both packages see the same bytes. A synthetic set
says so (``synthetic``, and a warning).
"""
from __future__ import annotations

import gzip
import os
import struct
import warnings
import zlib

import numpy as np

__all__ = ["MNIST"]

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/dataset"))


class _SyntheticMixin:
    """Deterministic stand-in data when the real files are absent."""

    def _synthesize(self, n, image_shape, num_classes, seed):
        warnings.warn(
            f"{type(self).__name__}: real data files not found under {DATA_HOME!r}; "
            "generating deterministic SYNTHETIC samples (self.synthetic=True). Place the "
            "reference-format files there for real-data runs.", RuntimeWarning, stacklevel=3)
        rng = np.random.RandomState(seed)
        # the class patterns come from a split-independent seed, so train
        # and test share them (only noise and labels differ)
        pattern_rng = np.random.RandomState(zlib.crc32(type(self).__name__.encode()) % 2**31)
        bases = [pattern_rng.rand(*image_shape).astype("float32") for _ in range(num_classes)]
        labels = rng.randint(0, num_classes, n).astype("int64")
        images = np.zeros((n,) + image_shape, np.float32)
        for c in range(num_classes):
            images[labels == c] = bases[c][None] * 0.8
        images += rng.rand(n, *image_shape).astype("float32") * 0.2
        self.synthetic = True
        return images, labels


class MNIST(_SyntheticMixin):
    """``paddle.vision.datasets.MNIST``: ``[1, 28, 28]`` float32 images and
    int64 labels; ``mode`` ``"train"`` (2048 synthetic samples) or
    ``"test"`` (512). ``download`` and ``backend`` are accepted for the
    signature: nothing is fetched."""

    IMAGE_SHAPE = (1, 28, 28)
    NUM_CLASSES = 10
    _PREFIX = "mnist"

    def __init__(self, image_path=None, label_path=None, mode="train", transform=None,
                 download=True, backend=None):
        self.mode = mode
        self.transform = transform
        self.synthetic = False
        split = "train" if mode == "train" else "t10k"
        image_path = image_path or os.path.join(DATA_HOME, self._PREFIX,
                                                f"{split}-images-idx3-ubyte.gz")
        label_path = label_path or os.path.join(DATA_HOME, self._PREFIX,
                                                f"{split}-labels-idx1-ubyte.gz")
        if os.path.exists(image_path) and os.path.exists(label_path):
            self.images = self._read_idx_images(image_path)
            self.labels = self._read_idx_labels(label_path)
        else:
            self.images, self.labels = self._synthesize(
                2048 if mode == "train" else 512, self.IMAGE_SHAPE, self.NUM_CLASSES,
                seed=42 if mode == "train" else 43)

    @staticmethod
    def _read_idx_images(path):
        with gzip.open(path, "rb") as f:
            _, n, rows, cols = struct.unpack(">IIII", f.read(16))
            data = np.frombuffer(f.read(), np.uint8).reshape(n, 1, rows, cols)
        return (data.astype("float32") / 255.0 - 0.5) / 0.5

    @staticmethod
    def _read_idx_labels(path):
        with gzip.open(path, "rb") as f:
            struct.unpack(">II", f.read(8))
            return np.frombuffer(f.read(), np.uint8).astype("int64")

    def __getitem__(self, idx):
        img, label = self.images[idx], self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.images)
