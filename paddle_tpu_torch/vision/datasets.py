"""Built-in vision datasets (``paddle_tpu/vision/datasets.py``): ``MNIST``,
``FashionMNIST``, ``Cifar10``, ``Cifar100``, ``VOC2012``.

Nothing is downloaded. Each dataset reads the reference's on-disk format
when the files are present under ``$PADDLE_TPU_DATA_HOME`` (by default
``~/.cache/paddle_tpu/dataset``; idx-gzip for MNIST, pickled batches for
CIFAR, the VOCtrainval tar) and otherwise synthesizes a deterministic
stand-in with the same shapes, dtypes and label space from the JAX
package's seeds and recipe, number for number, so both packages see the
same bytes. A synthetic set says so (``synthetic``, and a warning). The
datasets are ``io.Dataset``s of numpy samples.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np

from ..io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "VOC2012"]

from ..utils.data_home import DATA_HOME, warn_synthetic as _warn_synthetic


class _SyntheticMixin:
    """Deterministic stand-in data when the real files are absent.

    The substitution is LOUD: a warning names the dataset and what to do
    to get real data, and ``self.synthetic`` is set so tests/metrics can
    refuse to treat noise-trained numbers as real-data results."""

    def _synthesize(self, n, image_shape, num_classes, seed):
        _warn_synthetic(self)
        rng = np.random.RandomState(seed)
        # class patterns come from a split-independent seed so train and
        # test share the same class structure (only noise/labels differ)
        import zlib

        pattern_rng = np.random.RandomState(
            zlib.crc32(type(self).__name__.encode()) % 2**31
        )
        bases = [
            pattern_rng.rand(*image_shape).astype("float32")
            for _ in range(num_classes)
        ]
        labels = rng.randint(0, num_classes, n).astype("int64")
        images = np.zeros((n,) + image_shape, np.float32)
        for c in range(num_classes):
            images[labels == c] = bases[c][None] * 0.8
        images += rng.rand(n, *image_shape).astype("float32") * 0.2
        self.synthetic = True
        return images, labels


class MNIST(_SyntheticMixin, Dataset):
    """paddle.vision.datasets.MNIST (dataset/mnist.py idx format)."""

    IMAGE_SHAPE = (1, 28, 28)
    NUM_CLASSES = 10
    _PREFIX = "mnist"

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        self.synthetic = False
        split = "train" if mode == "train" else "t10k"
        image_path = image_path or os.path.join(
            DATA_HOME, self._PREFIX, f"{split}-images-idx3-ubyte.gz"
        )
        label_path = label_path or os.path.join(
            DATA_HOME, self._PREFIX, f"{split}-labels-idx1-ubyte.gz"
        )
        if os.path.exists(image_path) and os.path.exists(label_path):
            self.images = self._read_idx_images(image_path)
            self.labels = self._read_idx_labels(label_path)
        else:
            n = 2048 if mode == "train" else 512
            self.images, self.labels = self._synthesize(
                n, self.IMAGE_SHAPE, self.NUM_CLASSES,
                seed=42 if mode == "train" else 43,
            )

    @staticmethod
    def _read_idx_images(path):
        with gzip.open(path, "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            data = np.frombuffer(f.read(), np.uint8).reshape(n, 1, rows, cols)
        return (data.astype("float32") / 255.0 - 0.5) / 0.5

    @staticmethod
    def _read_idx_labels(path):
        with gzip.open(path, "rb") as f:
            magic, n = struct.unpack(">II", f.read(8))
            return np.frombuffer(f.read(), np.uint8).astype("int64")

    def __getitem__(self, idx):
        img, label = self.images[idx], self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    _PREFIX = "fashion-mnist"


class Cifar10(_SyntheticMixin, Dataset):
    """paddle.vision.datasets.Cifar10 (dataset/cifar.py pickled batches)."""

    IMAGE_SHAPE = (3, 32, 32)
    NUM_CLASSES = 10
    _ARCHIVE = "cifar-10-python.tar.gz"

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.mode = mode
        self.transform = transform
        self.synthetic = False
        data_file = data_file or os.path.join(DATA_HOME, self._ARCHIVE)
        if os.path.exists(data_file):
            self.images, self.labels = self._read_archive(data_file, mode)
        else:
            n = 2048 if mode == "train" else 512
            self.images, self.labels = self._synthesize(
                n, self.IMAGE_SHAPE, self.NUM_CLASSES,
                seed=44 if mode == "train" else 45,
            )

    def _read_archive(self, path, mode):
        images, labels = [], []
        want = "data_batch" if mode == "train" else "test_batch"
        with tarfile.open(path) as tar:
            for member in tar.getmembers():
                if want in member.name:
                    d = pickle.load(tar.extractfile(member), encoding="bytes")
                    images.append(d[b"data"])
                    labels.extend(d.get(b"labels", d.get(b"fine_labels")))
        images = np.concatenate(images).reshape(-1, 3, 32, 32)
        images = (images.astype("float32") / 255.0 - 0.5) / 0.5
        return images, np.asarray(labels, "int64")

    def __getitem__(self, idx):
        img, label = self.images[idx], self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    NUM_CLASSES = 100
    _ARCHIVE = "cifar-100-python.tar.gz"


class VOC2012(Dataset):
    """Pascal VOC2012 segmentation (dataset/voc2012.py): samples are
    (image HWC uint8, label mask HW uint8), read from the VOCtrainval
    tar when present (ImageSets/Segmentation/{set}.txt naming JPEG +
    SegmentationClass pairs), else loud synthetic blobs whose mask
    matches the painted class regions. Modes: train -> trainval list,
    test -> train list, val -> val list (voc2012.py:68-85 mapping)."""

    N_CLASSES = 21

    def __init__(self, data_file=None, mode="train", image_size=64):
        self.synthetic = False
        data_file = data_file or os.path.join(
            DATA_HOME, "voc2012", "VOCtrainval_11-May-2012.tar")
        sub = {"train": "trainval", "test": "train", "val": "val"}[mode]
        if os.path.exists(data_file):
            self._load_tar(data_file, sub)
        else:
            self._synthesize(mode, image_size)

    def _load_tar(self, path, sub):
        import tarfile

        try:
            from PIL import Image  # noqa: F401 — fail before first access
        except ImportError as e:  # pragma: no cover
            raise RuntimeError(
                "VOC2012 real-data path needs PIL to decode JPEG/PNG"
            ) from e
        voc = "VOCdevkit/VOC2012"
        # index only; decode lazily per __getitem__ — trainval holds ~3k
        # full-resolution pairs (>1.5 GB decoded), far too much to
        # materialize at construction
        self._tar_path = path
        with tarfile.open(path) as tf:
            names = set(m.name for m in tf.getmembers())
            listing = tf.extractfile(
                f"{voc}/ImageSets/Segmentation/{sub}.txt")
            self._members = []
            for line in listing.read().decode().split():
                im = f"{voc}/JPEGImages/{line}.jpg"
                lm = f"{voc}/SegmentationClass/{line}.png"
                if im in names and lm in names:
                    self._members.append((im, lm))
        # one tar handle PER PROCESS: forked DataLoader workers must not
        # share a file descriptor (concurrent seeks corrupt reads)
        self._tars = {}
        self.data = None

    def _decode(self, i):
        import io
        import os
        import tarfile

        from PIL import Image

        tar = self._tars.get(os.getpid())
        if tar is None:
            tar = tarfile.open(self._tar_path)
            self._tars[os.getpid()] = tar
        im, lm = self._members[i]
        img = Image.open(io.BytesIO(tar.extractfile(im).read()))
        lab = Image.open(io.BytesIO(tar.extractfile(lm).read()))
        return np.array(img, np.uint8), np.array(lab, np.uint8)

    def _synthesize(self, mode, size):
        _warn_synthetic(self)
        self.synthetic = True
        rng = np.random.RandomState({"train": 71, "test": 73,
                                     "val": 72}[mode])
        n = {"train": 64, "test": 32, "val": 16}[mode]
        self.data = []
        for _ in range(n):
            img = rng.randint(0, 40, (size, size, 3)).astype(np.uint8)
            mask = np.zeros((size, size), np.uint8)
            for _ in range(rng.randint(1, 4)):  # paint class rectangles
                cls = rng.randint(1, self.N_CLASSES)
                y0, x0 = rng.randint(0, size // 2, 2)
                h, w = rng.randint(size // 8, size // 2, 2)
                mask[y0:y0 + h, x0:x0 + w] = cls
                img[y0:y0 + h, x0:x0 + w] += np.uint8(cls * 10)
            self.data.append((img, mask))

    def __getitem__(self, i):
        if self.data is None:
            return self._decode(i)
        return self.data[i]

    def __len__(self):
        return (len(self._members) if self.data is None
                else len(self.data))
