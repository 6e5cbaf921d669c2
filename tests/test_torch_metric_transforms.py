"""``paddle_tpu_torch.metric``, ``vision.transforms`` and ``vision.datasets``
against the JAX package's.

The metrics accumulate on the host in numpy in both packages: on seeded
predictions (numpy in the JAX package, torch tensors in the port) every
accumulated value must be exactly equal. Every transform must give the same
bytes under one ``np.random.seed`` (the random ones draw from numpy's global
stream with the same calls), and every vision dataset's synthesized samples
must be bit-equal (the JAX package's seeds and recipe).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu.metric as jmetric  # noqa: E402
import paddle_tpu.vision.datasets as jdatasets  # noqa: E402
import paddle_tpu.vision.transforms as jT  # noqa: E402

from paddle_tpu_torch import metric  # noqa: E402
from paddle_tpu_torch.vision import datasets  # noqa: E402
from paddle_tpu_torch.vision import transforms as T  # noqa: E402


def _preds(seed, n=64, c=5):
    rng = np.random.RandomState(seed)
    return rng.randn(n, c).astype(np.float32), rng.randint(0, c, (n, 1)).astype(np.int64)


@pytest.mark.parametrize("topk", [(1,), (1, 2), (1, 3, 5)])
def test_accuracy_equals_jax(topk):
    m, jm = metric.Accuracy(topk=topk), jmetric.Accuracy(topk=topk)
    for seed in range(3):
        pred, label = _preds(seed)
        got = m.update(m.compute(torch.from_numpy(pred), torch.from_numpy(label)))
        want = jm.update(jm.compute(pred, label))
        assert got == want
    assert m.accumulate() == jm.accumulate() and m.name() == jm.name()
    m.reset()
    assert m.accumulate() == (0.0 if len(topk) == 1 else [0.0] * len(topk))


def test_accuracy_reads_a_bf16_tensor_as_float():
    pred, label = _preds(4)
    m, jm = metric.Accuracy(), jmetric.Accuracy()
    m.update(m.compute(torch.from_numpy(pred).bfloat16(), torch.from_numpy(label)))
    jm.update(jm.compute(torch.from_numpy(pred).bfloat16().float().numpy(), label))
    assert m.accumulate() == jm.accumulate()


@pytest.mark.parametrize("name", ["Precision", "Recall"])
def test_precision_and_recall_equal_jax(name):
    m, jm = getattr(metric, name)(), getattr(jmetric, name)()
    rng = np.random.RandomState(1)
    for _ in range(4):
        p = rng.rand(40).astype(np.float32)
        y = rng.randint(0, 2, 40).astype(np.int64)
        m.update(torch.from_numpy(p), torch.from_numpy(y))
        jm.update(p, y)
    assert m.accumulate() == jm.accumulate() and m.name() == jm.name()


@pytest.mark.parametrize("two_columns", [False, True])
def test_auc_equals_jax(two_columns):
    m, jm = metric.Auc(num_thresholds=255), jmetric.Auc(num_thresholds=255)
    rng = np.random.RandomState(2)
    for _ in range(3):
        p = rng.rand(50).astype(np.float32)
        if two_columns:
            p = np.stack([1 - p, p], 1)
        y = rng.randint(0, 2, 50).astype(np.int64)
        m.update(torch.from_numpy(p), torch.from_numpy(y))
        jm.update(p, y)
    assert m.accumulate() == jm.accumulate()
    np.testing.assert_array_equal(m._pos, jm._pos)


def _image(seed, hwc=True):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (20, 24, 3), dtype=np.uint8) if hwc
            else rng.rand(3, 20, 24).astype(np.float32))


TRANSFORMS = {
    "ToTensor": lambda m: m.ToTensor(),
    "Normalize": lambda m: m.Normalize([0.5, 0.4, 0.3], [0.2, 0.25, 0.3]),
    "Resize": lambda m: m.Resize((13, 17)),
    "CenterCrop": lambda m: m.CenterCrop(11),
    "RandomCrop": lambda m: m.RandomCrop(12, padding=2),
    "RandomHorizontalFlip": lambda m: m.RandomHorizontalFlip(),
    "RandomVerticalFlip": lambda m: m.RandomVerticalFlip(),
    "Transpose": lambda m: m.Transpose((1, 2, 0)),
    "Pad": lambda m: m.Pad(3, fill=1),
    "BrightnessTransform": lambda m: m.BrightnessTransform(0.4),
    "Compose": lambda m: m.Compose([m.ToTensor(), m.RandomCrop(16), m.RandomHorizontalFlip(),
                                    m.Normalize([0.485, 0.456, 0.406],
                                                [0.229, 0.224, 0.225])]),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_bit_equal_to_jax(name):
    assert sorted(TRANSFORMS) == sorted(jT.__all__)
    t, jt = TRANSFORMS[name](T), TRANSFORMS[name](jT)
    for seed in range(6):
        img = _image(seed, hwc=name in ("ToTensor", "Compose"))
        np.random.seed(100 + seed)
        got = t(img)
        np.random.seed(100 + seed)
        want = jt(img)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,mode", [(n, m) for n in ("MNIST", "FashionMNIST", "Cifar10",
                                                        "Cifar100")
                                       for m in ("train", "test")])
def test_vision_dataset_synthesized_bit_equal(name, mode, monkeypatch, tmp_path):
    monkeypatch.setattr(datasets, "DATA_HOME", str(tmp_path))
    monkeypatch.setattr(jdatasets, "DATA_HOME", str(tmp_path))
    with pytest.warns(RuntimeWarning):
        ds = getattr(datasets, name)(mode=mode, transform=T.Normalize(0.5, 0.5))
    with pytest.warns(RuntimeWarning):
        jds = getattr(jdatasets, name)(mode=mode, transform=jT.Normalize(0.5, 0.5))
    assert ds.synthetic and jds.synthetic and len(ds) == len(jds)
    np.testing.assert_array_equal(ds.images, jds.images)
    np.testing.assert_array_equal(ds.labels, jds.labels)
    for i in (0, 7, len(ds) - 1):
        (x, y), (jx, jy) = ds[i], jds[i]
        np.testing.assert_array_equal(x, jx)
        assert y == jy


@pytest.mark.parametrize("mode", ["train", "test", "val"])
def test_voc2012_synthesized_bit_equal(mode, monkeypatch, tmp_path):
    monkeypatch.setattr(datasets, "DATA_HOME", str(tmp_path))
    monkeypatch.setattr(jdatasets, "DATA_HOME", str(tmp_path))
    with pytest.warns(RuntimeWarning):
        ds = datasets.VOC2012(mode=mode, image_size=32)
    with pytest.warns(RuntimeWarning):
        jds = jdatasets.VOC2012(mode=mode, image_size=32)
    assert len(ds) == len(jds)
    for i in range(len(ds)):
        for a, b in zip(ds[i], jds[i]):
            np.testing.assert_array_equal(a, b)


def test_datasets_are_io_datasets():
    from paddle_tpu_torch.io import Dataset

    for name in ("MNIST", "FashionMNIST", "Cifar10", "Cifar100", "VOC2012"):
        assert issubclass(getattr(datasets, name), Dataset)
