"""``paddle_tpu_torch.io`` against ``paddle_tpu.io`` (``tests/test_io.py``'s counterparts).

The port's loader yields torch tensors on the requested device where the
JAX one yields ``jax.Array``s; their values are compared as numpy arrays,
bit for bit: the batches for ``num_workers`` 0 and 2, with and without
shuffle under one ``np.random.seed`` (the samplers draw from numpy's
global stream with the same calls), the samplers, ``random_split``, the
shared-memory ring and the queue it falls back to. The tests run on the
CPU (``set_device("cpu")``), where buffered batches are CPU tensors.
"""
import gc
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu.io as jio  # noqa: E402

import paddle_tpu_torch as paddle  # noqa: E402
from paddle_tpu_torch import _native  # noqa: E402
from paddle_tpu_torch import io  # noqa: E402
from paddle_tpu_torch.flags import set_flags  # noqa: E402
from paddle_tpu_torch.framework import place as _place  # noqa: E402
from paddle_tpu_torch.io import dataloader as dl  # noqa: E402
from paddle_tpu_torch.monitor import registry  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    prev = _place._expected_place
    paddle.set_device("cpu")
    yield
    _place._expected_place = prev


def _squares(pkg, n=32):
    class Squares(pkg.Dataset):
        def __getitem__(self, i):
            return np.float32(i), np.float32(i * i)

        def __len__(self):
            return n

    return Squares()


def _noisy(pkg, n=24):
    """Samples that differ per index: an image-like array and a label."""
    class Noisy(pkg.Dataset):
        def __getitem__(self, i):
            rng = np.random.RandomState(i)
            return rng.randn(3, 4, 4).astype(np.float32), np.int64(i % 5)

        def __len__(self):
            return n

    return Noisy()


def _stream(pkg, n=10):
    class Stream(pkg.IterableDataset):
        def __iter__(self):
            for i in range(n):
                yield np.float32(i)

    return Stream()


def _np(tree):
    if isinstance(tree, (list, tuple)):
        return [_np(t) for t in tree]
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return np.asarray(tree)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(_np(g), _np(w)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_tensor_dataset_and_batch():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    y = np.arange(6, dtype=np.int64)
    for xs in (x, torch.from_numpy(x), paddle.to_tensor(x)):
        ds = io.TensorDataset([xs, y])
        assert len(ds) == 6
        batches = list(io.DataLoader(ds, batch_size=4, use_buffer_reader=False))
        want = list(jio.DataLoader(jio.TensorDataset([x, y]), batch_size=4,
                                   use_buffer_reader=False))
        _assert_batches_equal(batches, want)
        bx, by = batches[0]
        assert bx.shape == (4, 2) and by.shape == (4,)
        np.testing.assert_array_equal(by, [0, 1, 2, 3])


def test_shuffle_and_drop_last():
    np.random.seed(3)
    got = list(io.DataLoader(_squares(io, 10), batch_size=4, shuffle=True, drop_last=True))
    np.random.seed(3)
    want = list(jio.DataLoader(_squares(jio, 10), batch_size=4, shuffle=True,
                               drop_last=True))
    assert len(got) == 2
    _assert_batches_equal(got, want)
    seen = sorted(int(v) for b in got for v in b[0])
    assert len(seen) == 8  # the last partial batch dropped


def test_iterable_dataset():
    sizes = [b.shape[0] for b in io.DataLoader(_stream(io), batch_size=3)]
    assert sizes == [3, 3, 3, 1]
    got = list(io.DataLoader(_stream(io), batch_size=3))
    _assert_batches_equal(got, list(jio.DataLoader(_stream(jio), batch_size=3)))


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("shuffle", [False, True])
def test_batches_equal_the_jax_loader(workers, shuffle):
    np.random.seed(11)
    got = list(io.DataLoader(_noisy(io), batch_size=5, shuffle=shuffle, num_workers=workers))
    np.random.seed(11)
    want = list(jio.DataLoader(_noisy(jio), batch_size=5, shuffle=shuffle,
                               num_workers=workers))
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for b in got for t in b)
    _assert_batches_equal(got, want)


def test_multiprocess_workers_match_single():
    ds = _squares(io, 20)
    single = list(io.DataLoader(ds, batch_size=5, use_buffer_reader=False))
    multi = list(io.DataLoader(ds, batch_size=5, num_workers=2, use_buffer_reader=False))
    _assert_batches_equal(multi, single)


def test_worker_exception_propagates():
    class Bad(io.Dataset):
        def __getitem__(self, i):
            raise ValueError("boom")

        def __len__(self):
            return 4

    with pytest.raises(ValueError):
        list(io.DataLoader(Bad(), batch_size=2, num_workers=1, use_buffer_reader=False))
    with pytest.raises(ValueError):
        list(io.DataLoader(Bad(), batch_size=2, num_workers=1))


def test_device_prefetch_returns_torch_tensors_on_the_requested_device():
    bx, by = next(iter(io.DataLoader(_squares(io, 8), batch_size=4)))
    assert isinstance(bx, torch.Tensor) and bx.device.type == "cpu"
    bx, by = next(iter(io.DataLoader(_squares(io, 8), batch_size=4,
                                     places=paddle.CPUPlace())))
    assert isinstance(bx, torch.Tensor) and bx.device.type == "cpu"
    np.testing.assert_array_equal(by.numpy(), [0, 1, 4, 9])


def test_no_device_raises_rather_than_the_cpu(monkeypatch):
    """Without a card and without ``set_device("cpu")`` the buffered loader
    raises; the numpy batches need no device."""
    _place._expected_place = None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        iter(io.DataLoader(_squares(io, 8), batch_size=4))
    assert len(list(io.DataLoader(_squares(io, 8), batch_size=4,
                                  use_buffer_reader=False))) == 2


def test_prefetch_without_overlap_gives_the_same_batches():
    np.random.seed(5)
    want = list(io.DataLoader(_noisy(io), batch_size=4, shuffle=True))
    set_flags({"io_prefetch_overlap": False})
    try:
        np.random.seed(5)
        got = list(io.DataLoader(_noisy(io), batch_size=4, shuffle=True))
    finally:
        set_flags({"io_prefetch_overlap": True})
    _assert_batches_equal(got, want)


def test_distributed_batch_sampler_shards():
    ds = _squares(io, 16)
    for shuffle in (False, True):
        for rank in range(4):
            s = io.DistributedBatchSampler(ds, batch_size=2, num_replicas=4, rank=rank,
                                           shuffle=shuffle)
            j = jio.DistributedBatchSampler(_squares(jio, 16), batch_size=2, num_replicas=4,
                                            rank=rank, shuffle=shuffle)
            s.set_epoch(2)
            j.set_epoch(2)
            assert list(s) == list(j) and len(s) == len(j)
    i0 = [i for b in io.DistributedBatchSampler(ds, 2, num_replicas=4, rank=0) for i in b]
    i1 = [i for b in io.DistributedBatchSampler(ds, 2, num_replicas=4, rank=1) for i in b]
    assert len(i0) == len(i1) == 4
    assert not set(i0) & set(i1)


def test_random_split():
    a, b = io.random_split(_squares(io, 10), [7, 3], generator=4)
    ja, jb = jio.random_split(_squares(jio, 10), [7, 3], generator=4)
    assert len(a) == 7 and len(b) == 3
    assert a.indices == ja.indices and b.indices == jb.indices
    with pytest.raises(ValueError):
        io.random_split(_squares(io, 10), [7, 4])


def test_samplers():
    ds = _squares(io, 5)
    assert list(io.SequenceSampler(ds)) == [0, 1, 2, 3, 4]
    assert sorted(io.RandomSampler(ds)) == [0, 1, 2, 3, 4]
    bs = io.BatchSampler(ds, batch_size=2)
    assert list(bs) == [[0, 1], [2, 3], [4]]
    assert len(bs) == 3
    for replacement in (False, True):
        np.random.seed(9)
        got = list(io.RandomSampler(ds, replacement=replacement, num_samples=4))
        np.random.seed(9)
        assert got == list(jio.RandomSampler(_squares(jio, 5), replacement=replacement,
                                             num_samples=4))
    w = [0.1, 0.5, 0.2, 0.2]
    np.random.seed(2)
    got = list(io.WeightedRandomSampler(w, 12))
    np.random.seed(2)
    assert got == list(jio.WeightedRandomSampler(w, 12))


def test_compose_chain_subset_concat():
    x = np.arange(8, dtype=np.float32)
    comp = io.ComposeDataset([io.TensorDataset([x]), io.TensorDataset([x * 2])])
    jcomp = jio.ComposeDataset([jio.TensorDataset([x]), jio.TensorDataset([x * 2])])
    assert [comp[i] for i in range(8)] == [jcomp[i] for i in range(8)]
    # list() would ask an IterableDataset for its len(), which it has not
    chain = [v for v in io.ChainDataset([_stream(io, 3), _stream(io, 2)])]
    assert chain == [v for v in jio.ChainDataset([_stream(jio, 3), _stream(jio, 2)])]
    sub = io.Subset(_squares(io), [3, 1])
    assert len(sub) == 2 and sub[0] == (3.0, 9.0)
    cat = io.dataset.ConcatDataset([_squares(io, 3), _squares(io, 2)])
    jcat = jio.dataset.ConcatDataset([_squares(jio, 3), _squares(jio, 2)])
    assert len(cat) == 5 and [cat[i] for i in range(5)] == [jcat[i] for i in range(5)]


def _transport():
    return {k: registry.counter(f"io/{k}").value for k in ("ring_batches", "queue_batches")}


@pytest.mark.skipif(not _native.available(), reason="no g++ to build the shared-memory ring")
def test_ring_transport_equals_jax_and_counts_its_batches():
    before = _transport()
    got = list(io.DataLoader(_noisy(io), batch_size=4, num_workers=2))
    after = _transport()
    assert after["ring_batches"] - before["ring_batches"] == 6
    assert after["queue_batches"] == before["queue_batches"]
    _assert_batches_equal(got, list(jio.DataLoader(_noisy(jio), batch_size=4, num_workers=2)))


def test_queue_fallback_equals_jax(monkeypatch):
    """Without shared memory, and for a batch larger than the ring, batches
    go through the queue (the JAX loader's behaviour) and are counted
    there."""
    want = list(jio.DataLoader(_noisy(jio), batch_size=4, num_workers=2))
    before = _transport()
    got = list(io.DataLoader(_noisy(io), batch_size=4, num_workers=2,
                             use_shared_memory=False))
    after = _transport()
    assert after["queue_batches"] - before["queue_batches"] == 6
    _assert_batches_equal(got, want)
    monkeypatch.setattr(dl, "RING_CAPACITY", 256)  # smaller than one pickled batch
    before = _transport()
    got = list(io.DataLoader(_noisy(io), batch_size=4, num_workers=2))
    after = _transport()
    assert after["queue_batches"] - before["queue_batches"] == 6
    assert after["ring_batches"] == before["ring_batches"]
    _assert_batches_equal(got, want)


def test_abandoned_iterator_stops_its_fill_thread():
    def fills():
        return [t for t in threading.enumerate() if t.name == "ptt-h2d-prefetch"]

    base = len(fills())
    it = iter(io.DataLoader(_squares(io, 400), batch_size=2, prefetch_factor=2))
    next(it)
    assert len(fills()) == base + 1
    del it
    gc.collect()
    deadline = time.monotonic() + 5
    while len(fills()) > base and time.monotonic() < deadline:
        time.sleep(0.05)
    assert len(fills()) == base


def test_tensor_samples_are_collated():
    class Tensors(io.Dataset):
        def __getitem__(self, i):
            return paddle.to_tensor(np.full((2,), i, np.float32)), torch.tensor(i)

        def __len__(self):
            return 6

    for workers in (0, 2):
        (x, y), = [b for b in io.DataLoader(Tensors(), batch_size=6, num_workers=workers,
                                            use_buffer_reader=False)]
        assert isinstance(x, np.ndarray) and x.shape == (6, 2)
        np.testing.assert_array_equal(y, np.arange(6))


def test_a_worker_refuses_a_sample_on_the_card(monkeypatch):
    """A worker is a forked process that must not touch CUDA: a sample on a
    device (a ``meta`` tensor stands for the card here) raises there, and
    the error reaches the consumer."""
    monkeypatch.setattr(dl, "_in_worker", True)
    with pytest.raises(RuntimeError, match="must not touch CUDA"):
        dl.default_collate_fn([torch.empty(2, device="meta")] * 2)


def test_the_data_path_imports_without_jax_and_is_scanned():
    """The new namespaces import on an interpreter where ``jax`` and
    ``paddle_tpu`` cannot be imported, and the package scan of
    ``tests/test_torch_package.py`` reaches each of their files, ``_native``
    included."""
    import os
    import subprocess
    import sys

    from test_torch_package import PORT_DIR, REPO, _port_files

    code = ("import sys; sys.modules['jax'] = None; sys.modules['paddle_tpu'] = None\n"
            "import paddle_tpu_torch as p\n"
            "from paddle_tpu_torch import io, metric, reader, text, hapi, incubate, _native\n"
            "from paddle_tpu_torch.vision import transforms, datasets\n"
            "from paddle_tpu_torch.models import (VGG, vgg11, vgg13, vgg16, vgg19, MobileNetV1,"
            " MobileNetV2, mobilenet_v1, mobilenet_v2, SEResNeXt, se_resnext50_32x4d,"
            " se_resnext101_32x4d, Word2Vec)\n"
            "assert p.Model is hapi.Model and p.summary is hapi.summary\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=300)
    rel = {os.path.relpath(f, PORT_DIR) for f in _port_files()}
    for sub in ("io", "metric", "reader", "text", "hapi", "incubate", "_native", "vision",
                "utils"):
        files = {f"{sub}/{n}" for n in os.listdir(os.path.join(PORT_DIR, sub))
                 if n.endswith(".py")}
        assert files and files <= rel, sub
    assert {"models/vgg.py", "models/mobilenet.py", "models/se_resnext.py",
            "models/word2vec.py", "distributed/chaos.py"} <= rel
