"""The port's ``Tensor`` (``tests/test_tensor.py``'s counterpart), its places
and its entry points, held against the JAX package's ``Tensor`` on the
same inputs.

By design ``shape`` stays a ``torch.Size`` (equal to a tuple) and
``dtype`` a ``torch.dtype`` (``paddle.float32`` is ``torch.float32``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch.framework import place as _place  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu():
    prev = _place._expected_place
    pt.set_device("cpu")
    yield
    _place._expected_place = prev


def _same(got, want):
    np.testing.assert_allclose(np.asarray(got.numpy()), np.asarray(want.numpy()), rtol=1e-6)


def test_creation_and_dtype_default():
    t = pt.to_tensor([[1.0, 2.0], [3.0, 4.0]])
    j = jp.to_tensor([[1.0, 2.0], [3.0, 4.0]])
    assert t.shape == (2, 2) and list(t.shape) == j.shape
    assert t.dtype == pt.float32 and str(j.dtype) == "float32"  # float64 input defaults to fp32
    assert isinstance(t, torch.Tensor) and t.stop_gradient and t.place == pt.CPUPlace()


def test_explicit_dtype():
    t = pt.to_tensor([1, 2], dtype="float64")
    assert t.dtype == pt.float64 and str(t.dtype) == "torch.float64"


def test_numpy_roundtrip():
    arr = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    np.testing.assert_array_equal(pt.to_tensor(arr).numpy(), arr)
    grad = pt.to_tensor(arr, stop_gradient=False)
    np.testing.assert_array_equal((grad * 1.0).numpy(), arr)  # numpy() detaches first


def test_arith_dunders():
    a, b = [1.0, 2.0], [3.0, 4.0]
    pa, pb, ja, jb = pt.to_tensor(a), pt.to_tensor(b), jp.to_tensor(a), jp.to_tensor(b)
    for fn in (lambda x, y: x + y, lambda x, y: x - y, lambda x, y: x * y,
               lambda x, y: y / x, lambda x, y: x ** 2, lambda x, y: -x, lambda x, y: 2 + x,
               lambda x, y: 2 - x, lambda x, y: 2 / x, lambda x, y: x @ y, lambda x, y: y % x,
               lambda x, y: y // x, lambda x, y: abs(-x)):
        got = fn(pa, pb)
        assert isinstance(got, pt.Tensor)
        _same(got, fn(ja, jb))


def test_comparison():
    a, b = pt.to_tensor([1.0, 5.0]), pt.to_tensor([3.0, 3.0])
    np.testing.assert_array_equal((a < b).numpy(), [True, False])
    np.testing.assert_array_equal((a >= b).numpy(), [False, True])
    np.testing.assert_array_equal((a == a).numpy(), [True, True])


def test_getitem_setitem():
    t = pt.to_tensor(np.arange(12, dtype=np.float32).reshape(3, 4))
    np.testing.assert_allclose(t[1].numpy(), [4, 5, 6, 7])
    np.testing.assert_allclose(t[0, 2].numpy(), 2)
    np.testing.assert_allclose(t[:, 1].numpy(), [1, 5, 9])
    t[0] = 0.0
    np.testing.assert_allclose(t[0].numpy(), [0, 0, 0, 0])


def test_methods():
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    t, j = pt.to_tensor(arr), jp.to_tensor(arr)
    assert t.sum().item() == j.sum().item() == 15
    assert t.mean().item() == 2.5 and t.max().item() == 5 and t.min().item() == 0
    for fn in (lambda x: x.sum(axis=1, keepdim=True), lambda x: x.max(axis=0),
               lambda x: x.prod(axis=1), lambda x: x.reshape([3, 2]), lambda x: x.T,
               lambda x: x.transpose([1, 0]), lambda x: x.flatten(), lambda x: x.unsqueeze(0),
               lambda x: x.squeeze(), lambda x: x.argmax(axis=1), lambda x: x.exp(),
               lambda x: x.clip(1.0, 4.0), lambda x: x.pow(2), lambda x: x.norm(),
               lambda x: x.matmul(x, transpose_y=True), lambda x: x.astype("int32"),
               lambda x: x.sqrt(), lambda x: x.abs(), lambda x: x.tanh()):
        got, want = fn(t), fn(j)
        assert list(got.shape) == list(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), rtol=1e-5, atol=1e-6)
    assert t.size == 6 and t.size() == (2, 3) and t.size(1) == 3 and len(t) == 2
    assert t.transpose(0, 1).shape == (3, 2)  # torch's call form too


def test_item_and_bool():
    t = pt.to_tensor([5.0])
    assert float(t) == 5.0 and int(t) == 5
    assert bool(t > 0)


def test_set_value_and_gradients():
    t = pt.to_tensor([1.0, 2.0])
    t.set_value(np.array([7.0, 8.0], np.float32))
    np.testing.assert_allclose(t.numpy(), [7, 8])
    w = pt.to_tensor([1.0, 2.0], stop_gradient=False)
    (w * w).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), [2, 4])
    w.clear_grad()
    assert w.grad is None and not w.stop_gradient and w.is_leaf
    g, = pt.grad((w * 3).sum(), w)
    np.testing.assert_allclose(g.numpy(), [3, 3])
    with pt.no_grad():
        assert (w * 2).stop_gradient


def test_creation_apis():
    assert pt.zeros([2, 3]).shape == (2, 3)
    assert pt.ones([2], dtype="int32").dtype == pt.int32
    np.testing.assert_allclose(pt.full([2], 3.5).numpy(), [3.5, 3.5])
    np.testing.assert_array_equal(pt.arange(5).numpy(), np.arange(5))
    assert pt.eye(3).numpy()[1, 1] == 1
    assert pt.linspace(0, 1, 5).shape == (5,)
    r = pt.rand([4, 4])
    assert 0 <= float(r.min().item()) and float(r.max().item()) <= 1


def test_rng_determinism():
    pt.seed(42)
    a = pt.randn([3]).numpy()
    pt.seed(42)
    np.testing.assert_array_equal(a, pt.randn([3]).numpy())


def test_where_concat_stack_split():
    a, b = pt.to_tensor([1.0, 2.0]), pt.to_tensor([3.0, 4.0])
    np.testing.assert_allclose(pt.concat([a, b]).numpy(), [1, 2, 3, 4])
    np.testing.assert_allclose(pt.stack([a, b]).numpy(), [[1, 2], [3, 4]])
    parts = pt.split(pt.arange(6, dtype="float32"), 3)
    assert len(parts) == 3
    np.testing.assert_allclose(parts[1].numpy(), [2, 3])
    np.testing.assert_allclose(pt.where(pt.to_tensor([True, False]), a, b).numpy(), [1, 4])


def test_cast_and_one_hot():
    oh = pt.nn.functional.one_hot(pt.to_tensor([0, 2]), 3)
    np.testing.assert_allclose(oh.numpy(), [[1, 0, 0], [0, 0, 1]])


def test_parameter_is_a_torch_parameter():
    p = pt.Parameter(np.ones((2, 3), np.float32), name="w")
    assert isinstance(p, torch.nn.Parameter) and isinstance(p, pt.Tensor)
    assert p.name == "w" and p.trainable and not p.stop_gradient and p.persistable
    m = torch.nn.Module()
    m.w = p
    assert dict(m.named_parameters())["w"] is p
    np.testing.assert_array_equal(p.numpy(), np.ones((2, 3)))


def test_places_and_devices():
    assert pt.get_device() == "cpu" and pt.device.get_device() == "cpu"
    assert pt.TPUPlace(0) == pt.CUDAPlace(0) != pt.CPUPlace()
    assert pt.set_device("gpu:1") == pt.CUDAPlace(1)
    pt.set_device("cpu")
    assert pt.device.memory_allocated() >= 0 and isinstance(pt.device.memory_stats(), dict)
    assert pt.get_default_dtype() == "float32"
    pt.set_default_dtype("float64")
    try:
        assert pt.zeros([2]).dtype == pt.float64
    finally:
        pt.set_default_dtype("float32")


def test_to_tensor_without_a_card_raises(monkeypatch):
    """No card and no ``set_device("cpu")``: the entry points refuse rather
    than falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_place, "_expected_place", None)
    for call in (lambda: pt.to_tensor([1.0]), lambda: pt.zeros([2]), pt.get_device,
                 lambda: pt.randn([2])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    pt.set_device("cpu")
    assert pt.to_tensor([1.0]).place == pt.CPUPlace()


def test_host_reads_refuse_inside_a_compiled_step():
    from paddle_tpu_torch.runtime.compiled import compiled_step

    t = pt.to_tensor([1.0, 2.0])
    with compiled_step():
        for read in (bool, float, lambda x: x.item(), lambda x: x.numpy(),
                     lambda x: x.tolist()):
            with pytest.raises(RuntimeError, match="compiled step"):
                read(t[:1])
