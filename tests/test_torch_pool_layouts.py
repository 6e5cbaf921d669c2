"""The max-pool backward's two layouts (``paddle_tpu_torch.ops.cuda.pool_backward``).

The kernel takes x, y and dy NCHW-contiguous or channels-last (the NCHW
view of an NHWC buffer: how ResNet's fused stem conv hands its output to the
pool) and writes dx in the same layout. Here, on the CPU: the layout planner;
the wrapper refusing a mix; a channels-last x through
``nn.functional.max_pool2d`` with ``FLAGS_use_pallas_pool_bwd`` on giving
the NCHW route's gradient and the JAX kernel's (interpret mode) bit for bit,
in x's layout; and the route handing x to the kernel entry as it lies, with
no copy, on CPU and on non-CPU tensors. ``dy`` holds multiples of 1/8, so
every sum is exact in any order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.ops.pallas.pool_backward import max_pool2d_backward as jax_pool_bwd  # noqa: E402

from paddle_tpu_torch import flags  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.ops.cuda import pool_backward as tpb  # noqa: E402

torch.set_num_threads(1)

CL = torch.channels_last
GEOMS = [
    ((2, 8, 14, 14), (3, 3), (2, 2), (1, 1)),  # the stem's geometry
    ((2, 4, 8, 8), (2, 2), (2, 2), (0, 0)),
    ((1, 6, 12, 16), (3, 3), (1, 1), (1, 1)),
    ((1, 3, 8, 8), (3, 2), (2, 3), (1, 0)),
]


def _out_shape(shape, ks, st, p):
    return shape[:2] + tuple((shape[2 + i] + 2 * p[i] - ks[i]) // st[i] + 1 for i in range(2))


def _channels_last(a):
    """An NCHW numpy array as the NCHW view of an NHWC tensor."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 3, 1))).permute(0, 3, 1, 2)


def _case(shape, ks, st, p, seed=0):
    rng = np.random.RandomState(seed)
    x = np.maximum(rng.randn(*shape).astype(np.float32) - 0.5, 0.0)  # relu'd: zeros tie
    dy = (rng.randint(-32, 32, _out_shape(shape, ks, st, p)) / 8.0).astype(np.float32)
    return x, dy


# -- the planner -------------------------------------------------------------------


def test_memory_layout_names_the_two_layouts():
    x = torch.zeros(2, 3, 4, 5)
    assert tpb.memory_layout(x) == "nchw"
    assert tpb.memory_layout(x.contiguous(memory_format=CL)) == "nhwc"
    assert tpb.memory_layout(torch.zeros(2, 4, 5, 3).permute(0, 3, 1, 2)) == "nhwc"
    assert tpb.memory_layout(x.transpose(2, 3)) is None  # neither
    assert tpb.memory_layout(torch.zeros(2, 1, 4, 5).contiguous(memory_format=CL)) == "nchw"
    assert tpb.memory_layout(torch.zeros(3, 4)) is None


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_plan_layout_takes_one_shared_layout_and_raises_on_a_mix(device):
    x, y = torch.empty(2, 3, 8, 8, device=device), torch.empty(2, 3, 4, 4, device=device)
    xc, yc = x.contiguous(memory_format=CL), y.contiguous(memory_format=CL)
    assert tpb._plan_layout(x, y, y) == "nchw"
    assert tpb._plan_layout(xc, yc, yc) == "nhwc"
    for args in [(xc, y, y), (x, yc, y), (x, y, yc), (xc, yc, y), (x.transpose(2, 3), y, y)]:
        with pytest.raises(ValueError, match="all NCHW-contiguous or all channels-last"):
            tpb._plan_layout(*args)


def test_to_layout_copies_only_what_lies_otherwise():
    x = torch.zeros(2, 3, 4, 5)
    xc = x.contiguous(memory_format=CL)
    assert tpb.to_layout(x, "nchw") is x and tpb.to_layout(xc, "nhwc") is xc
    assert tpb.memory_layout(tpb.to_layout(x, "nhwc")) == "nhwc"
    assert tpb.memory_layout(tpb.to_layout(xc, "nchw")) == "nchw"


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_wrapper_raises_on_mixed_layouts(device):
    x = torch.zeros(1, 2, 4, 4, device=device).contiguous(memory_format=CL)
    y = torch.zeros(1, 2, 2, 2, device=device)
    with pytest.raises(ValueError, match="all NCHW-contiguous or all channels-last"):
        tpb.max_pool2d_backward(x, y, y, (2, 2), (2, 2), (0, 0))


def test_channels_last_non_cpu_tensors_reach_the_kernel_entry():
    """Meta tensors in channels-last pass the layout checks and stop only at
    the device check, where a CUDA tensor launches the kernel."""
    meta = dict(device="meta", memory_format=CL)
    x, y = torch.empty(2, 3, 8, 8, **meta), torch.empty(2, 3, 4, 4, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        tpb.max_pool2d_backward(x, y, y, (2, 2), (2, 2), (0, 0))


# -- the channels-last route ---------------------------------------------------------


@pytest.mark.parametrize("shape,ks,st,p", GEOMS)
def test_wrapper_in_channels_last_equals_nchw_and_the_jax_kernel(shape, ks, st, p):
    x, dy = _case(shape, ks, st, p)
    y = F.max_pool2d(torch.from_numpy(x), ks, st, p)
    want = np.asarray(jax_pool_bwd(jnp.asarray(x), jnp.asarray(y.numpy()), jnp.asarray(dy),
                                   kernel=ks, stride=st, padding=p, interpret=True))
    nchw = tpb.max_pool2d_backward(torch.from_numpy(x), y, torch.from_numpy(dy), ks, st, p)
    cl = tpb.max_pool2d_backward(_channels_last(x), y.contiguous(memory_format=CL),
                                 _channels_last(dy), ks, st, p)
    assert tpb.memory_layout(nchw) == "nchw" and tpb.memory_layout(cl) == "nhwc"
    np.testing.assert_array_equal(nchw.numpy(), want)
    np.testing.assert_array_equal(cl.numpy(), want)


@pytest.mark.parametrize("dy_layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("shape,ks,st,p", GEOMS)
def test_flag_on_channels_last_x_equals_the_nchw_route_and_the_jax_kernel(
        shape, ks, st, p, dy_layout, monkeypatch):
    """``max_pool2d`` with the flag on: a channels-last x (and a dy in
    either layout) gets the gradient of the NCHW route and of the JAX
    kernel, bit for bit, back in channels-last; x reaches the entry as it
    lies, y and dy in x's layout."""
    x, dy = _case(shape, ks, st, p, seed=1)
    monkeypatch.setattr(flags._REGISTRY["use_pallas_pool_bwd"], "value", True)
    seen = []
    real = tpb.max_pool2d_backward
    monkeypatch.setattr(tpb, "max_pool2d_backward",
                        lambda *a, **k: seen.append(a[:3]) or real(*a, **k))
    grads = {}
    for layout in ("nchw", "nhwc"):
        t = (torch.from_numpy(x) if layout == "nchw" else _channels_last(x)).requires_grad_()
        y = F.max_pool2d(t, ks, st, p)
        g = torch.from_numpy(dy) if dy_layout == "nchw" or layout == "nchw" else _channels_last(dy)
        y.backward(g)
        grads[layout] = t.grad
        xs, ys, dys = seen[-1]
        assert xs.data_ptr() == t.data_ptr() and xs.stride() == t.stride()  # no copy of x
        assert {tpb.memory_layout(v) for v in (xs, ys, dys)} == {layout}
    want = np.asarray(jax_pool_bwd(jnp.asarray(x), jnp.asarray(F.max_pool2d(
        torch.from_numpy(x), ks, st, p).numpy()), jnp.asarray(dy), kernel=ks, stride=st,
        padding=p, interpret=True))
    assert len(seen) == 2
    assert tpb.memory_layout(grads["nhwc"]) == "nhwc"
    np.testing.assert_array_equal(grads["nchw"].numpy(), want)
    np.testing.assert_array_equal(grads["nhwc"].numpy(), want)


def test_flag_on_channels_last_route_on_non_cpu_tensors_passes_x_uncopied(monkeypatch):
    """On meta tensors the autograd route hands the entry the saved x with
    its channels-last strides and y, dy in the same layout."""
    monkeypatch.setattr(flags._REGISTRY["use_pallas_pool_bwd"], "value", True)
    seen = []

    def entry(x, y, dy, *geometry):
        seen.append((x.stride(), tpb.memory_layout(y), tpb.memory_layout(dy)))
        return torch.empty_like(x)

    monkeypatch.setattr(tpb, "max_pool2d_backward", entry)
    x = torch.empty(2, 64, 16, 16, device="meta", memory_format=CL).requires_grad_()
    y = F.max_pool2d(x, 3, 2, 1)
    (gx,) = torch.autograd.grad(y, x, torch.empty(y.shape, device="meta"))
    assert seen == [(x.stride(), "nhwc", "nhwc")]
    assert gx.shape == x.shape
