"""Custom op libraries in the port (``paddle_tpu_torch/framework/op_library.py``)
against the JAX package's (``paddle_tpu/framework/op_library.py``).

The JAX custom-op test's C++ source (``tests/test_custom_op.py``
``USER_OP_SRC``: ``my_relu6`` with a gradient, ``my_double`` without) is
compiled the same way, with ``g++ -O2 -shared -fPIC``. The port loads it
into its registry; the JAX side builds the same library's kernels with the
JAX loader's ``_make_kernel``, outside the JAX registry, which
``tests/test_custom_op.py`` fills from a library of its own path in the
same process. Eagerly, in a static program, and in the gradient, the
port's answers equal the JAX kernels'; a second load returns the same
names and registers nothing. These ops are host kernels by design, as the JAX
package's are through ``jax.pure_callback``: on the card a tensor goes to
the host and its result comes back, which is the op's semantics and not a
fallback (the round trip on CUDA tensors is held in ``chip_smoke.py``)."""
import ctypes
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.framework import op_library as jax_op_library
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.framework import op_library
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.ops.registry import eval_meta, has_op, kernel
from test_custom_op import USER_OP_SRC

X = np.array([-1.0, 2.0, 7.5, 6.0, 0.0, 3.25], np.float32)


def _jax_kernels(so):
    """The library's JAX kernels by name, as ``paddle_tpu``'s loader makes
    them, without registering them."""
    lib = ctypes.CDLL(so)
    lib.PD_NumOps.restype = ctypes.c_int
    lib.PD_OpName.restype = ctypes.c_char_p
    lib.PD_OpName.argtypes = [ctypes.c_int]
    for sym in ("PD_OpNumInputs", "PD_OpNumOutputs", "PD_OpHasGrad"):
        getattr(lib, sym).restype = ctypes.c_int
        getattr(lib, sym).argtypes = [ctypes.c_int]
    lib.PD_OpInferShape.restype = ctypes.c_int
    lib.PD_OpRun.restype = ctypes.c_int
    return {lib.PD_OpName(i).decode(): jax_op_library._make_kernel(
        lib, i, lib.PD_OpName(i).decode(), lib.PD_OpNumInputs(i), lib.PD_OpNumOutputs(i),
        bool(lib.PD_OpHasGrad(i))) for i in range(lib.PD_NumOps())}


@pytest.fixture(scope="module")
def user_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("custom_op_port")
    src = d / "user_ops.cpp"
    src.write_text(USER_OP_SRC)
    so = str(d / "libuser_ops.so")
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(src), "-o", so],
                   check=True, capture_output=True)
    assert op_library.load_op_library(so) == ["my_relu6", "my_double"]
    yield so
    # the registry is the process's: other test files count its op types
    for name in ("my_relu6", "my_double"):
        registry._REGISTRY.pop(name, None)
        registry._SHAPE_RULES.pop(name, None)
    op_library._loaded.pop(so, None)


@pytest.fixture(scope="module")
def jax_kernel(user_lib):
    kernels = _jax_kernels(user_lib)
    assert list(kernels) == ["my_relu6", "my_double"]
    return kernels.__getitem__


def test_eager_equals_the_jax_ops(user_lib, jax_kernel):
    assert has_op("my_relu6") and has_op("my_double")
    for name in ("my_relu6", "my_double"):
        got = kernel(name)(torch.from_numpy(X))
        want = np.asarray(jax_kernel(name)(jnp.asarray(X)))
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
    # numpy and 2-D inputs, through the ops front
    x2 = X.reshape(2, 3)
    np.testing.assert_array_equal(tops._run("my_double", x2).numpy(),
                                  np.asarray(jax_kernel("my_double")(jnp.asarray(x2))))


def test_meta_shapes_come_from_the_library(user_lib):
    out = eval_meta("my_relu6", [torch.empty(4, 5, device="meta")], {})
    assert out.device.type == "meta" and tuple(out.shape) == (4, 5)
    assert out.dtype == torch.float32


def test_static_program_equals_the_jax_kernels(user_lib, jax_kernel):
    tstatic.enable_static()
    tstatic.reset_default_programs()
    try:
        x = tstatic.data("x", [None, 3], "float32")
        z = tops._run("my_double", tops.scale(tops._run("my_relu6", x), 2.0))
        prog = tstatic.default_main_program()
        types = [op.type for op in prog.global_block().ops]
        got = tstatic.Executor("cpu").run(prog, feed={"x": X.reshape(2, 3)}, fetch_list=[z])[0]
    finally:
        tstatic.disable_static()
        tstatic.reset_default_programs()
    assert types == ["my_relu6", "scale", "my_double"]
    want = jax_kernel("my_double")(jax_kernel("my_relu6")(jnp.asarray(X.reshape(2, 3))) * 2.0)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_gradient_equals_the_jax_one(user_lib, jax_kernel):
    x = torch.from_numpy(X).requires_grad_()
    (kernel("my_relu6")(x) ** 2).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jax_kernel("my_relu6")(v) ** 2))(jnp.asarray(X))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    # d/dx relu6(x)^2 = 2 relu6(x) inside (0, 6), else 0
    np.testing.assert_array_equal(x.grad.numpy(), [0.0, 4.0, 0.0, 0.0, 0.0, 6.5])


def test_an_op_without_a_gradient_refuses_one(user_lib, jax_kernel):
    x = torch.from_numpy(X).requires_grad_()
    y = kernel("my_double")(x)
    with pytest.raises(NotImplementedError, match="exports no gradient"):
        y.sum().backward()
    with pytest.raises(Exception):
        jax.grad(lambda v: jnp.sum(jax_kernel("my_double")(v)))(jnp.asarray(X))


def test_reload_is_idempotent(user_lib):
    first = op_library.load_op_library(user_lib)
    second = op_library.load_op_library(user_lib)
    assert first == second == ["my_relu6", "my_double"]
    assert kernel("my_relu6") is kernel("my_relu6")
