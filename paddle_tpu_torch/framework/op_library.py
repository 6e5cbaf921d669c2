"""Runtime-loadable custom op libraries (``paddle_tpu/framework/op_library.py``).

Reference parity: LoadOpLib (framework/load_op_lib.h:45: dlopen a user .so
and merge its ops into the registry), the C plugin ABI
(framework/c/c_api.h) and paddle.fluid.load_op_library.

The library implements the JAX package's C ABI (all symbols required but
the last two):

    int         PD_NumOps(void);
    const char* PD_OpName(int op);
    int         PD_OpNumInputs(int op);
    int         PD_OpNumOutputs(int op);
    // shapes flattened with stride MAX_RANK (8)
    int PD_OpInferShape(int op, int n_in, const int64_t* in_shapes,
                        const int32_t* in_ndims, int64_t* out_shapes,
                        int32_t* out_ndims);
    int PD_OpRun(int op, int n_in, const float** in_bufs,
                 const int64_t* in_shapes, const int32_t* in_ndims,
                 float** out_bufs);
    int PD_OpHasGrad(int op);
    // grad: inputs ++ output cotangents -> input gradients
    int PD_OpRunGrad(int op, int n_in, const float** in_bufs,
                     const int64_t* in_shapes, const int32_t* in_ndims,
                     float** grad_bufs);

float32 buffers, rank at most MAX_RANK = 8. Each op is registered in the
port's op registry (with a shape rule from ``PD_OpInferShape``), so it runs
eagerly through ``ops.registry.kernel(name)`` or the ops front, and in a
static program; a library that exports ``PD_OpRunGrad`` gives a
single-output op its gradient through a ``torch.autograd.Function``.

These are host kernels by design, as the JAX package's are through
``jax.pure_callback``: a tensor on the card is copied to the host, the C
function runs there, and its outputs are copied back to the input's
device. Such a copy is a host read (``runtime.compiled.host_read``): a
compiled step or a static program that calls a custom op runs uncaptured
on the card, and calling one while a graph records raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

MAX_RANK = 8

__all__ = ["load_op_library"]

_loaded: dict = {}


def _shapes_buf(shapes):
    n = len(shapes)
    buf = (ctypes.c_int64 * (n * MAX_RANK))()
    ndims = (ctypes.c_int32 * n)()
    for i, shp in enumerate(shapes):
        if len(shp) > MAX_RANK:
            raise ValueError(f"custom op input of rank {len(shp)}; at most {MAX_RANK}")
        ndims[i] = len(shp)
        for d, s in enumerate(shp):
            buf[i * MAX_RANK + d] = s
    return buf, ndims


def _infer(lib, op_idx, in_shapes, n_out):
    shapes, ndims = _shapes_buf(in_shapes)
    out_shapes = (ctypes.c_int64 * (n_out * MAX_RANK))()
    out_ndims = (ctypes.c_int32 * n_out)()
    rc = lib.PD_OpInferShape(op_idx, len(in_shapes), shapes, ndims, out_shapes, out_ndims)
    if rc != 0:
        raise RuntimeError(f"custom op infer_shape failed (rc={rc})")
    return [tuple(out_shapes[i * MAX_RANK + d] for d in range(out_ndims[i]))
            for i in range(n_out)]


def _run_c(fn, op_idx, arrays, out_shapes):
    """``fn`` (``PD_OpRun`` or ``PD_OpRunGrad``) on float32 host arrays;
    returns the outputs of ``out_shapes``."""
    arrays = [np.ascontiguousarray(a, dtype=np.float32) for a in arrays]
    shapes, ndims = _shapes_buf([a.shape for a in arrays])
    fp = ctypes.POINTER(ctypes.c_float)
    in_ptrs = (fp * len(arrays))(*[a.ctypes.data_as(fp) for a in arrays])
    outs = [np.empty(s, np.float32) for s in out_shapes]
    out_ptrs = (fp * len(outs))(*[o.ctypes.data_as(fp) for o in outs])
    rc = fn(op_idx, len(arrays), in_ptrs, shapes, ndims, out_ptrs)
    if rc != 0:
        raise RuntimeError(f"custom op run failed (rc={rc})")
    return outs


def _to_host(name, tensors):
    """The tensors as float32 host arrays; a copy from the card is a host
    read."""
    if any(t.device.type != "cpu" for t in tensors):
        from ..runtime.compiled import host_read

        host_read(f"custom op {name}")
    return [t.detach().to("cpu", torch.float32).numpy() for t in tensors]


def _make_kernel(lib, op_idx, name, n_in, n_out, has_grad):
    if has_grad and n_out != 1:
        raise NotImplementedError(
            f"custom op {name!r}: gradients are supported for single-output ops")

    def infer(shapes):
        return _infer(lib, op_idx, [tuple(s) for s in shapes], n_out)

    class _HostOp(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *xs):
            ctx.save_for_backward(*xs)
            outs = _run_c(lib.PD_OpRun, op_idx, _to_host(name, xs),
                          infer([x.shape for x in xs]))
            outs = [torch.from_numpy(o).to(xs[0].device) for o in outs]
            return outs[0] if n_out == 1 else tuple(outs)

        @staticmethod
        def backward(ctx, *gys):
            if not has_grad:
                raise NotImplementedError(f"custom op {name!r} exports no gradient "
                                          "(PD_OpRunGrad)")
            xs = ctx.saved_tensors
            grads = _run_c(lib.PD_OpRunGrad, op_idx, _to_host(name, [*xs, *gys]),
                           [tuple(x.shape) for x in xs])
            return tuple(torch.from_numpy(g).to(x.device) for g, x in zip(grads, xs))

    def kernel(*args, **attrs):
        xs = [a.to(torch.float32) if isinstance(a, torch.Tensor)
              else torch.as_tensor(np.asarray(a, np.float32)) for a in args]
        if len(xs) != n_in:
            raise ValueError(f"custom op {name!r} takes {n_in} inputs, got {len(xs)}")
        return _HostOp.apply(*xs)

    def shape_rule(*metas, **attrs):
        outs = [torch.empty(s, dtype=torch.float32, device="meta")
                for s in infer([m.shape for m in metas])]
        return outs[0] if n_out == 1 else tuple(outs)

    kernel.__name__ = name
    return kernel, shape_rule


def load_op_library(so_path: str):
    """dlopen a custom-op library and register its ops (LoadOpLib,
    framework/load_op_lib.h:45). Returns the list of op names added; a
    second load of the same path returns the same names and registers
    nothing."""
    from ..ops.registry import register_op, register_shape

    if so_path in _loaded:
        return list(_loaded[so_path])
    lib = ctypes.CDLL(so_path)
    lib.PD_NumOps.restype = ctypes.c_int
    lib.PD_OpName.restype = ctypes.c_char_p
    lib.PD_OpName.argtypes = [ctypes.c_int]
    for sym in ("PD_OpNumInputs", "PD_OpNumOutputs"):
        getattr(lib, sym).restype = ctypes.c_int
        getattr(lib, sym).argtypes = [ctypes.c_int]
    lib.PD_OpInferShape.restype = ctypes.c_int
    lib.PD_OpRun.restype = ctypes.c_int
    has_grad_fn = getattr(lib, "PD_OpHasGrad", None)
    if has_grad_fn is not None:
        has_grad_fn.restype = ctypes.c_int
        has_grad_fn.argtypes = [ctypes.c_int]
        if getattr(lib, "PD_OpRunGrad", None) is not None:
            lib.PD_OpRunGrad.restype = ctypes.c_int

    names = []
    for i in range(lib.PD_NumOps()):
        name = lib.PD_OpName(i).decode()
        n_in, n_out = lib.PD_OpNumInputs(i), lib.PD_OpNumOutputs(i)
        has_grad = bool(has_grad_fn(i)) if has_grad_fn is not None else False
        kernel, shape_rule = _make_kernel(lib, i, name, n_in, n_out, has_grad)
        register_op(name, num_outputs=n_out)(kernel)
        register_shape(name)(shape_rule)
        names.append(name)
    _loaded[so_path] = names
    return names
