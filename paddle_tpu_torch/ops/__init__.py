"""The dygraph op front of the port (``paddle_tpu/ops/__init__.py``).

The hand-written CUDA kernels live in :mod:`.cuda`; the op kernels a saved
Program names are registered in :mod:`.registry` by :mod:`.kernels`,
:mod:`.tensor_kernels` and :mod:`.quantize_kernels`, the beam search pair
by :mod:`.beam_search` and the IR optimizer's fused ops by
:mod:`.fused_ops`; the sequence, detection, compat and niche families by
their files of the JAX package's names.

The functions here are the mode-aware front the ``tensor``, ``linalg`` and
top-level namespaces re-export, with the JAX package's signatures: under
``static.enable_static()`` a call on a symbolic ``Variable`` appends an
``OpDesc`` to the default program (:func:`_run`); otherwise one type test
and the registered torch kernel runs, its inputs cast by the active AMP
scope (``framework.autograd.amp_cast``, as the JAX dispatcher casts).
The result is a :class:`~paddle_tpu_torch.framework.tensor.Tensor` when an
input was one (or the op takes none), else the kernel's plain tensor, so
the port's internals that pass plain tensors get plain tensors back. A
Python number beside a tensor takes the tensor's dtype when it is floating
(Paddle's scalar rule). The creation functions make a ``Tensor`` on the
default place; in static mode they make a host constant, which the first
op that reads it captures into the program.

An op whose output shape depends on the data (``unique``, ``nonzero``,
``masked_select``, ``where`` with one argument, ``sequence_unpad``,
``sequence_expand``, ``sequence_erase``, ``sequence_mask``/``sequence_pad``
without ``maxlen``, ``unique_consecutive``, ``bincount`` without
``length``) raises ``UnimplementedError`` in a static program; an op type with no registry
kernel raises it naming the type. Neither runs eagerly in its place.
"""
from __future__ import annotations

import builtins
import sys

import numpy as np
import torch

from . import beam_search, fused_ops, kernels, quantize_kernels, tensor_kernels  # noqa: F401
from . import (linalg_kernels, math_extra, metrics_kernels, nn_extra,  # noqa: F401
               optimizer_kernels)
from . import compat, detection, niche, sequence  # noqa: F401  (after the kernels they alias)
from ..errors import UnimplementedError
from ..framework import autograd as _ag
from ..framework.dtype import convert_dtype, dtype_name, torch_dtype
from ..framework.tensor import Tensor, to_tensor, to_tensor_like, wrap
from .registry import _REGISTRY, all_ops, get_op, has_op, kernel  # noqa: F401

__all__ = []  # the names are the tensor namespace's (paddle_tpu_torch.tensor)

# bound to static.program's by _bind_static
_STATIC = [False]
_Variable = type(None)


def _run(name, *tensors, **attrs):
    if _STATIC[0] and (not tensors or builtins.any(isinstance(t, _Variable) for t in tensors)):
        from ..static.op_append import append_static_op

        return append_static_op(name, tensors, attrs)
    op = _REGISTRY.get(name)
    if op is None:
        get_op(name)  # raises UnimplementedError naming the type
    if _ag._amp_hook is not None:
        tensors = _ag._amp_hook(name, list(tensors))
    out = op.fn(*tensors, **attrs)
    if not tensors or builtins.any(isinstance(t, Tensor) for t in tensors):
        return wrap(out)
    return out


def _static(x) -> bool:
    return _STATIC[0] and isinstance(x, _Variable)


def _t(x, ref=None):
    """``x`` as something an op takes: a tensor or a Variable as it is, a
    number or array as a tensor (beside ``ref`` when given)."""
    if isinstance(x, (torch.Tensor, _Variable)):
        return x
    if ref is not None and isinstance(ref, torch.Tensor):
        return to_tensor_like(x, ref)
    if ref is not None and isinstance(ref, _Variable):
        if isinstance(x, (bool, int, float)) and torch_dtype(ref.dtype).is_floating_point:
            return torch.tensor(x, dtype=torch_dtype(ref.dtype))
    if _STATIC[0]:
        arr = np.asarray(x)
        return torch.from_numpy(arr.astype(np.float32) if arr.dtype == np.float64 else arr)
    return to_tensor(x)


def _refuse_static(name):
    if _STATIC[0]:
        raise UnimplementedError(f"operator {name!r} has a data-dependent output shape and "
                                 "cannot appear in a static program")


# -- binary math -------------------------------------------------------------


def _binary(op_type, public):
    def fn(x, y, name_=None):
        if not isinstance(x, (torch.Tensor, _Variable)):
            x = _t(x, y)
        return _run(op_type, x, _t(y, x))

    fn.__name__ = fn.__qualname__ = public
    return fn


add = _binary("elementwise_add", "add")
subtract = _binary("elementwise_sub", "subtract")
multiply = _binary("elementwise_mul", "multiply")
divide = _binary("elementwise_div", "divide")
elementwise_pow = _binary("elementwise_pow", "elementwise_pow")
remainder = _binary("elementwise_mod", "remainder")
mod = _binary("elementwise_mod", "mod")
floor_mod = _binary("elementwise_mod", "floor_mod")
floor_divide = _binary("elementwise_floordiv", "floor_divide")
maximum = _binary("elementwise_max", "maximum")
minimum = _binary("elementwise_min", "minimum")
atan2 = _binary("atan2", "atan2")
equal = _binary("equal", "equal")
not_equal = _binary("not_equal", "not_equal")
less_than = _binary("less_than", "less_than")
less_equal = _binary("less_equal", "less_equal")
greater_than = _binary("greater_than", "greater_than")
greater_equal = _binary("greater_equal", "greater_equal")
logical_and = _binary("logical_and", "logical_and")
logical_or = _binary("logical_or", "logical_or")
logical_xor = _binary("logical_xor", "logical_xor")
bitwise_and = _binary("bitwise_and", "bitwise_and")
bitwise_or = _binary("bitwise_or", "bitwise_or")
bitwise_xor = _binary("bitwise_xor", "bitwise_xor")


def logical_not(x):
    return _run("logical_not", _t(x))


def bitwise_not(x):
    return _run("bitwise_not", _t(x))


# -- unary math --------------------------------------------------------------


def _unary(op_type, public):
    def fn(x, name_=None):
        return _run(op_type, _t(x))

    fn.__name__ = fn.__qualname__ = public
    return fn


for _op, _public in (("abs",) * 2, ("exp",) * 2, ("expm1",) * 2, ("log",) * 2, ("log2",) * 2,
                     ("log10",) * 2, ("log1p",) * 2, ("sqrt",) * 2, ("rsqrt",) * 2,
                     ("square",) * 2, ("sin",) * 2, ("cos",) * 2, ("tan",) * 2, ("asin",) * 2,
                     ("acos",) * 2, ("atan",) * 2, ("sinh",) * 2, ("cosh",) * 2,
                     ("asinh",) * 2, ("acosh",) * 2, ("atanh",) * 2, ("tanh",) * 2,
                     ("floor",) * 2, ("ceil",) * 2, ("round",) * 2, ("sign",) * 2,
                     ("reciprocal",) * 2, ("erf",) * 2, ("erfinv",) * 2, ("digamma",) * 2,
                     ("lgamma",) * 2, ("sigmoid",) * 2, ("logsigmoid", "log_sigmoid"),
                     ("isnan",) * 2, ("isinf",) * 2, ("isfinite",) * 2, ("trunc",) * 2,
                     ("relu",) * 2, ("selu",) * 2, ("softsign",) * 2,
                     ("tanh_shrink",) * 2, ("swish",) * 2, ("swish", "silu"), ("mish",) * 2):
    globals()[_public] = _unary(_op, _public)


def neg(x):
    return scale(_t(x), scale=-1.0)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None):
    out = _run("scale", _t(x), scale=float(scale), bias=float(bias),
               bias_after_scale=bias_after_scale)
    return globals()[act](out) if act else out


def clip(x, min=None, max=None):
    min = min.item() if isinstance(min, torch.Tensor) else min
    max = max.item() if isinstance(max, torch.Tensor) else max
    return _run("clip", _t(x), min=None if min is None else float(min),
                max=None if max is None else float(max))


def pow(x, y):
    if isinstance(y, (int, float)):
        return _run("pow", _t(x), factor=float(y))
    return elementwise_pow(x, y)


# -- matrix ------------------------------------------------------------------


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return _run("matmul", _t(x), _t(y), transpose_x=transpose_x, transpose_y=transpose_y)


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1):
    return _run("mul", _t(x), _t(y), x_num_col_dims=x_num_col_dims,
                y_num_col_dims=y_num_col_dims)


def bmm(x, y):
    return _run("bmm", _t(x), _t(y))


def dot(x, y):
    return _run("dot", _t(x), _t(y))


def addmm(input, x, y, beta=1.0, alpha=1.0):
    return _run("addmm", _t(input), _t(x), _t(y), beta=beta, alpha=alpha)


def cross(x, y, axis=-1):
    return _run("cross", _t(x), _t(y), axis=axis)


def cholesky(x, upper=False):
    return _run("cholesky", _t(x), upper=upper)


def matrix_power(x, n):
    return _run("matrix_power", _t(x), n=n)


def inverse(x):
    return _run("inverse", _t(x))


def einsum(equation, *operands):
    return _run("einsum", *[_t(o) for o in operands], equation=equation)


def t(x):
    x = _t(x)
    if len(x.shape) < 2:
        return x
    return transpose(x, [1, 0])


def mv(x, vec):
    return matmul(_t(x), _t(vec))


def inner(x, y):
    """``sum(x * y)`` over the last axes of both (``jnp.inner``)."""
    x, y = _t(x), _t(y)
    if len(x.shape) == 0 or len(y.shape) == 0:
        return multiply(x, y)
    return matmul(x, y, transpose_y=len(y.shape) > 1)


def outer(x, y):
    return matmul(reshape(_t(x), [-1, 1]), reshape(_t(y), [1, -1]))


def kron(x, y):
    return _run("kron", _t(x), _t(y))


def det(x):
    return _run("det", _t(x))


def slogdet(x):
    return _run("slogdet", _t(x))


def matrix_rank(x, tol=None, hermitian=False):
    return _run("matrix_rank", _t(x), tol=tol, hermitian=hermitian)


def solve(a, b):
    return _run("solve", _t(a), _t(b))


def triangular_solve(a, b, upper=True, transpose=False, unitriangular=False):
    return _run("triangular_solve", _t(a), _t(b), upper=upper, transpose=transpose,
                unitriangular=unitriangular)


def lstsq(a, b, rcond=None):
    return _run("lstsq", _t(a), _t(b), rcond=rcond)


def svd(x, full_matrices=False):
    return _run("svd", _t(x), full_matrices=full_matrices)


def qr(x, mode="reduced"):
    return _run("qr", _t(x), mode=mode)


def eig(x):
    return _run("eig", _t(x))


def eigh(x, UPLO="L"):
    return _run("eigh", _t(x), UPLO=UPLO)


def pinv(x, rcond=1e-15, hermitian=False):
    return _run("pinv", _t(x), rcond=rcond, hermitian=hermitian)


def trace(x, offset=0, axis1=0, axis2=1):
    return _run("trace", _t(x), offset=offset, axis1=axis1, axis2=axis2)


def dist(x, y, p=2):
    """The ``p``-norm of ``x - y`` flattened (``p = inf``: the largest
    ``|x - y|``; ``p = 0``: the count of differing entries)."""
    d = reshape(subtract(_t(x), _t(y)), [-1])
    if p == float("inf"):
        return max(abs(d))
    if p == 0:
        return sum(cast(not_equal(d, 0.0), d.dtype if isinstance(d, torch.Tensor) else "float32"))
    return pow(sum(pow(abs(d), float(p))), 1.0 / p)


# -- reductions --------------------------------------------------------------


def sum(x, axis=None, dtype=None, keepdim=False):
    out = _run("reduce_sum", _t(x), dim=axis, keep_dim=keepdim)
    return out if dtype is None else cast(out, dtype)


def mean(x, axis=None, keepdim=False):
    return _run("reduce_mean", _t(x), dim=axis, keep_dim=keepdim)


def max(x, axis=None, keepdim=False):
    return _run("reduce_max", _t(x), dim=axis, keep_dim=keepdim)


def min(x, axis=None, keepdim=False):
    return _run("reduce_min", _t(x), dim=axis, keep_dim=keepdim)


def prod(x, axis=None, keepdim=False):
    return _run("reduce_prod", _t(x), dim=axis, keep_dim=keepdim)


def any(x, axis=None, keepdim=False):
    return _run("reduce_any", _t(x), dim=axis, keep_dim=keepdim)


def all(x, axis=None, keepdim=False):
    return _run("reduce_all", _t(x), dim=axis, keep_dim=keepdim)


def amax(x, axis=None, keepdim=False):
    return _run("amax", _t(x), axis=axis, keepdim=keepdim)


def amin(x, axis=None, keepdim=False):
    return _run("amin", _t(x), axis=axis, keepdim=keepdim)


def logsumexp(x, axis=None, keepdim=False):
    return _run("logsumexp", _t(x), axis=axis, keepdim=keepdim)


def argmax(x, axis=None, keepdim=False, dtype="int64"):
    return _run("arg_max", _t(x), axis=axis, keepdims=keepdim, dtype=dtype_name(dtype))


def argmin(x, axis=None, keepdim=False, dtype="int64"):
    return _run("arg_min", _t(x), axis=axis, keepdims=keepdim, dtype=dtype_name(dtype))


def p_norm(x, p=2, axis=None, keepdim=False, epsilon=1e-12):
    return _run("p_norm", _t(x), porder=float(p), axis=axis, keepdim=keepdim, epsilon=epsilon)


def norm(x, p=2, axis=None, keepdim=False, epsilon=1e-12):
    return p_norm(x, p, axis, keepdim, epsilon)


def cumsum(x, axis=None):
    return _run("cumsum", _t(x), axis=axis)


def cumprod(x, dim=None):
    return _run("cumprod", _t(x), dim=dim)


def std(x, axis=None, unbiased=True, keepdim=False):
    return _run("std", _t(x), axis=axis, unbiased=unbiased, keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False):
    return _run("var", _t(x), axis=axis, unbiased=unbiased, keepdim=keepdim)


def median(x, axis=None, keepdim=False):
    return _run("median", _t(x), axis=axis, keepdim=keepdim)


def nanmedian(x, axis=None, keepdim=False):
    return _run("nanmedian", _t(x), axis=axis, keepdim=keepdim)


def quantile(x, q, axis=None, keepdim=False, interpolation="linear"):
    return _run("quantile", _t(x), q=q, axis=axis, keepdim=keepdim, interpolation=interpolation)


def mode(x, axis=-1, keepdim=False):
    return _run("mode", _t(x), axis=axis, keepdim=keepdim)


def histogram(x, bins=100, min=0, max=0, weight=None, density=False):
    return _run("histogram", _t(x), bins=bins, min=min, max=max, weight=weight,
                density=density)


def nansum(x, axis=None, keepdim=False):
    return _run("nansum", _t(x), axis=axis, keepdim=keepdim)


def nanmean(x, axis=None, keepdim=False):
    return _run("nanmean", _t(x), axis=axis, keepdim=keepdim)


def numel(x):
    return to_tensor(np.int64(int(np.prod(_t(x).shape))), place=_place_of(x))


def rank(x):
    return to_tensor(np.asarray(len(_t(x).shape), np.int32), place=_place_of(x))


def shape(x):
    return to_tensor(np.array(list(_t(x).shape), dtype=np.int32), place=_place_of(x))


def _place_of(x):
    return x.device if isinstance(x, torch.Tensor) else None


def is_complex(x):
    return _t(x).dtype.is_complex


def is_integer(x):
    dt = _t(x).dtype
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)


def is_empty(x):
    return to_tensor(np.asarray(int(np.prod(_t(x).shape)) == 0), place=_place_of(x))


# -- manipulation ------------------------------------------------------------


def cast(x, dtype):
    return _run("cast", _t(x), dtype=dtype_name(dtype))


def reshape(x, shape):
    return _run("reshape", _t(x), shape=tuple(int(s) for s in shape))


def transpose(x, perm):
    return _run("transpose", _t(x), perm=tuple(perm))


def flatten(x, start_axis=0, stop_axis=-1):
    return _run("flatten", _t(x), start_axis=start_axis, stop_axis=stop_axis)


def squeeze(x, axis=None):
    return _run("squeeze", _t(x), axes=axis)


def unsqueeze(x, axis):
    return _run("unsqueeze", _t(x), axes=axis)


def concat(xs, axis=0):
    axis = int(axis.item()) if isinstance(axis, torch.Tensor) else axis
    return _run("concat", *[_t(x) for x in xs], axis=axis)


def split(x, num_or_sections, axis=0):
    sections = num_or_sections if isinstance(num_or_sections, int) else tuple(num_or_sections)
    return list(_run("split", _t(x), num_or_sections=sections, axis=axis))


def chunk(x, chunks, axis=0):
    return split(x, chunks, axis)


def stack(xs, axis=0):
    return _run("stack", *[_t(x) for x in xs], axis=axis)


def unstack(x, axis=0, num=None):
    return list(_run("unstack", _t(x), axis=axis, num=num))


def unbind(x, axis=0):
    return list(_run("unbind", _t(x), axis=axis))


def slice(x, axes, starts, ends):
    return _run("slice", _t(x), axes=tuple(axes), starts=tuple(starts), ends=tuple(ends))


def strided_slice(x, axes, starts, ends, strides):
    return _run("strided_slice", _t(x), axes=tuple(axes), starts=tuple(starts),
                ends=tuple(ends), strides=tuple(strides))


def gather(x, index, axis=0):
    return _run("gather", _t(x), _t(index), axis=axis)


def gather_nd(x, index):
    return _run("gather_nd", _t(x), _t(index))


def scatter(x, index, updates, overwrite=True):
    return _run("scatter", _t(x), _t(index), _t(updates), overwrite=overwrite)


def scatter_nd_add(x, index, updates):
    return _run("scatter_nd_add", _t(x), _t(index), _t(updates))


def scatter_nd(index, updates, shape):
    updates = _t(updates)
    return scatter_nd_add(zeros(list(shape), updates.dtype), _t(index), updates)


def index_select(x, index, axis=0):
    return _run("index_select", _t(x), _t(index), axis=axis)


def index_sample(x, index):
    return _run("index_sample", _t(x), _t(index))


def take_along_axis(x, index, axis):
    return _run("take_along_axis", _t(x), _t(index), axis=axis)


def put_along_axis(x, indices, values, axis, reduce="assign"):
    x = _t(x)
    return _run("put_along_axis", x, _t(indices), _t(values, x), axis=axis, reduce=reduce)


def masked_select(x, mask):
    _refuse_static("masked_select")
    return _run("masked_select", _t(x), _t(mask))


def masked_fill(x, mask, value):
    return _run("masked_fill", _t(x), _t(mask), value=float(value))


def tile(x, repeat_times):
    return _run("tile", _t(x), repeat_times=tuple(repeat_times))


def expand(x, shape):
    return _run("expand", _t(x), shape=tuple(shape))


def expand_as(x, y):
    return _run("broadcast_to", _t(x), shape=tuple(_t(y).shape))


def broadcast_to(x, shape):
    return _run("broadcast_to", _t(x), shape=tuple(shape))


def where(cond, x=None, y=None):
    if x is None and y is None:
        return nonzero(cond)
    cond = _t(cond)
    x = _t(x, y if isinstance(y, (torch.Tensor, _Variable)) else None)
    return _run("where", cond, x, _t(y, x))


def nonzero(x, as_tuple=False):
    _refuse_static("nonzero")
    return _run("nonzero", _t(x), as_tuple=as_tuple)


def pad(x, paddings, mode="constant", value=0.0):
    return _run("pad", _t(x), paddings=tuple(paddings), mode=mode, value=float(value))


def roll(x, shifts, axis=None):
    return _run("roll", _t(x), shifts=shifts, axis=axis)


def flip(x, axis):
    return _run("flip", _t(x), axis=axis)


def reverse(x, axis):
    return flip(x, axis)


def tril(x, diagonal=0):
    return _run("tril", _t(x), diagonal=diagonal)


def triu(x, diagonal=0):
    return _run("triu", _t(x), diagonal=diagonal)


def diag(x, offset=0, padding_value=0.0):
    return _run("diag", _t(x), offset=offset, padding_value=padding_value)


def diag_embed(x, offset=0):
    return _run("diag_embed", _t(x), offset=offset)


def diagflat(x, offset=0):
    return _run("diagflat", _t(x), offset=offset)


def assign(x, output=None):
    out = _run("assign", _t(x))
    if output is not None:
        output.set_value(out)
        return output
    return out


def clone(x):
    return assign(x)


def one_hot(x, num_classes):
    return _run("one_hot", _t(x), num_classes=num_classes)


def topk(x, k, axis=-1, largest=True, sorted=True):
    vals, idx = _run("top_k", _t(x), k=k, axis=axis, largest=largest, sorted=sorted)
    return vals, idx


def argsort(x, axis=-1, descending=False):
    return _run("argsort", _t(x), axis=axis, descending=descending)[1]


def sort(x, axis=-1, descending=False):
    return _run("sort", _t(x), axis=axis, descending=descending)


def kthvalue(x, k, axis=-1, keepdim=False):
    return _run("kthvalue", _t(x), k=k, axis=axis, keepdim=keepdim)


def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    return _run("searchsorted", _t(sorted_sequence), _t(values), out_int32=out_int32,
                right=right)


def unique(x, return_index=False, return_inverse=False, return_counts=False, axis=None):
    _refuse_static("unique")
    vals, index, inverse, counts = _run("unique", _t(x), axis=axis)
    res = [vals] + [r for r, want in ((index, return_index), (inverse, return_inverse),
                                      (counts, return_counts)) if want]
    return res[0] if len(res) == 1 else tuple(res)


def meshgrid(*xs):
    if len(xs) == 1 and isinstance(xs[0], (list, tuple)):
        xs = xs[0]
    return list(_run("meshgrid", *[_t(x) for x in xs]))


def repeat_interleave(x, repeats, axis=None):
    return _run("repeat_interleave", _t(x), repeats=repeats, axis=axis)


def shard_index(x, index_num, nshards, shard_id, ignore_value=-1):
    return _run("shard_index", _t(x), index_num=index_num, nshards=nshards, shard_id=shard_id,
                ignore_value=ignore_value)


def multiplex(inputs, index):
    """``out[i] = inputs[index[i]][i]`` (``operators/multiplex_op.cc``)."""
    return _run("multiplex", _t(index), *[_t(t) for t in inputs])


def pixel_unshuffle(x, downscale_factor, data_format="NCHW"):
    return _run("pixel_unshuffle", _t(x), downscale_factor=downscale_factor,
                data_format=data_format)


def channel_shuffle(x, groups, data_format="NCHW"):
    return _run("channel_shuffle", _t(x), groups=groups, data_format=data_format)


def increment(x, value=1.0):
    x = _t(x)
    return add(x, _t(value, x))


def stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale(tanh(scale(_t(x), scale_a)), scale_b)


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    return _run("allclose", _t(x), _t(y), rtol=rtol, atol=atol, equal_nan=equal_nan)


def isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    return _run("isclose", _t(x), _t(y), rtol=rtol, atol=atol, equal_nan=equal_nan)


def equal_all(x, y):
    return _run("equal_all", _t(x), _t(y))


def lerp(x, y, weight):
    x = _t(x)
    return _run("lerp", x, _t(y, x), _t(weight, x))


def frac(x):
    return _run("frac", _t(x))


def diff(x, n=1, axis=-1):
    return _run("diff", _t(x), n=n, axis=axis)


def angle(x):
    return _run("angle", _t(x))


def real(x):
    return _run("real", _t(x))


def imag(x):
    return _run("imag", _t(x))


def as_complex(x):
    return _run("as_complex", _t(x))


def as_real(x):
    return _run("as_real", _t(x))


# -- activations -------------------------------------------------------------


def relu6(x, threshold=6.0):
    return _run("relu6", _t(x), threshold=threshold)


def leaky_relu(x, negative_slope=0.01):
    return _run("leaky_relu", _t(x), alpha=negative_slope)


def elu(x, alpha=1.0):
    return _run("elu", _t(x), alpha=alpha)


def celu(x, alpha=1.0):
    return _run("celu", _t(x), alpha=alpha)


def gelu(x, approximate=False):
    return _run("gelu", _t(x), approximate=approximate)


def hardsigmoid(x, slope=0.1666667, offset=0.5):
    return _run("hard_sigmoid", _t(x), slope=slope, offset=offset)


def hardswish(x):
    return _run("hard_swish", _t(x))


def hardtanh(x, min=-1.0, max=1.0):
    return _run("hard_tanh", _t(x), min=min, max=max)


def hardshrink(x, threshold=0.5):
    return _run("hard_shrink", _t(x), threshold=threshold)


def softshrink(x, threshold=0.5):
    return _run("softshrink", _t(x), lambda_=threshold)


def softplus(x, beta=1.0, threshold=20.0):
    return _run("softplus", _t(x), beta=beta, threshold=threshold)


def prelu(x, weight):
    return _run("prelu", _t(x), _t(weight))


def softmax(x, axis=-1):
    return _run("softmax", _t(x), axis=axis)


def log_softmax(x, axis=-1):
    return _run("log_softmax", _t(x), axis=axis)


def maxout(x, groups, axis=1):
    return _run("maxout", _t(x), groups=groups, axis=axis)


# -- nn ops ------------------------------------------------------------------


def linear(x, weight, bias=None):
    args = [_t(x), _t(weight)] + ([] if bias is None else [_t(bias)])
    return _run("linear", *args)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1, data_format="NCHW"):
    out = _run("conv2d", _t(x), _t(weight), stride=stride, padding=padding, dilation=dilation,
               groups=groups, data_format=data_format)
    if bias is not None:
        shape = [1] * len(out.shape)
        shape[1 if data_format == "NCHW" else len(out.shape) - 1] = -1
        out = add(out, reshape(_t(bias), shape))
    return out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    out = _run("conv1d", _t(x), _t(weight), stride=stride, padding=padding, dilation=dilation,
               groups=groups)
    return out if bias is None else add(out, reshape(_t(bias), [1, -1, 1]))


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0, dilation=1,
                     groups=1, data_format="NCHW"):
    out = _run("conv2d_transpose", _t(x), _t(weight), stride=stride, padding=padding,
               output_padding=output_padding, dilation=dilation, groups=groups,
               data_format=data_format)
    if bias is not None:
        shape = [1, -1, 1, 1] if data_format == "NCHW" else [1, 1, 1, -1]
        out = add(out, reshape(_t(bias), shape))
    return out


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False, data_format="NCHW"):
    return _run("pool2d", _t(x), kernel_size=kernel_size, stride=stride, padding=padding,
                pooling_type="max", ceil_mode=ceil_mode, data_format=data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               data_format="NCHW"):
    return _run("pool2d", _t(x), kernel_size=kernel_size, stride=stride, padding=padding,
                pooling_type="avg", ceil_mode=ceil_mode, exclusive=exclusive,
                data_format=data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    return _run("adaptive_pool2d", _t(x), output_size=output_size, pooling_type="avg",
                data_format=data_format)


def adaptive_max_pool2d(x, output_size, data_format="NCHW"):
    return _run("adaptive_pool2d", _t(x), output_size=output_size, pooling_type="max",
                data_format=data_format)


def layer_norm(x, normalized_shape=None, weight=None, bias=None, epsilon=1e-5):
    if normalized_shape is not None:
        n = len(normalized_shape) if isinstance(normalized_shape, (list, tuple)) else 1
        begin_norm_axis = -n
    else:
        begin_norm_axis = -1
    args = [_t(x)]
    if weight is not None:
        args.append(_t(weight))
    if bias is not None:
        if weight is None:
            raise ValueError("bias without weight unsupported; pass both")
        args.append(_t(bias))
    return _run("layer_norm", *args, epsilon=epsilon, begin_norm_axis=begin_norm_axis)


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5):
    args = [_t(x)] + [_t(p) for p in (weight, bias) if p is not None]
    return _run("group_norm", *args, groups=num_groups, epsilon=epsilon)


def instance_norm(x, weight=None, bias=None, epsilon=1e-5):
    args = [_t(x)] + [_t(p) for p in (weight, bias) if p is not None]
    return _run("instance_norm", *args, epsilon=epsilon)


def batch_norm(x, running_mean, running_var, weight, bias, training=False, momentum=0.9,
               epsilon=1e-5, data_format="NCHW"):
    """In a static program the op's running-statistics outputs are the
    running variables themselves (``__inplace__``), so the executor writes
    them back; eagerly the new statistics are copied into the buffers."""
    attrs = dict(momentum=momentum, epsilon=epsilon, training=training,
                 data_format=data_format)
    if _static(x):
        from ..static.op_append import append_static_op

        alias = {1: running_mean.name, 2: running_var.name} if training else None
        y, _, _ = append_static_op("batch_norm", [x, weight, bias, running_mean, running_var],
                                   attrs, alias_outputs=alias)
        return y
    y, new_mean, new_var = kernel("batch_norm")(x, weight, bias, running_mean, running_var,
                                                **attrs)
    if training:
        with torch.no_grad():
            running_mean.copy_(new_mean)
            running_var.copy_(new_var)
    return wrap(y) if isinstance(x, Tensor) else y


def embedding(x, weight, padding_idx=None, sparse=False):
    return _run("lookup_table", _t(weight), _t(x),
                padding_idx=-1 if padding_idx is None else padding_idx)


def dropout(x, p=0.5, training=True, mode="upscale_in_train"):
    if not training or p == 0.0:
        return x
    return _run("dropout", x, p=p, training=training, mode=mode)


def interpolate(x, size=None, scale_factor=None, mode="nearest", align_corners=False,
                data_format="NCHW"):
    if size is not None and not isinstance(size, (list, tuple)):
        size = (int(size), int(size))
    return _run("interpolate", _t(x), size=tuple(size) if size else None,
                scale_factor=scale_factor, mode=mode, align_corners=align_corners,
                data_format=data_format)


upsample = interpolate


def pixel_shuffle(x, upscale_factor):
    return _run("pixel_shuffle", _t(x), upscale_factor=upscale_factor)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    return _run("unfold", _t(x), kernel_sizes=kernel_sizes, strides=strides, paddings=paddings,
                dilations=dilations)


# -- losses ------------------------------------------------------------------


def softmax_with_cross_entropy(logits, label, soft_label=False, axis=-1, ignore_index=-100):
    return _run("softmax_with_cross_entropy", _t(logits), _t(label), soft_label=soft_label,
                axis=axis, ignore_index=ignore_index)


def cross_entropy(input, label, weight=None, soft_label=False, axis=-1, ignore_index=-100,
                  reduction="mean", use_softmax=True):
    attrs = dict(soft_label=soft_label, axis=axis, ignore_index=ignore_index,
                 reduction=reduction, use_softmax=use_softmax)
    if weight is not None:
        attrs["weight"] = np.asarray(weight.detach().cpu().numpy() if isinstance(
            weight, torch.Tensor) else weight, np.float32)
    return _run("cross_entropy", _t(input), _t(label), **attrs)


def mse_loss(input, label, reduction="mean"):
    return _run("mse_loss", _t(input), _t(label), reduction=reduction)


def l1_loss(input, label, reduction="mean"):
    return _run("l1_loss", _t(input), _t(label), reduction=reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    return _run("smooth_l1_loss", _t(input), _t(label), reduction=reduction, delta=delta)


def binary_cross_entropy(input, label, reduction="mean"):
    return _run("bce_loss", _t(input), _t(label), reduction=reduction)


def binary_cross_entropy_with_logits(logits, label, reduction="mean", pos_weight=None):
    attrs = dict(reduction=reduction)
    if pos_weight is not None:
        attrs["pos_weight"] = np.asarray(pos_weight.detach().cpu().numpy() if isinstance(
            pos_weight, torch.Tensor) else pos_weight, np.float32)
    return _run("bce_with_logits", _t(logits), _t(label), **attrs)


def nll_loss(input, label, reduction="mean", ignore_index=-100):
    return _run("nll_loss", _t(input), _t(label), reduction=reduction, ignore_index=ignore_index)


def kl_div(input, label, reduction="mean"):
    return _run("kl_div", _t(input), _t(label), reduction=reduction)


def log_loss(input, label, epsilon=1e-4):
    return _run("log_loss", _t(input), _t(label), epsilon=epsilon)


def square_error_cost(input, label):
    return _run("square_error_cost", _t(input), _t(label))


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    return _run("margin_ranking_loss", _t(input), _t(other), _t(label), margin=margin,
                reduction=reduction)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    return _run("cosine_similarity", _t(x1), _t(x2), axis=axis, eps=eps)


def accuracy(input, label, k=1):
    """The share of rows whose label is among ``input``'s top ``k``."""
    _, idx = topk(_t(input), k)
    return _run("accuracy", idx, _t(label))


# -- creation ----------------------------------------------------------------


def _made(t):
    """A creation op's host tensor: a constant in static mode, else a
    ``Tensor`` on the default place."""
    return t if _STATIC[0] else to_tensor(t)


def full(shape, fill_value, dtype=None):
    """float32 for a float, int64 for an int, bool for a bool, unless
    ``dtype`` (a torch dtype or its name) says."""
    if dtype is None:
        dtype = (torch.bool if isinstance(fill_value, bool) else
                 torch.int64 if isinstance(fill_value, int) else torch.float32)
    if isinstance(fill_value, torch.Tensor):
        fill_value = fill_value.item()
    return _made(torch.full(tuple(shape), fill_value, dtype=torch_dtype(dtype)))


def zeros(shape, dtype=None):
    return _made(torch.zeros(tuple(shape), dtype=convert_dtype(dtype)))


def ones(shape, dtype=None):
    return _made(torch.ones(tuple(shape), dtype=convert_dtype(dtype)))


def empty(shape, dtype=None):
    return zeros(shape, dtype)


def _like(x, fill, dtype):
    x = _t(x)
    dt = convert_dtype(dtype) if dtype is not None else (
        torch_dtype(x.dtype) if isinstance(x, _Variable) else x.dtype)
    t = torch.full(tuple(x.shape), fill, dtype=dt, device=x.device if isinstance(
        x, torch.Tensor) else None)
    return t if _STATIC[0] else wrap(t)


def zeros_like(x, dtype=None):
    return _like(x, 0, dtype)


def ones_like(x, dtype=None):
    return _like(x, 1, dtype)


def full_like(x, fill_value, dtype=None):
    return _like(x, fill_value, dtype)


def empty_like(x, dtype=None):
    return _like(x, 0, dtype)


def arange(start=0, end=None, step=1, dtype=None):
    if end is None:
        start, end = 0, start
    if dtype is None:
        ints = builtins.all(isinstance(v, (int, np.integer)) for v in (start, end, step))
        dtype = "int64" if ints else "float32"
    return _made(torch.arange(start, end, step, dtype=torch_dtype(dtype)))


def linspace(start, stop, num, dtype=None):
    return _made(torch.linspace(start, stop, num, dtype=convert_dtype(dtype or "float32")))


def eye(num_rows, num_columns=None, dtype=None):
    return _made(torch.eye(num_rows, num_columns if num_columns is not None else num_rows,
                           dtype=convert_dtype(dtype)))


# -- random ops: drawn on the default place from its generator -----------------


def _gen():
    from ..framework import random as _random
    from ..framework.place import default_device

    return _random.default_generator(default_device())


def uniform(shape, dtype=None, min=-1.0, max=1.0):
    attrs = dict(shape=tuple(shape), min=float(min), max=float(max),
                 dtype=dtype_name(dtype or "float32"))
    if not _STATIC[0]:
        attrs["generator"] = _gen()
    return _run("uniform_random", **attrs)


def rand(shape, dtype=None):
    return uniform(shape, dtype, 0.0, 1.0)


def normal(mean=0.0, std=1.0, shape=None):
    attrs = dict(shape=tuple(shape), mean=float(mean), std=float(std), dtype="float32")
    if not _STATIC[0]:
        attrs["generator"] = _gen()
    return _run("gaussian_random", **attrs)


def randn(shape, dtype=None):
    attrs = dict(shape=tuple(shape), mean=0.0, std=1.0, dtype=dtype_name(dtype or "float32"))
    if not _STATIC[0]:
        attrs["generator"] = _gen()
    return _run("gaussian_random", **attrs)


def standard_normal(shape, dtype=None):
    return randn(shape, dtype)


def randint(low=0, high=None, shape=(1,), dtype="int64"):
    if high is None:
        low, high = 0, low
    attrs = dict(low=int(low), high=int(high), shape=tuple(shape), dtype=dtype_name(dtype))
    if not _STATIC[0]:
        attrs["generator"] = _gen()
    return _run("randint", **attrs)


def randperm(n, dtype="int64"):
    attrs = dict(n=int(n), dtype=dtype_name(dtype))
    if not _STATIC[0]:
        attrs["generator"] = _gen()
    return _run("randperm", **attrs)


def bernoulli(x):
    x = _t(x)
    return _run("bernoulli", x, generator=_dev_gen(x))


def multinomial(x, num_samples=1, replacement=False):
    x = _t(x)
    return _run("multinomial", x, num_samples=num_samples, replacement=replacement,
                generator=_dev_gen(x))


def poisson(x):
    x = _t(x)
    return _run("poisson", x, generator=_dev_gen(x))


def _dev_gen(x):
    """The generator of ``x``'s device (a random op over a tensor draws
    there); a ``Variable``'s op draws from the executor's."""
    from ..framework import random as _random

    return _random.default_generator(x.device) if isinstance(x, torch.Tensor) else None

# -- sequence (ragged) family: dense [B, T, ...] + lengths [B] (ops/sequence.py) ------


def sequence_mask(lengths, maxlen=None, dtype="int64"):
    if maxlen is None:
        _refuse_static("sequence_mask without maxlen")
    return _run("sequence_mask", _t(lengths), maxlen=maxlen, out_dtype=dtype_name(dtype))


def sequence_pad(x, lengths, maxlen=None, pad_value=0.0):
    if maxlen is None:
        _refuse_static("sequence_pad without maxlen")
    return _run("sequence_pad", _t(x), _t(lengths), maxlen=maxlen, pad_value=float(pad_value))


def sequence_unpad(x, lengths):
    _refuse_static("sequence_unpad")
    return _run("sequence_unpad", _t(x), _t(lengths))


def sequence_pool(x, lengths, pooltype="SUM"):
    return _run("sequence_pool", _t(x), _t(lengths), pooltype=pooltype)


def segment_pool(x, segment_ids, num_segments, pooltype="SUM"):
    return _run("segment_pool", _t(x), _t(segment_ids), num_segments=int(num_segments),
                pooltype=pooltype)


def sequence_softmax(x, lengths):
    return _run("sequence_softmax", _t(x), _t(lengths))


def sequence_reverse(x, lengths):
    return _run("sequence_reverse", _t(x), _t(lengths))


def sequence_slice(x, offset, length, maxlen=None):
    return _run("sequence_slice", _t(x), _t(offset), _t(length), maxlen=maxlen)


def sequence_concat(x, xlen, y, ylen):
    return _run("sequence_concat", _t(x), _t(xlen), _t(y), _t(ylen))


def sequence_expand(x, rep):
    _refuse_static("sequence_expand")
    return _run("sequence_expand", _t(x), _t(rep))


def sequence_enumerate(x, win_size, pad_value=0):
    return _run("sequence_enumerate", _t(x), win_size=int(win_size), pad_value=pad_value)


def sequence_erase(x, tokens=()):
    _refuse_static("sequence_erase")
    return _run("sequence_erase", _t(x), tokens=tuple(tokens))


def sequence_conv(x, lengths, weight, context_length, context_start=None):
    return _run("sequence_conv", _t(x), _t(lengths), _t(weight),
                context_length=int(context_length), context_start=context_start)


def sequence_first_step(x, lengths):
    return _run("sequence_first_step", _t(x), _t(lengths))


def sequence_last_step(x, lengths):
    return _run("sequence_last_step", _t(x), _t(lengths))


# -- beam search and metrics ------------------------------------------------------------


def beam_search_step(log_probs, beam_scores, beam_size, end_id=None, first_step=False):
    return _run("beam_search_step", _t(log_probs), _t(beam_scores), beam_size=int(beam_size),
                end_id=end_id, first_step=first_step)


def beam_search_decode(parents, tokens, final_scores, end_id=None):
    return _run("beam_search_decode", _t(parents), _t(tokens), _t(final_scores), end_id=end_id)


def auc(predict, label, num_thresholds=4095, stat_pos=None, stat_neg=None, curve="ROC"):
    return _run("auc", _t(predict), _t(label), num_thresholds=num_thresholds,
                stat_pos=None if stat_pos is None else _t(stat_pos),
                stat_neg=None if stat_neg is None else _t(stat_neg), curve=curve)


def precision_recall(predict, label, num_classes):
    return _run("precision_recall", _t(predict), _t(label), num_classes=int(num_classes))


# -- detection (ops/detection.py) -------------------------------------------------------


def iou_similarity(x, y, box_normalized=True):
    return _run("iou_similarity", _t(x), _t(y), box_normalized=box_normalized)


def bbox_overlaps(x, y):
    return _run("bbox_overlaps", _t(x), _t(y))


def box_clip(boxes, im_info):
    return _run("box_clip", _t(boxes), _t(im_info))


def box_coder(prior_box, prior_box_var, target_box, code_type="encode_center_size",
              box_normalized=True):
    pb = _t(prior_box)
    # prior_box_var=None is the reference's unit variance
    var = _t(prior_box_var) if prior_box_var is not None else ones_like(pb)
    return _run("box_coder", pb, var, _t(target_box), code_type=code_type,
                box_normalized=box_normalized)


def prior_box(input, image, min_sizes, max_sizes=(), aspect_ratios=(1.0,),
              variances=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False, steps=(0.0, 0.0),
              offset=0.5):
    return _run("prior_box", _t(input), _t(image), min_sizes=tuple(min_sizes),
                max_sizes=tuple(max_sizes), aspect_ratios=tuple(aspect_ratios),
                variances=tuple(variances), flip=flip, clip=clip, step_w=steps[0],
                step_h=steps[1], offset=offset)


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01, downsample_ratio=32,
             clip_bbox=True, scale_x_y=1.0):
    return _run("yolo_box", _t(x), _t(img_size), anchors=tuple(anchors),
                class_num=int(class_num), conf_thresh=conf_thresh,
                downsample_ratio=downsample_ratio, clip_bbox=clip_bbox, scale_x_y=scale_x_y)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0, sampling_ratio=-1,
              aligned=False):
    if not isinstance(output_size, (tuple, list)):
        output_size = (output_size, output_size)
    return _run("roi_align", _t(x), _t(boxes), _t(boxes_num), pooled_height=output_size[0],
                pooled_width=output_size[1], spatial_scale=spatial_scale,
                sampling_ratio=sampling_ratio, aligned=aligned)


def nms(boxes, scores, iou_threshold=0.5, top_k=-1):
    return _run("nms", _t(boxes), _t(scores), iou_threshold=iou_threshold, top_k=top_k)


def multiclass_nms(bboxes, scores, score_threshold=0.05, nms_threshold=0.3, keep_top_k=100,
                   background_label=-1):
    return _run("multiclass_nms", _t(bboxes), _t(scores), score_threshold=score_threshold,
                nms_threshold=nms_threshold, keep_top_k=keep_top_k,
                background_label=background_label)


def sigmoid_focal_loss(x, label, fg_num, gamma=2.0, alpha=0.25):
    return _run("sigmoid_focal_loss", _t(x), _t(label), _t(fg_num), gamma=gamma, alpha=alpha)


def anchor_generator(x, anchor_sizes, aspect_ratios, stride, variances=(0.1, 0.1, 0.2, 0.2),
                     offset=0.5):
    return _run("anchor_generator", _t(x), anchor_sizes=tuple(anchor_sizes),
                aspect_ratios=tuple(aspect_ratios), stride=tuple(stride),
                variances=tuple(variances), offset=offset)


def density_prior_box(x, image, densities, fixed_sizes, fixed_ratios,
                      variances=(0.1, 0.1, 0.2, 0.2), step=(0.0, 0.0), offset=0.5, clip=False):
    return _run("density_prior_box", _t(x), _t(image), densities=tuple(densities),
                fixed_sizes=tuple(fixed_sizes), fixed_ratios=tuple(fixed_ratios),
                variances=tuple(variances), step=tuple(step), offset=offset, clip=clip)


def polygon_box_transform(x):
    return _run("polygon_box_transform", _t(x))


def bipartite_match(dist, match_type="bipartite", dist_threshold=0.5):
    return _run("bipartite_match", _t(dist), match_type=match_type,
                dist_threshold=dist_threshold)


def target_assign(x, match_indices, neg_value=0.0):
    return _run("target_assign", _t(x), _t(match_indices), neg_value=neg_value)


def box_decoder_and_assign(prior_box, prior_box_var, target_box, box_score,
                           box_clip=4.135166556742356):
    return _run("box_decoder_and_assign", _t(prior_box),
                _t(prior_box_var) if prior_box_var is not None else None, _t(target_box),
                _t(box_score), box_clip=box_clip)


def matrix_nms(bboxes, scores, score_threshold=0.05, post_threshold=0.0, nms_top_k=-1,
               keep_top_k=100, use_gaussian=False, gaussian_sigma=2.0, background_label=0):
    return _run("matrix_nms", _t(bboxes), _t(scores), score_threshold=score_threshold,
                post_threshold=post_threshold, nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                use_gaussian=use_gaussian, gaussian_sigma=gaussian_sigma,
                background_label=background_label)


def locality_aware_nms(bboxes, scores, score_threshold=0.05, nms_threshold=0.3, keep_top_k=100):
    return _run("locality_aware_nms", _t(bboxes), _t(scores), score_threshold=score_threshold,
                nms_threshold=nms_threshold, keep_top_k=keep_top_k)


def mine_hard_examples(cls_loss, match_indices, neg_pos_ratio=3.0, mining_type="max_negative",
                       sample_size=None):
    return _run("mine_hard_examples", _t(cls_loss), _t(match_indices),
                neg_pos_ratio=neg_pos_ratio, mining_type=mining_type, sample_size=sample_size)


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances, pre_nms_top_n=6000,
                       post_nms_top_n=1000, nms_thresh=0.5, min_size=0.1, eta=1.0):
    return _run("generate_proposals", _t(scores), _t(bbox_deltas), _t(im_info), _t(anchors),
                _t(variances), pre_nms_top_n=pre_nms_top_n, post_nms_top_n=post_nms_top_n,
                nms_thresh=nms_thresh, min_size=min_size, eta=eta)


def distribute_fpn_proposals(rois, min_level=2, max_level=5, refer_level=4, refer_scale=224):
    return _run("distribute_fpn_proposals", _t(rois), min_level=min_level, max_level=max_level,
                refer_level=refer_level, refer_scale=refer_scale)


def collect_fpn_proposals(multi_rois, multi_scores, post_nms_top_n=1000):
    return _run("collect_fpn_proposals", _t(multi_rois), _t(multi_scores),
                post_nms_top_n=post_nms_top_n)


def retinanet_detection_output(bboxes, scores, anchors, im_info, score_threshold=0.05,
                               nms_top_k=1000, keep_top_k=100, nms_threshold=0.3):
    return _run("retinanet_detection_output", _t(bboxes), _t(scores), _t(anchors), _t(im_info),
                score_threshold=score_threshold, nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                nms_threshold=nms_threshold)


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num, ignore_thresh=0.7,
                downsample_ratio=32, use_label_smooth=False):
    return _run("yolov3_loss", _t(x), _t(gt_box), _t(gt_label), anchors=tuple(anchors),
                anchor_mask=tuple(anchor_mask), class_num=class_num, ignore_thresh=ignore_thresh,
                downsample_ratio=downsample_ratio, use_label_smooth=use_label_smooth)


def rpn_target_assign(anchors, gt_boxes, rpn_batch_size_per_im=256, rpn_fg_fraction=0.5,
                      rpn_positive_overlap=0.7, rpn_negative_overlap=0.3, use_random=True):
    anchors = _t(anchors)
    return _run("rpn_target_assign", anchors, _t(gt_boxes), generator=_dev_gen(anchors),
                rpn_batch_size_per_im=rpn_batch_size_per_im, rpn_fg_fraction=rpn_fg_fraction,
                rpn_positive_overlap=rpn_positive_overlap,
                rpn_negative_overlap=rpn_negative_overlap, use_random=use_random)


# -- 3-D convolution and pooling, deformable convolution, data_norm, RoI pools ---------


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    out = _run("conv3d", _t(x), _t(weight), stride=stride, padding=padding, dilation=dilation,
               groups=groups, data_format=data_format)
    return out if bias is None else add(out, reshape(_t(bias), [1, -1, 1, 1, 1]))


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0, dilation=1,
                     groups=1, data_format="NCDHW"):
    out = _run("conv3d_transpose", _t(x), _t(weight), stride=stride, padding=padding,
               output_padding=output_padding, dilation=dilation, groups=groups,
               data_format=data_format)
    return out if bias is None else add(out, reshape(_t(bias), [1, -1, 1, 1, 1]))


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False, data_format="NCDHW"):
    return _run("pool3d", _t(x), kernel_size=kernel_size, stride=stride, padding=padding,
                pooling_type="max", ceil_mode=ceil_mode, data_format=data_format)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               data_format="NCDHW"):
    return _run("pool3d", _t(x), kernel_size=kernel_size, stride=stride, padding=padding,
                pooling_type="avg", ceil_mode=ceil_mode, exclusive=exclusive,
                data_format=data_format)


def deformable_conv(x, offset, mask, weight, bias=None, stride=1, padding=0, dilation=1,
                    deformable_groups=1, groups=1, im2col_step=1):
    out = _run("deformable_conv", _t(x), _t(offset), _t(mask) if mask is not None else None,
               _t(weight), stride=stride, padding=padding, dilation=dilation,
               deformable_groups=deformable_groups, groups=groups, im2col_step=im2col_step)
    return out if bias is None else add(out, reshape(_t(bias), [1, -1, 1, 1]))


def data_norm(x, batch_size, batch_sum, batch_square_sum, epsilon=1e-4):
    return _run("data_norm", _t(x), _t(batch_size), _t(batch_sum), _t(batch_square_sum),
                epsilon=epsilon)


def roi_pool(x, rois, batch_indices=None, pooled_height=1, pooled_width=1, spatial_scale=1.0):
    return _run("roi_pool", _t(x), _t(rois),
                batch_indices=None if batch_indices is None else _t(batch_indices),
                pooled_height=pooled_height, pooled_width=pooled_width,
                spatial_scale=spatial_scale)


def psroi_pool(x, rois, output_channels, pooled_height, pooled_width, spatial_scale=1.0,
               batch_indices=None):
    return _run("psroi_pool", _t(x), _t(rois),
                batch_indices=None if batch_indices is None else _t(batch_indices),
                output_channels=output_channels, pooled_height=pooled_height,
                pooled_width=pooled_width, spatial_scale=spatial_scale)


# -- linear algebra, statistics and pointwise extras --------------------------------------


def cholesky_solve(b, l, upper=False):
    return _run("cholesky_solve", _t(b), _t(l), upper=upper)


def lu(x):
    return _run("lu", _t(x))


def eigvalsh(x, UPLO="L"):
    return _run("eigvalsh", _t(x), UPLO=UPLO)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False):
    return _run("matrix_norm", _t(x), p=p, axis=tuple(axis), keepdim=keepdim)


def cov(x, rowvar=True, ddof=True):
    return _run("cov", _t(x), rowvar=rowvar, ddof=ddof)


def corrcoef(x, rowvar=True):
    return _run("corrcoef", _t(x), rowvar=rowvar)


def householder_product(x, tau):
    return _run("householder_product", _t(x), _t(tau))


def multi_dot(arrays):
    return _run("multi_dot", *[_t(a) for a in arrays])


def bincount(x, weights=None, minlength=0, length=None):
    if length is None:
        _refuse_static("bincount without length")
    return _run("bincount", _t(x), weights=None if weights is None else _t(weights),
                minlength=minlength, length=length)


def unique_consecutive(x, return_inverse=False, return_counts=False, axis=None):
    _refuse_static("unique_consecutive")
    vals, inverse, counts = _run("unique_consecutive", _t(x), return_inverse=return_inverse,
                                 return_counts=return_counts, axis=axis)
    res = [vals] + [r for r, want in ((inverse, return_inverse), (counts, return_counts))
                    if want]
    return res[0] if len(res) == 1 else tuple(res)


def logit(x, eps=None):
    return _run("logit", _t(x), eps=eps)


def logaddexp(x, y):
    return _run("logaddexp", _t(x), _t(y))


def heaviside(x, y):
    return _run("heaviside", _t(x), _t(y))


def gcd(x, y):
    return _run("gcd", _t(x), _t(y))


def lcm(x, y):
    return _run("lcm", _t(x), _t(y))


def nextafter(x, y):
    return _run("nextafter", _t(x), _t(y))


def ldexp(x, y):
    return _run("ldexp", _t(x), _t(y))


def copysign(x, y):
    return _run("copysign", _t(x), _t(y))


def hypot(x, y):
    return _run("hypot", _t(x), _t(y))


def rad2deg(x):
    return _run("rad2deg", _t(x))


def deg2rad(x):
    return _run("deg2rad", _t(x))


def conj(x):
    return _run("conj", _t(x))


def i0(x):
    return _run("i0", _t(x))


def sinc(x):
    return _run("sinc", _t(x))


def signbit(x):
    return _run("signbit", _t(x))



def label_smooth(label, prior_dist=None, epsilon=0.1):
    return _run("label_smooth", _t(label), epsilon=epsilon,
                prior_dist=None if prior_dist is None else _t(prior_dist))


def glu(x, axis=-1):
    return _run("glu", _t(x), axis=axis)


def rot90(x, k=1, axes=(0, 1)):
    return _run("rot90", _t(x), k=k, axes=tuple(axes))


def pad3d(x, paddings, mode="constant", value=0.0, data_format="NCDHW"):
    return _run("pad3d", _t(x), paddings=tuple(paddings), mode=mode, value=value,
                data_format=data_format)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=True):
    return _run("grid_sample", _t(x), _t(grid), mode=mode, padding_mode=padding_mode,
                align_corners=align_corners)


def affine_grid(theta, out_shape, align_corners=True):
    return _run("affine_grid", _t(theta), out_shape=tuple(out_shape),
                align_corners=align_corners)


def getitem(x, idx):
    """``x[idx]``; a tensor index goes through ``index_select`` (1-D) or
    ``gather``, a boolean one raises (its size is the data's)."""
    if isinstance(idx, (torch.Tensor, _Variable)):
        if torch_dtype(idx.dtype) == torch.bool:
            raise UnimplementedError("boolean mask indexing produces dynamic shapes; use "
                                     "paddle_tpu_torch.where/masked_select")
        if len(idx.shape) == 1:
            return index_select(x, idx, axis=0)
        return gather(x, idx, axis=0)
    return _run("getitem", _t(x), idx=idx)


def _bind_static(variable_cls, mode):
    """Take ``static.program``'s ``Variable`` class and mode flag (the
    front and the static package import each other; whichever loads last
    binds)."""
    global _Variable, _STATIC
    _Variable, _STATIC = variable_cls, mode


_program = sys.modules.get(__name__.rpartition(".")[0] + ".static.program")
if _program is not None and hasattr(_program, "_static_mode"):
    _bind_static(_program.Variable, _program._static_mode)
