"""Registry kernels of the tensor, linalg and ``nn.functional`` namespaces.

Counterparts of the JAX package's registry kernels the dygraph front
(:mod:`paddle_tpu_torch.ops`) dispatches to: ``paddle_tpu/ops/kernels.py``
(unary and binary math, activations, reductions, manipulation, the
vision and loss ops), ``linalg_kernels.py``, ``math_extra.py`` and
``nn_extra.py``. Each takes the JAX kernel's attribute names and follows
its expression, so a program either package saves runs in the other; each
runs on ``meta`` tensors too (static shape inference), except the ops
whose output shape depends on the data (``unique``, ``nonzero``,
``masked_select``), which the front refuses in a static program.
"""
from __future__ import annotations


import numpy as np
import torch
import torch.nn.functional as _F

from ..framework import random as _random
from ..framework.dtype import torch_dtype
from .registry import register_op

__all__ = []


def _dims(axis):
    if axis is None:
        return None
    return tuple(axis) if isinstance(axis, (list, tuple)) else (int(axis),)


def _reduce(fn, x, axis, keepdim):
    """``fn`` over ``axis`` (an axis, a list, or None for all); ``fn`` takes
    ``dim`` as a tuple."""
    dims = _dims(axis)
    if dims is None:
        out = fn(x)
        return out.reshape((1,) * x.dim()) if keepdim else out
    return fn(x, dim=dims, keepdim=keepdim)


def _over(fn):
    """A torch reduction that takes one ``dim`` at a time, over several."""
    def red(x, dim=None, keepdim=False):
        if dim is None:
            return fn(x.reshape(-1), 0)
        out = x
        for d in sorted((d % x.dim() for d in dim), reverse=True):
            out = fn(out, d, keepdim=keepdim)
        return out

    return red


# -- binary and unary math (kernels.py:32-110) --------------------------------

_BINARY = {
    "elementwise_pow": torch.pow,
    "elementwise_mod": torch.remainder,
    "elementwise_floordiv": torch.floor_divide,
    "atan2": torch.atan2,
    "bitwise_and": torch.bitwise_and,
    "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor,
}
for _name, _fn in _BINARY.items():
    register_op(_name)(lambda x, y, _f=_fn, **kw: _f(x, y))

_UNARY = {
    "abs": torch.abs, "exp": torch.exp, "expm1": torch.expm1, "log": torch.log,
    "log2": torch.log2, "log10": torch.log10, "log1p": torch.log1p, "rsqrt": torch.rsqrt,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan, "asin": torch.asin,
    "acos": torch.acos, "atan": torch.atan, "sinh": torch.sinh, "cosh": torch.cosh,
    "asinh": torch.asinh, "acosh": torch.acosh, "atanh": torch.atanh, "floor": torch.floor,
    "ceil": torch.ceil, "round": torch.round, "sign": torch.sign,
    "reciprocal": torch.reciprocal, "erf": torch.erf, "erfinv": torch.erfinv,
    "digamma": torch.digamma, "lgamma": torch.lgamma, "logsigmoid": _F.logsigmoid,
    "softsign": _F.softsign, "isnan": torch.isnan, "isinf": torch.isinf,
    "isfinite": torch.isfinite, "trunc": torch.trunc, "bitwise_not": torch.bitwise_not,
    "frac": torch.frac, "angle": torch.angle, "real": torch.real, "imag": torch.imag,
    "selu": torch.selu, "swish": _F.silu, "mish": _F.mish,
    "tanh_shrink": lambda x: x - torch.tanh(x),
}
for _name, _fn in _UNARY.items():
    register_op(_name)(lambda x, _f=_fn, **kw: _f(x))


def _jnp_clip(x, lo, hi):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``. On a float input the
    gradient at a bound is 0.5, as ``jnp.maximum``'s and ``jnp.minimum``'s
    are at a tie (``torch.clamp``'s is 1 there); values equal
    ``torch.clamp``'s. The bounds are filled on the input's device, which a
    graph capture allows."""
    if not x.is_floating_point():
        return torch.clamp(x, lo, hi)

    def bound(v):
        if isinstance(v, torch.Tensor):
            return v.to(device=x.device, dtype=x.dtype)
        return torch.full((), v, dtype=x.dtype, device=x.device)

    if lo is not None:
        x = torch.maximum(x, bound(lo))
    if hi is not None:
        x = torch.minimum(x, bound(hi))
    return x


@register_op("clip")
def clip(x, *, min=None, max=None):
    return _jnp_clip(x, min, max)


@register_op("pow")
def pow_(x, *, factor=1.0):
    return torch.pow(x, factor)


# -- activations with attributes (kernels.py:133-240) -------------------------


@register_op("relu6")
def relu6(x, *, threshold=6.0):
    return _jnp_clip(x, 0.0, threshold)


@register_op("leaky_relu")
def leaky_relu(x, *, alpha=0.01):
    return torch.where(x >= 0, x, alpha * x)


@register_op("elu")
def elu(x, *, alpha=1.0):
    return _F.elu(x, alpha)


@register_op("celu")
def celu(x, *, alpha=1.0):
    return _F.celu(x, alpha)


@register_op("hard_sigmoid")
def hard_sigmoid(x, *, slope=0.1666667, offset=0.5):
    return torch.clamp(x * slope + offset, 0.0, 1.0)


@register_op("hard_swish")
def hard_swish(x, *, threshold=6.0, scale=6.0, offset=3.0):
    return x * torch.clamp(x + offset, 0.0, threshold) / scale


@register_op("hard_tanh")
def hard_tanh(x, *, min=-1.0, max=1.0):
    return torch.clamp(x, min, max)


@register_op("hard_shrink")
def hard_shrink(x, *, threshold=0.5):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


@register_op("softshrink")
def softshrink(x, *, lambda_=0.5):
    zero = torch.zeros_like(x)
    return torch.where(x > lambda_, x - lambda_, torch.where(x < -lambda_, x + lambda_, zero))


@register_op("softplus")
def softplus(x, *, beta=1.0, threshold=20.0):
    return torch.where(beta * x > threshold, x, _F.softplus(beta * x) / beta)


@register_op("prelu")
def prelu(x, alpha, **kw):
    return torch.where(x >= 0, x, alpha * x)


@register_op("log_softmax")
def log_softmax(x, *, axis=-1):
    return torch.log_softmax(x, dim=axis)


@register_op("maxout")
def maxout(x, *, groups, axis=1):
    axis = axis % x.dim()
    shape = list(x.shape)
    shape[axis:axis + 1] = [shape[axis] // groups, groups]
    return torch.amax(x.reshape(shape), dim=axis + 1)


# -- matrix ops (kernels.py:242-320, linalg_kernels.py) ------------------------


@register_op("bmm")
def bmm(x, y, **kw):
    return torch.matmul(x, y)


@register_op("dot")
def dot(x, y, **kw):
    return torch.sum(x * y, dim=-1)


@register_op("addmm")
def addmm(input, x, y, *, beta=1.0, alpha=1.0):
    return beta * input + alpha * (x @ y)


@register_op("linear")
def linear(x, w, b=None, **kw):
    """``x @ w (+ b)`` with Paddle's ``[in, out]`` weight, through
    :func:`paddle_tpu_torch.nn.functional._linear` (the AMP seam)."""
    from ..nn import functional as F

    return F._linear(x, w, b)


@register_op("cross")
def cross(x, y, *, axis=-1):
    return torch.linalg.cross(x, y, dim=axis)


@register_op("cholesky")
def cholesky(x, *, upper=False):
    low = torch.linalg.cholesky(x)
    return low.transpose(-1, -2) if upper else low


@register_op("matrix_power")
def matrix_power(x, *, n):
    return torch.linalg.matrix_power(x, n)


@register_op("inverse")
def inverse(x, **kw):
    return torch.linalg.inv(x)


@register_op("einsum")
def einsum(*operands, equation):
    return torch.einsum(equation, *operands)


@register_op("det")
def det(x, **kw):
    return torch.linalg.det(x)


@register_op("slogdet", num_outputs=2)
def slogdet(x, **kw):
    sign, logabs = torch.linalg.slogdet(x)
    return sign, logabs


@register_op("matrix_rank")
def matrix_rank(x, *, tol=None, hermitian=False):
    """``jnp.linalg.matrix_rank``: singular values above ``tol``, by default
    ``max(s) * max(M, N) * eps``."""
    s = torch.linalg.svdvals(x)
    if tol is None:
        tol = s.amax(-1, keepdim=True) * max(x.shape[-2:]) * torch.finfo(s.dtype).eps
    return torch.sum(s > tol, dim=-1)


@register_op("solve")
def solve(a, b, **kw):
    return torch.linalg.solve(a, b)


@register_op("triangular_solve")
def triangular_solve(a, b, *, upper=True, transpose=False, unitriangular=False):
    if transpose:
        a, upper = a.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(a, b, upper=upper, unitriangular=unitriangular)


@register_op("lstsq", num_outputs=4)
def lstsq(a, b, *, rcond=None):
    """``(solution, residuals, rank, singular values)`` as
    ``jnp.linalg.lstsq`` returns them (the residuals of a full-rank tall
    system, else empty)."""
    sol = torch.linalg.lstsq(a.cpu(), b.cpu(), rcond=rcond, driver="gelsd")
    m, n = a.shape[-2:]
    res = sol.residuals if sol.residuals.numel() or m <= n else torch.sum(
        (a.cpu() @ sol.solution - b.cpu()) ** 2, dim=-2)
    if int(sol.rank) < n or m <= n:
        res = torch.zeros((0,), dtype=a.dtype)
    return tuple(t.to(a.device) for t in (sol.solution, res, sol.rank, sol.singular_values))


@register_op("svd", num_outputs=3)
def svd(x, *, full_matrices=False):
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices)
    return u, s, vh


@register_op("qr", num_outputs=2)
def qr(x, *, mode="reduced"):
    q, r = torch.linalg.qr(x, mode=mode)
    return q, r


@register_op("eig", num_outputs=2)
def eig(x, **kw):
    w, v = torch.linalg.eig(x)
    return w, v


@register_op("eigh", num_outputs=2)
def eigh(x, *, UPLO="L"):
    """Of the symmetrized input, as ``jnp.linalg.eigh(symmetrize_input=True)``."""
    w, v = torch.linalg.eigh((x + x.transpose(-1, -2).conj()) / 2, UPLO=UPLO)
    return w, v


@register_op("pinv")
def pinv(x, *, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


@register_op("trace")
def trace(x, *, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset=offset, dim1=axis1, dim2=axis2).sum(-1)


@register_op("kron")
def kron(x, y, **kw):
    return torch.kron(x, y)


# -- reductions (kernels.py:323-400, math_extra.py:31-115) ---------------------

for _name, _fn in {"reduce_max": torch.amax, "reduce_min": torch.amin,
                   "reduce_prod": _over(torch.prod), "reduce_any": _over(torch.any),
                   "reduce_all": _over(torch.all)}.items():
    register_op(_name)(lambda x, *, dim=None, keep_dim=False, _f=_fn:
                       _reduce(_f, x, dim, keep_dim))


@register_op("logsumexp")
def logsumexp(x, *, axis=None, keepdim=False):
    dims = tuple(range(x.dim())) if axis is None else _dims(axis)
    return torch.logsumexp(x, dim=dims, keepdim=keepdim)


@register_op("arg_min")
def arg_min(x, *, axis=None, keepdims=False, dtype="int64"):
    out = torch.argmin(x, dim=axis, keepdim=keepdims if axis is not None else False)
    return out.to(torch_dtype(dtype))


@register_op("p_norm")
def p_norm(x, *, porder=2.0, axis=None, keepdim=False, epsilon=1e-12):
    """``(sum |x|^p + epsilon)^(1/p)``, ``max |x|`` at ``p = inf``
    (kernels.py:375)."""
    if porder == float("inf"):
        return _reduce(torch.amax, x.abs(), axis, keepdim)
    if porder == float("-inf"):
        return _reduce(torch.amin, x.abs(), axis, keepdim)
    s = _reduce(torch.sum, torch.pow(x.abs(), porder), axis, keepdim)
    return torch.pow(s + epsilon, 1.0 / porder)


@register_op("cumsum")
def cumsum(x, *, axis=None, flatten=False):
    if axis is None or flatten:
        return torch.cumsum(x.reshape(-1), 0)
    return torch.cumsum(x, axis)


@register_op("cumprod")
def cumprod(x, *, dim=None):
    if dim is None:
        return torch.cumprod(x.reshape(-1), 0)
    return torch.cumprod(x, dim)


@register_op("std")
def std(x, *, axis=None, unbiased=True, keepdim=False):
    return torch.std(x, dim=_dims(axis), correction=1 if unbiased else 0, keepdim=keepdim)


@register_op("var")
def var(x, *, axis=None, unbiased=True, keepdim=False):
    return torch.var(x, dim=_dims(axis), correction=1 if unbiased else 0, keepdim=keepdim)


def _quantile(x, q, axis, keepdim, nan):
    fn = torch.nanquantile if nan else torch.quantile
    if axis is None:
        out = fn(x.reshape(-1), q)
        return out.reshape((1,) * x.dim()) if keepdim else out
    return fn(x, q, dim=axis, keepdim=keepdim)


@register_op("median")
def median(x, *, axis=None, keepdim=False):
    """The mean of the two middle values for an even count, as
    ``jnp.median``."""
    return _quantile(x, 0.5, axis, keepdim, nan=False)


@register_op("nanmedian")
def nanmedian(x, *, axis=None, keepdim=False):
    return _quantile(x, 0.5, axis, keepdim, nan=True)


@register_op("quantile")
def quantile(x, *, q, axis=None, keepdim=False, interpolation="linear"):
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    if axis is None:
        out = torch.quantile(x.reshape(-1), qt, interpolation=interpolation)
        return out.reshape(out.shape + (1,) * x.dim()) if keepdim else out
    return torch.quantile(x, qt, dim=axis, keepdim=keepdim, interpolation=interpolation)


@register_op("mode", num_outputs=2)
def mode(x, *, axis=-1, keepdim=False):
    """The most frequent value along ``axis`` (the smallest among ties, as
    ``jnp.unique`` orders them) and the last index holding it."""
    moved = x.movedim(axis, -1)
    srt = torch.sort(moved, dim=-1).values
    n = srt.shape[-1]
    same = srt.unsqueeze(-1) == srt.unsqueeze(-2)
    counts = same.sum(-1)
    m = torch.gather(srt, -1, torch.argmax(counts, dim=-1, keepdim=True)).squeeze(-1)
    pos = torch.arange(n, device=x.device).expand_as(moved)
    idx = torch.where(moved == m.unsqueeze(-1), pos, torch.full_like(pos, -1)).amax(-1)
    if keepdim:
        m, idx = m.unsqueeze(axis), idx.unsqueeze(axis)
    return m, idx


@register_op("histogram")
def histogram(x, *, bins=100, min=0, max=0, weight=None, density=False):
    """Counts of ``x`` (flattened) in ``bins`` equal bins over ``[min,
    max]``; both 0 means the data's range (``jnp.histogram``)."""
    flat = x.reshape(-1).to(torch.float64)
    lo, hi = float(min), float(max)
    if lo == 0 and hi == 0:
        lo, hi = float(flat.min()), float(flat.max())
    w = None if weight is None else torch.as_tensor(weight, device=x.device).reshape(-1)
    h, _ = torch.histogram(flat.cpu(), bins=int(bins), range=(lo, hi),
                           weight=None if w is None else w.to(torch.float64).cpu(),
                           density=density)
    h = h.to(x.device)
    return h if density or w is not None else h.to(torch.int64)


@register_op("nansum")
def nansum(x, *, axis=None, keepdim=False):
    return torch.nansum(x, dim=_dims(axis), keepdim=keepdim)


@register_op("nanmean")
def nanmean(x, *, axis=None, keepdim=False):
    return torch.nanmean(x, dim=_dims(axis), keepdim=keepdim)


@register_op("amax")
def amax(x, *, axis=None, keepdim=False):
    return _reduce(torch.amax, x, axis, keepdim)


@register_op("amin")
def amin(x, *, axis=None, keepdim=False):
    return _reduce(torch.amin, x, axis, keepdim)


@register_op("searchsorted")
def searchsorted(sorted_sequence, values, *, out_int32=False, right=False):
    return torch.searchsorted(sorted_sequence, values, right=right, out_int32=out_int32)


@register_op("unique", num_outputs=4)
def unique(x, *, return_index=False, return_inverse=False, return_counts=False, axis=None):
    """``(out, index, inverse, counts)`` as ``np.unique`` gives them (the
    first index of each value)."""
    out, index, inverse, counts = np.unique(x.detach().cpu().numpy(), return_index=True,
                                            return_inverse=True, return_counts=True, axis=axis)
    return tuple(torch.from_numpy(np.asarray(a)).to(x.device)
                 for a in (out, index, inverse.reshape(-1), counts))


@register_op("nonzero")
def nonzero(x, *, as_tuple=False):
    nz = torch.nonzero(x)
    return tuple(nz.unbind(1)) if as_tuple else nz


@register_op("masked_select")
def masked_select(x, mask, **kw):
    return torch.masked_select(x, mask)


@register_op("allclose")
def allclose(x, y, *, rtol=1e-5, atol=1e-8, equal_nan=False):
    return torch.all(torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan))


@register_op("isclose")
def isclose(x, y, *, rtol=1e-5, atol=1e-8, equal_nan=False):
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


@register_op("equal_all")
def equal_all(x, y, **kw):
    if tuple(x.shape) != tuple(y.shape):
        return torch.zeros((), dtype=torch.bool, device=x.device)
    return torch.all(x == y)


@register_op("lerp")
def lerp(x, y, weight, **kw):
    return x + weight * (y - x)


@register_op("diff")
def diff(x, *, n=1, axis=-1):
    return torch.diff(x, n=n, dim=axis)


@register_op("as_complex")
def as_complex(x, **kw):
    return torch.complex(x[..., 0], x[..., 1])


@register_op("as_real")
def as_real(x, **kw):
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


# -- manipulation (kernels.py:411-700) -----------------------------------------


@register_op("flatten")
def flatten(x, *, start_axis=0, stop_axis=-1):
    if x.dim() == 0:
        return x.reshape((1,))
    return torch.flatten(x, start_axis % x.dim(), stop_axis % x.dim())


@register_op("squeeze")
def squeeze(x, *, axes=None):
    if axes is None or axes == []:
        return torch.squeeze(x)
    axes = [axes] if isinstance(axes, int) else list(axes)
    dims = tuple(a % x.dim() for a in axes if x.shape[a % x.dim()] == 1)
    return torch.squeeze(x, dims) if dims else x


@register_op("unsqueeze")
def unsqueeze(x, *, axes):
    out = x
    for a in [axes] if isinstance(axes, int) else list(axes):
        out = torch.unsqueeze(out, a)
    return out


@register_op("unstack", num_outputs=-1)
def unstack(x, *, axis=0, num=None):
    return tuple(torch.unbind(x, axis))


@register_op("unbind", num_outputs=-1)
def unbind(x, *, axis=0):
    return tuple(torch.unbind(x, axis))


@register_op("strided_slice")
def strided_slice(x, *, axes, starts, ends, strides):
    """Python slicing per axis; a negative stride (which torch's slicing
    does not take) picks its indices with ``index_select``."""
    out = x
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        if sd > 0:
            index = [slice(None)] * out.dim()
            index[ax] = slice(st, en, sd)
            out = out[tuple(index)]
        else:
            picked = list(range(out.shape[ax]))[slice(st, en, sd)]
            out = out.index_select(ax, torch.tensor(picked, dtype=torch.int64,
                                                    device=out.device))
    return out


@register_op("gather")
def gather(x, index, *, axis=0):
    if index.dim() == 0:
        index = index.reshape(1)
    out = torch.index_select(x, axis, index.reshape(-1).to(torch.int64))
    shape = list(x.shape)
    shape[axis:axis + 1] = list(index.shape)
    return out.reshape(shape)


@register_op("gather_nd")
def gather_nd(x, index, **kw):
    return x[tuple(index.to(torch.int64).movedim(-1, 0))]


@register_op("scatter")
def scatter(x, index, updates, *, overwrite=True):
    idx = index.reshape(-1).to(torch.int64)
    if overwrite:
        return x.index_put((idx,), updates)
    zeroed = x.index_put((idx,), torch.zeros_like(updates))
    return zeroed.index_put((idx,), updates, accumulate=True)


@register_op("scatter_nd_add")
def scatter_nd_add(x, index, updates, **kw):
    return x.index_put(tuple(index.to(torch.int64).movedim(-1, 0)), updates, accumulate=True)


@register_op("index_select")
def index_select(x, index, *, axis=0):
    return torch.index_select(x, axis, index.to(torch.int64))


@register_op("index_sample")
def index_sample(x, index, **kw):
    return torch.gather(x, -1, index.to(torch.int64))


@register_op("take_along_axis")
def take_along_axis(x, index, *, axis):
    return torch.gather(x, axis, index.to(torch.int64))


@register_op("put_along_axis")
def put_along_axis(x, index, values, *, axis, reduce="assign"):
    values = torch.broadcast_to(values, index.shape).to(x.dtype)
    if reduce == "assign":
        return torch.scatter(x, axis, index.to(torch.int64), values)
    if reduce == "add":
        return torch.scatter_add(x, axis, index.to(torch.int64), values)
    raise ValueError(f"unsupported reduce mode {reduce!r}")


@register_op("tile")
def tile(x, *, repeat_times):
    return torch.tile(x, tuple(repeat_times))


@register_op("expand")
def expand(x, *, shape):
    offset = len(shape) - x.dim()
    shape = [x.shape[i - offset] if (s == -1 and i >= offset) else s
             for i, s in enumerate(shape)]
    return torch.broadcast_to(x, shape)


@register_op("broadcast_to")
def broadcast_to(x, *, shape):
    return torch.broadcast_to(x, tuple(shape))


@register_op("masked_fill")
def masked_fill(x, mask, *, value):
    return torch.where(mask, torch.full_like(x, value), x)


@register_op("pad")
def pad(x, *, paddings, mode="constant", value=0.0):
    """``paddings`` is flat ``[before0, after0, before1, after1, ...]``
    from the first axis (kernels.py:578)."""
    pairs = [(paddings[2 * i], paddings[2 * i + 1]) for i in range(len(paddings) // 2)]
    flat = [p for pair in reversed(pairs) for p in pair]
    if mode == "constant":
        return _F.pad(x, flat, mode="constant", value=value)
    # torch pads the trailing axes only: from the first padded one on
    first = next((i for i, pr in enumerate(pairs) if pr != (0, 0)), len(pairs))
    lead = x.dim() - len(pairs)
    keep = 2 * (x.dim() - lead - first)
    return _F.pad(x, flat[:keep], mode={"replicate": "replicate", "reflect": "reflect",
                                        "circular": "circular"}[mode])


@register_op("roll")
def roll(x, *, shifts, axis=None):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, axis)


@register_op("flip")
def flip(x, *, axis):
    return torch.flip(x, [axis] if isinstance(axis, int) else list(axis))


@register_op("tril")
def tril(x, *, diagonal=0):
    return torch.tril(x, diagonal)


@register_op("triu")
def triu(x, *, diagonal=0):
    return torch.triu(x, diagonal)


@register_op("diag")
def diag(x, *, offset=0, padding_value=0.0):
    if x.dim() == 1:
        out = torch.diag(x, offset)
        if padding_value != 0.0:
            mask = torch.diag(torch.ones_like(x), offset).to(torch.bool)
            out = torch.where(mask, out, torch.full_like(out, padding_value))
        return out
    return torch.diagonal(x, offset)


@register_op("diag_embed")
def diag_embed(x, *, offset=0):
    return torch.diag_embed(x, offset)


@register_op("diagflat")
def diagflat(x, *, offset=0):
    return torch.diagflat(x, offset)


@register_op("one_hot")
def one_hot(x, *, num_classes):
    return _F.one_hot(x.to(torch.int64), num_classes).to(torch.float32)


@register_op("argsort", num_outputs=2)
def argsort(x, *, axis=-1, descending=False):
    """A stable sort of ``sign * x`` (kernels.py:646): equal values keep
    their order in both directions."""
    idx = torch.sort(-x if descending else x, dim=axis, stable=True).indices
    return torch.gather(x, axis, idx), idx


@register_op("sort")
def sort(x, *, axis=-1, descending=False):
    out = torch.sort(x, dim=axis).values
    return torch.flip(out, [axis]) if descending else out


@register_op("kthvalue", num_outputs=2)
def kthvalue(x, *, k, axis=-1, keepdim=False):
    vals, idx = torch.sort(x, dim=axis, stable=True)
    v = vals.select(axis, k - 1)
    i = idx.select(axis, k - 1)
    if keepdim:
        v, i = v.unsqueeze(axis), i.unsqueeze(axis)
    return v, i


@register_op("meshgrid", num_outputs=-1)
def meshgrid(*xs, **kw):
    return tuple(torch.meshgrid(*xs, indexing="ij"))


@register_op("repeat_interleave")
def repeat_interleave(x, *, repeats, axis=None):
    if axis is None:
        return torch.repeat_interleave(x.reshape(-1), repeats)
    return torch.repeat_interleave(x, repeats, axis)


@register_op("shard_index")
def shard_index(x, *, index_num, nshards, shard_id, ignore_value=-1):
    size = (index_num + nshards - 1) // nshards
    lo, hi = shard_id * size, (shard_id + 1) * size
    return torch.where((x >= lo) & (x < hi), x - lo, torch.full_like(x, ignore_value))


@register_op("multiplex")
def multiplex(index, *xs, **kw):
    rows = index.reshape(-1).to(torch.int64)
    return torch.stack(xs)[rows, torch.arange(rows.shape[0], device=rows.device)]


@register_op("pixel_shuffle")
def pixel_shuffle(x, *, upscale_factor, data_format="NCHW"):
    return _F.pixel_shuffle(x, upscale_factor)


@register_op("pixel_unshuffle")
def pixel_unshuffle(x, *, downscale_factor, data_format="NCHW"):
    if data_format == "NHWC":
        return _F.pixel_unshuffle(x.permute(0, 3, 1, 2), downscale_factor).permute(0, 2, 3, 1)
    return _F.pixel_unshuffle(x, downscale_factor)


@register_op("channel_shuffle")
def channel_shuffle(x, *, groups, data_format="NCHW"):
    if data_format == "NHWC":
        n, h, w, c = x.shape
        return x.reshape(n, h, w, groups, c // groups).transpose(3, 4).reshape(n, h, w, c)
    n, c = x.shape[:2]
    return x.reshape(n, groups, c // groups, *x.shape[2:]).transpose(1, 2).reshape(x.shape)


# -- vision ops (kernels.py:699-1075) ------------------------------------------


def _pair(v):
    return tuple(int(a) for a in v) if isinstance(v, (list, tuple)) else (int(v), int(v))


@register_op("conv1d")
def conv1d(x, w, *, stride=1, padding=0, dilation=1, groups=1):
    from ..nn import functional as F

    s, d, p = (v if isinstance(v, int) else v[0] for v in (stride, dilation, padding))
    out = F._conv2d(x[:, :, None, :], w[:, :, None, :], None, stride=(1, s),
                    padding=[(0, 0), (p, p)], dilation=(1, d), groups=groups)
    return out[:, :, 0, :]


@register_op("conv2d_transpose")
def conv2d_transpose(x, w, *, stride=1, padding=0, output_padding=0, dilation=1, groups=1,
                     data_format="NCHW"):
    """The IOHW weight of Paddle's transposed convolution
    (kernels.py:738)."""
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    y = _F.conv_transpose2d(x, w, None, _pair(stride), _pair(padding), _pair(output_padding),
                            groups, _pair(dilation))
    return y.permute(0, 2, 3, 1) if data_format == "NHWC" else y


@register_op("adaptive_pool2d")
def adaptive_pool2d(x, *, output_size, pooling_type="avg", data_format="NCHW"):
    """Mean (or max) over the windows ``[floor(i·H/oh), ceil((i+1)·H/oh))``
    (kernels.py:851-873)."""
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    fn = _F.adaptive_max_pool2d if pooling_type == "max" else _F.adaptive_avg_pool2d
    y = fn(x, _pair(output_size))
    return y.permute(0, 2, 3, 1) if data_format == "NHWC" else y


@register_op("group_norm")
def group_norm(x, scale=None, bias=None, *, groups, epsilon=1e-5, data_format="NCHW"):
    n, c = x.shape[0], x.shape[1]
    xr = x.reshape(n, groups, c // groups, *x.shape[2:])
    axes = tuple(range(2, xr.dim()))
    mean = xr.mean(axes, keepdim=True)
    var = xr.var(axes, unbiased=False, keepdim=True)
    y = ((xr - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    shape = [1, c] + [1] * (x.dim() - 2)
    if scale is not None:
        y = y * scale.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y


@register_op("instance_norm")
def instance_norm(x, scale=None, bias=None, *, epsilon=1e-5):
    axes = tuple(range(2, x.dim()))
    mean = x.mean(axes, keepdim=True)
    var = x.var(axes, unbiased=False, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + epsilon)
    shape = [1, x.shape[1]] + [1] * (x.dim() - 2)
    if scale is not None:
        y = y * scale.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y


def _keys_cubic(x):
    """Keys' cubic kernel with ``a = -0.5`` (``jax.image``'s ``cubic``)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _triangle(x):
    return torch.clamp(1.0 - x, min=0.0)


def _resize_weights(n_in, n_out, kernel, device):
    """``jax.image.scale_and_translate``'s weights ``[n_in, n_out]`` of one
    axis: samples at half-pixel centres, the kernel widened by ``n_in /
    n_out`` when shrinking (antialiasing), each output's weights summing
    to one over the input's pixels, zero for a sample outside them."""
    inv = n_in / n_out
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv - 0.5
    x = torch.abs(sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[
        :, None]) / max(inv, 1.0)
    w = kernel(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    return torch.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0.0)


@register_op("interpolate")
def interpolate(x, *, size=None, scale_factor=None, mode="nearest", align_corners=False,
                data_format="NCHW"):
    """Resize of the spatial axes (one, two or three) as ``jax.image.resize``
    does: ``nearest`` takes the pixel under each half-pixel centre; the
    ``linear`` family and ``bicubic`` weigh the input by the triangle or
    Keys' cubic kernel per axis (antialiased when shrinking, weights
    renormalized at the border). ``align_corners=True`` takes torch's
    corner-aligned resize of the mode instead."""
    channels_last = data_format in ("NHWC", "NDHWC", "NWC")
    if channels_last:
        x = torch.movedim(x, -1, 1)
    spatial = tuple(x.shape[2:])
    if size is None:
        sf = (tuple(scale_factor) if isinstance(scale_factor, (list, tuple))
              else (scale_factor,) * len(spatial))
        size = tuple(int(n * f) for n, f in zip(spatial, sf))
    size = tuple(int(v) for v in size)
    if mode == "nearest":
        y = _F.interpolate(x, size=size, mode="nearest-exact")
    elif align_corners:
        y = _F.interpolate(x, size=size, mode=mode, align_corners=True)
    else:
        kernel = _keys_cubic if mode == "bicubic" else _triangle
        y = x
        for k, (n_in, n_out) in enumerate(zip(spatial, size)):
            w = _resize_weights(n_in, n_out, kernel, x.device).to(x.dtype)
            y = torch.movedim(torch.movedim(y, 2 + k, -1) @ w, -1, 2 + k)
    return torch.movedim(y, 1, -1) if channels_last else y


@register_op("unfold")
def unfold(x, *, kernel_sizes, strides=1, paddings=0, dilations=1):
    return _F.unfold(x, _pair(kernel_sizes), _pair(dilations), _pair(paddings), _pair(strides))


@register_op("fold")
def fold(x, *, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1):
    return _F.fold(x, _pair(output_sizes), _pair(kernel_sizes), _pair(dilations),
                   _pair(paddings), _pair(strides))


@register_op("spectral_norm")
def spectral_norm(w, u, v, *, dim=0, power_iters=1, eps=1e-12):
    """``w`` divided by its largest singular value, estimated by
    ``power_iters`` rounds of power iteration from ``u`` and ``v``
    (``nn_extra.py`` ``spectral_norm``)."""
    mat = w.movedim(dim, 0).reshape(w.shape[dim], -1)
    for _ in range(power_iters):
        v = mat.t() @ u
        v = v / (v.norm() + eps)
        u = mat @ v
        u = u / (u.norm() + eps)
    sigma = u @ mat @ v
    return w / sigma


# -- losses (kernels.py:1095-1225) ---------------------------------------------


def _reduce_loss(loss, reduction):
    if reduction == "none":
        return loss
    if reduction == "sum":
        return torch.sum(loss)
    return torch.mean(loss)


@register_op("cross_entropy")
def cross_entropy(logits, label, *, soft_label=False, axis=-1, ignore_index=-100,
                  reduction="mean", use_softmax=True, weight=None):
    """Hard labels with the default options go through
    :func:`paddle_tpu_torch.nn.functional._cross_entropy` (the AMP seam);
    the rest follow kernels.py:1096-1127."""
    from ..nn import functional as F

    if use_softmax and not soft_label and weight is None:
        return F._cross_entropy(logits, label, ignore_index, reduction, axis)
    logp = torch.log_softmax(logits, dim=axis) if use_softmax else torch.log(
        torch.clamp(logits, min=1e-12))
    if soft_label:
        loss = -torch.sum(label * logp, dim=axis)
        valid = torch.ones_like(loss, dtype=torch.bool)
        denom = None
    else:
        lbl = label.squeeze(axis) if label.dim() == logits.dim() else label
        picked = torch.gather(logp, axis, lbl.clamp_min(0).unsqueeze(axis).to(torch.int64))
        loss = -picked.squeeze(axis)
        valid = lbl != ignore_index
        loss = torch.where(valid, loss, torch.zeros_like(loss))
        denom = None
        if weight is not None:
            weight = torch.as_tensor(weight, device=logits.device, dtype=loss.dtype)
            wsel = torch.where(valid, weight[lbl.clamp_min(0).to(torch.int64)],
                               torch.zeros_like(loss))
            loss = loss * wsel
            denom = torch.clamp(wsel.sum(), min=1e-12)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if denom is None:
        denom = torch.clamp(valid.to(loss.dtype).sum(), min=1.0)
    return loss.sum() / denom


@register_op("mse_loss")
def mse_loss(x, y, *, reduction="mean"):
    return _reduce_loss(torch.square(x - y), reduction)


@register_op("l1_loss")
def l1_loss(x, y, *, reduction="mean"):
    return _reduce_loss(torch.abs(x - y), reduction)


@register_op("smooth_l1_loss")
def smooth_l1_loss(x, y, *, reduction="mean", delta=1.0):
    d = torch.abs(x - y)
    return _reduce_loss(torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta), reduction)


@register_op("bce_loss")
def bce_loss(x, label, *, reduction="mean"):
    eps = 1e-12
    loss = -(label * torch.log(torch.clamp(x, min=eps))
             + (1 - label) * torch.log(torch.clamp(1 - x, min=eps)))
    return _reduce_loss(loss, reduction)


@register_op("bce_with_logits")
def bce_with_logits(logits, label, *, reduction="mean", pos_weight=None):
    max_val = torch.clamp(-logits, min=0)
    lse = torch.log(torch.exp(-max_val) + torch.exp(-logits - max_val)) + max_val
    if pos_weight is not None:
        pos_weight = torch.as_tensor(pos_weight, device=logits.device, dtype=logits.dtype)
        loss = (1 - label) * logits + ((pos_weight - 1) * label + 1) * lse
    else:
        loss = (1 - label) * logits + lse
    return _reduce_loss(loss, reduction)


@register_op("nll_loss")
def nll_loss(logp, label, *, reduction="mean", ignore_index=-100):
    picked = torch.gather(logp, 1, label.clamp_min(0).unsqueeze(1).to(torch.int64))
    loss = -picked.squeeze(1)
    valid = label != ignore_index
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / torch.clamp(valid.to(loss.dtype).sum(), min=1.0)


@register_op("kl_div")
def kl_div(x, target, *, reduction="mean"):
    loss = target * (torch.log(torch.clamp(target, min=1e-12)) - x)
    if reduction == "batchmean":
        return loss.sum() / x.shape[0]
    return _reduce_loss(loss, reduction)


@register_op("log_loss")
def log_loss(pred, label, *, epsilon=1e-4):
    return -label * torch.log(pred + epsilon) - (1 - label) * torch.log(1 - pred + epsilon)


@register_op("square_error_cost")
def square_error_cost(x, y, **kw):
    return torch.square(x - y)


@register_op("margin_ranking_loss")
def margin_ranking_loss(x, y, label, *, margin=0.0, reduction="mean"):
    return _reduce_loss(torch.clamp(-label * (x - y) + margin, min=0), reduction)


@register_op("cosine_similarity")
def cosine_similarity(x, y, *, axis=1, eps=1e-8):
    num = torch.sum(x * y, dim=axis)
    return num / torch.clamp(x.norm(dim=axis) * y.norm(dim=axis), min=eps)


# -- random ops (kernels.py:1282-1306), drawn as ``kernels.py``'s are ----------


def _draw(device, generator, fn):
    if device is not None and device.type == "meta":
        return fn(None)
    return _random.draw(device, generator, fn)


def _device_of(generator):
    return None if generator is None else generator.device


@register_op("randint")
def randint(*, low, high, shape, dtype="int64", generator=None):
    dev = _device_of(generator)
    return _draw(dev, generator, lambda gen: torch.randint(
        low, high, tuple(shape), dtype=torch_dtype(dtype), device=dev, generator=gen))


@register_op("randperm")
def randperm(*, n, dtype="int64", generator=None):
    dev = _device_of(generator)
    return _draw(dev, generator, lambda gen: torch.randperm(
        n, dtype=torch_dtype(dtype), device=dev, generator=gen))


@register_op("bernoulli")
def bernoulli(x, *, generator=None):
    return _draw(x.device, generator, lambda gen: torch.bernoulli(x, generator=gen))


@register_op("multinomial")
def multinomial(x, *, num_samples=1, replacement=False, generator=None):
    return _draw(x.device, generator, lambda gen: torch.multinomial(
        x, num_samples, replacement, generator=gen))


@register_op("poisson")
def poisson(x, *, generator=None):
    return _draw(x.device, generator, lambda gen: torch.poisson(x, generator=gen))



# -- the rest of kernels.py: indexing, a full mean, hinge loss, loss scaling ------


@register_op("getitem")
def getitem(x, *, idx):
    return x[idx]


@register_op("mean_all")
def mean_all(x, **kw):
    """``operators/mean_op.cc``: the mean of every element, a scalar."""
    return torch.mean(x)


@register_op("hinge_loss")
def hinge_loss(logits, label, **kw):
    return torch.clamp(1 - logits * (2 * label - 1), min=0)


@register_op("depthwise_conv2d")
def depthwise_conv2d(x, w, *, stride=1, padding=0, dilation=1, groups=None,
                     data_format="NCHW"):
    """``conv2d`` with one group a channel."""
    from .registry import kernel

    c = x.shape[1] if data_format == "NCHW" else x.shape[-1]
    return kernel("conv2d")(x, w, stride=stride, padding=padding, dilation=dilation, groups=c,
                            data_format=data_format)


@register_op("check_finite_and_unscale", num_outputs=-1)
def check_finite_and_unscale(*xs, scale):
    """Each of ``xs`` divided by ``scale``, then whether any held a NaN or
    an inf (AMP's loss-scaling check, on the device)."""
    found_inf = torch.zeros((), dtype=torch.bool, device=scale.device
                            if isinstance(scale, torch.Tensor) else None)
    outs = []
    for x in xs:
        found_inf = found_inf | ~torch.isfinite(x).all()
        outs.append(x / scale)
    return tuple(outs) + (found_inf,)


@register_op("update_loss_scaling", num_outputs=3)
def update_loss_scaling(scale, good_steps, found_inf, *, incr_every_n_steps=2000,
                        decr_every_n_nan_or_inf=1, incr_ratio=2.0, decr_ratio=0.5):
    """The dynamic loss scale's update: halved (not below 1) on an inf,
    grown after ``incr_every_n_steps`` good steps."""
    new_good = torch.where(found_inf, torch.zeros_like(good_steps), good_steps + 1)
    should_incr = new_good >= incr_every_n_steps
    new_scale = torch.where(found_inf, torch.clamp(scale * decr_ratio, min=1.0),
                            torch.where(should_incr, scale * incr_ratio, scale))
    new_good = torch.where(should_incr, torch.zeros_like(new_good), new_good)
    return new_scale, new_good, found_inf
