"""The eager ``Tensor`` (``paddle_tpu/framework/tensor.py``).

``Tensor`` is a ``torch.Tensor`` subclass, made without a copy
(``torch.Tensor._make_subclass`` for a leaf, ``as_subclass`` for an op's
result), so every port internal takes it as it is: kernels read its
``data_ptr``, CUDA graphs copy into it. It adds Paddle's members on top:
``stop_gradient`` (``not requires_grad``), ``place``, ``name``,
``persistable``, ``astype``/``cast``, ``numpy()`` (which detaches first),
``set_value``, ``clear_grad``, and the methods and operators of the JAX
``Tensor``, each through the mode-aware ops front (:mod:`paddle_tpu_torch.ops`),
so their results are ``Tensor``\\ s too.

Torch's own Python code reads ``.shape``, ``.dtype`` and calls methods on
whatever tensor it is given, so Paddle's meaning replaces torch's only
where the two call forms can be told apart:

- ``shape`` stays a ``torch.Size`` (equal to a tuple, not to a list) and
  ``dtype`` a ``torch.dtype`` (``paddle_tpu_torch.float32`` is
  ``torch.float32``);
- ``transpose(perm)`` with one list is Paddle's, ``transpose(a, b)``
  torch's; ``size`` is an int (the element count) that is also callable as
  torch's ``size()``;
- ``sum``/``mean``/``max``/``min``/``prod``/``argmax``/``squeeze``/
  ``unsqueeze``/``flatten``/``norm`` take Paddle's ``axis`` and torch's
  ``dim``; ``max``/``min`` return the values only (Paddle's), never
  torch's ``(values, indices)``.

``__torch_function__`` is off (as on ``torch.nn.Parameter``): a torch
function given a ``Tensor`` returns a plain ``torch.Tensor`` and costs
nothing extra; the ops front wraps what it returns.

Inside a compiled step (a captured graph, ``runtime/compiled.py``) a
read of the values on the host (``bool``, ``item``, ``numpy``, ``float``,
``int``, ``tolist``) raises, as a Python ``bool`` of a tracer raises in
the JAX package's compiled functions.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from .dtype import convert_dtype, get_default_dtype, torch_dtype
from .place import Place, place_of, to_torch_device

__all__ = ["Tensor", "Parameter", "to_tensor", "to_tensor_like", "wrap"]

_names = itertools.count(1)


def _ops():
    from .. import ops

    return ops


def _host_read(what):
    from ..runtime.compiled import in_compiled_step

    if in_compiled_step():
        raise RuntimeError(f"Tensor.{what} reads the values on the host inside a compiled "
                           "step (a captured graph): compute on tensors instead")


class _Size(int):
    """``Tensor.size``: the element count (Paddle's property), callable as
    torch's ``size(dim=None)``."""

    def __call__(self, dim=None):
        t = self.__dict__["tensor"]
        return torch.Tensor.size(t) if dim is None else torch.Tensor.size(t, dim)


def _axis(axis, dim):
    return dim if axis is None else axis


class Tensor(torch.Tensor):
    __torch_function__ = torch._C._disabled_torch_function_impl
    persistable = False

    def __new__(cls, data=None, dtype=None, place=None, stop_gradient=True):
        t = _to_torch(data, dtype, place) if data is not None else torch.zeros(
            (), dtype=convert_dtype(dtype), device=to_torch_device(place))
        return torch.Tensor._make_subclass(cls, t, not stop_gradient)

    def __init__(self, *args, **kwargs):
        pass

    # -- Paddle attributes --------------------------------------------------
    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        self.requires_grad_(not value)

    @property
    def name(self) -> str:
        n = self.__dict__.get("_name")
        if n is None:
            n = self.__dict__["_name"] = f"generated_tensor_{next(_names)}"
        return n

    @name.setter
    def name(self, value):
        self.__dict__["_name"] = value

    @property
    def place(self) -> Place:
        return place_of(self.device)

    @property
    def size(self):
        s = _Size(self.numel())
        s.__dict__["tensor"] = self
        return s

    @property
    def T(self):
        return _ops().transpose(self, list(range(self.dim()))[::-1])

    # -- host reads ---------------------------------------------------------
    def numpy(self, force=False):
        _host_read("numpy")
        t = torch.Tensor.detach(self)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def item(self):
        _host_read("item")
        return torch.Tensor.item(torch.Tensor.detach(self))

    def tolist(self):
        _host_read("tolist")
        return torch.Tensor.tolist(torch.Tensor.detach(self))

    def __bool__(self):
        _host_read("__bool__")
        return torch.Tensor.__bool__(self)

    def __float__(self):
        _host_read("__float__")
        return torch.Tensor.__float__(torch.Tensor.detach(self))

    def __int__(self):
        _host_read("__int__")
        return torch.Tensor.__int__(torch.Tensor.detach(self))

    # -- conversions ----------------------------------------------------------
    def astype(self, dtype):
        return _ops().cast(self, dtype)

    cast = astype

    def detach(self):
        return wrap(torch.Tensor.detach(self))

    def clone(self, *args, **kwargs):
        return wrap(torch.Tensor.clone(self, *args, **kwargs))

    def to(self, *args, **kwargs):
        if args and isinstance(args[0], Place) or (
                args and isinstance(args[0], str) and args[0].split(":")[0] in ("gpu", "tpu")):
            args = (to_torch_device(args[0]),) + args[1:]
        return wrap(torch.Tensor.to(self, *args, **kwargs))

    def cpu(self, *args, **kwargs):
        return wrap(torch.Tensor.cpu(self, *args, **kwargs))

    def __getitem__(self, idx):
        return wrap(torch.Tensor.__getitem__(self, idx))

    # -- gradients ------------------------------------------------------------
    def clear_grad(self):
        self.grad = None

    clear_gradient = clear_grad

    def set_value(self, value):
        """Replace the values in place (the optimizers', ``set_state_dict``'s
        write): same shape; cast to this tensor's dtype and device."""
        src = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
        if tuple(src.shape) != tuple(self.shape):
            raise ValueError(f"set_value shape mismatch: {tuple(src.shape)} vs "
                             f"{tuple(self.shape)}")
        with torch.no_grad():
            torch.Tensor.copy_(self, src.to(self.dtype))
        return self

    # -- operators (the JAX Tensor's, through the ops front) ----------------
    def __add__(self, o):
        return _ops().add(self, o)

    __radd__ = __add__

    def __sub__(self, o):
        return _ops().subtract(self, o)

    def __rsub__(self, o):
        return _ops().subtract(to_tensor_like(o, self), self)

    def __mul__(self, o):
        return _ops().multiply(self, o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return _ops().divide(self, o)

    def __rtruediv__(self, o):
        return _ops().divide(to_tensor_like(o, self), self)

    def __pow__(self, o):
        return _ops().pow(self, o)

    def __rpow__(self, o):
        return _ops().elementwise_pow(to_tensor_like(o, self), self)

    def __mod__(self, o):
        return _ops().remainder(self, o)

    def __floordiv__(self, o):
        return _ops().floor_divide(self, o)

    def __matmul__(self, o):
        return _ops().matmul(self, o)

    def __neg__(self):
        return _ops().neg(self)

    def __abs__(self):
        return _ops().abs(self)

    def __eq__(self, o):
        return _ops().equal(self, o)

    def __ne__(self, o):
        return _ops().not_equal(self, o)

    def __lt__(self, o):
        return _ops().less_than(self, o)

    def __le__(self, o):
        return _ops().less_equal(self, o)

    def __gt__(self, o):
        return _ops().greater_than(self, o)

    def __ge__(self, o):
        return _ops().greater_equal(self, o)

    __hash__ = torch.Tensor.__hash__

    # -- methods with Paddle's argument names (torch's ``dim`` accepted) ------
    def sum(self, axis=None, keepdim=False, dtype=None, *, dim=None):
        return _ops().sum(self, axis=_axis(axis, dim), dtype=dtype, keepdim=keepdim)

    def mean(self, axis=None, keepdim=False, *, dim=None, dtype=None):
        x = self if dtype is None else self.astype(dtype)
        return _ops().mean(x, axis=_axis(axis, dim), keepdim=keepdim)

    def max(self, axis=None, keepdim=False, *, dim=None):
        return _ops().max(self, axis=_axis(axis, dim), keepdim=keepdim)

    def min(self, axis=None, keepdim=False, *, dim=None):
        return _ops().min(self, axis=_axis(axis, dim), keepdim=keepdim)

    def prod(self, axis=None, keepdim=False, dtype=None, *, dim=None):
        x = self if dtype is None else self.astype(dtype)
        return _ops().prod(x, axis=_axis(axis, dim), keepdim=keepdim)

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple, torch.Size)):
            shape = shape[0]
        return _ops().reshape(self, list(shape))

    def transpose(self, *args, **kwargs):
        if len(args) == 1 and not kwargs and isinstance(args[0], (list, tuple)):
            return _ops().transpose(self, args[0])
        if "perm" in kwargs:
            return _ops().transpose(self, kwargs["perm"])
        return wrap(torch.Tensor.transpose(self, *args, **kwargs))

    def flatten(self, start_axis=0, stop_axis=-1, *, start_dim=None, end_dim=None):
        return _ops().flatten(self, start_axis if start_dim is None else start_dim,
                              stop_axis if end_dim is None else end_dim)

    def squeeze(self, axis=None, *, dim=None):
        return _ops().squeeze(self, _axis(axis, dim))

    def unsqueeze(self, axis=None, *, dim=None):
        return _ops().unsqueeze(self, _axis(axis, dim))

    def argmax(self, axis=None, keepdim=False, *, dim=None):
        return _ops().argmax(self, axis=_axis(axis, dim), keepdim=keepdim)

    def matmul(self, o, transpose_x=False, transpose_y=False):
        return _ops().matmul(self, o, transpose_x, transpose_y)

    def exp(self):
        return _ops().exp(self)

    def log(self):
        return _ops().log(self)

    def sqrt(self):
        return _ops().sqrt(self)

    def tanh(self):
        return _ops().tanh(self)

    def abs(self):
        return _ops().abs(self)

    def clip(self, min=None, max=None):
        return _ops().clip(self, min, max)

    def pow(self, y):
        return self.__pow__(y)

    def norm(self, p=2, axis=None, keepdim=False, *, dim=None):
        return _ops().p_norm(self, 2 if p == "fro" else p, _axis(axis, dim), keepdim)


def _beside(name):
    """A parameter's binary operator: the Tensor's when the other operand is
    a Tensor activation, else torch's."""
    as_tensor, as_torch = getattr(Tensor, name), getattr(torch.Tensor, name)

    def op(self, other):
        if isinstance(other, Tensor) and not isinstance(other, Parameter):
            return as_tensor(self, other)
        return as_torch(self, other)

    op.__name__ = name
    return op


class Parameter(Tensor, torch.nn.Parameter):
    """A trainable tensor: a :class:`Tensor` that is also a
    ``torch.nn.Parameter``, so a ``torch.nn.Module`` registers it and the
    port's optimizers take it as they are. ``trainable=False`` is
    ``stop_gradient``. It keeps Paddle's attributes (``name``,
    ``stop_gradient``, ``numpy()``, ``set_value``, ``astype``) while its
    operators and the methods whose names torch shares are torch's: a
    model's forward over plain tensors computes exactly as before."""

    persistable = True

    def __new__(cls, data, name=None, trainable=True):
        t = data.detach() if isinstance(data, torch.Tensor) else _to_torch(data, None, None)
        p = torch.Tensor._make_subclass(cls, t, bool(trainable))
        if name:
            p.name = name
        return p

    def __init__(self, data, name=None, trainable=True):
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.requires_grad_(bool(value))

    # a parameter computes as torch's beside plain tensors (an op of a
    # model's plain activations and its parameters stays plain and outside
    # the ops front, whichever side the parameter is on) and as a Tensor
    # beside a Tensor activation
    for _name in ("__neg__", "__abs__", "__getitem__", "sum", "mean", "max", "min", "prod",
                  "reshape", "transpose", "flatten", "squeeze", "unsqueeze", "argmax",
                  "matmul", "exp", "log", "sqrt", "tanh", "abs", "clip", "pow", "norm",
                  "detach", "clone", "to", "cpu", "T"):
        locals()[_name] = getattr(torch.Tensor, _name)
    for _name in ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__",
                  "__truediv__", "__rtruediv__", "__pow__", "__rpow__", "__mod__",
                  "__floordiv__", "__matmul__", "__eq__", "__ne__", "__lt__", "__le__",
                  "__gt__", "__ge__"):
        locals()[_name] = _beside(_name)
    del _name
    __hash__ = torch.Tensor.__hash__

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        p = type(self)(torch.Tensor.clone(self.data, memory_format=torch.preserve_format),
                       trainable=self.requires_grad)
        p.__dict__.update({k: v for k, v in self.__dict__.items() if k != "_name"})
        memo[id(self)] = p
        return p

    def __repr__(self):
        return "Parameter containing:\n" + torch.Tensor.__repr__(self)


def wrap(out):
    """``out`` (a tensor, or a tuple or list of them) with every plain
    ``torch.Tensor`` made a :class:`Tensor`, without a copy."""
    if isinstance(out, torch.Tensor):
        return out if isinstance(out, Tensor) else out.as_subclass(Tensor)
    if isinstance(out, tuple):
        return tuple(wrap(o) for o in out)
    if isinstance(out, list):
        return [wrap(o) for o in out]
    return out


def _to_torch(data, dtype, place) -> torch.Tensor:
    """``data`` as a plain tensor on ``place`` (the default place when
    None): a float64 array or list without a ``dtype`` becomes the default
    float dtype (float32), as in Paddle; a tensor keeps its dtype."""
    device = to_torch_device(place) if not (place is None and isinstance(data, torch.Tensor)) \
        else data.device
    if isinstance(data, torch.Tensor):
        t = torch.Tensor.detach(data)
    else:
        arr = np.asarray(data)
        if dtype is None and arr.dtype == np.float64:
            arr = arr.astype(get_default_dtype())
        if arr.dtype == np.uint16 or arr.dtype.kind not in "biufc":
            raise TypeError(f"to_tensor: unsupported data of dtype {arr.dtype}")
        t = torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy())
    t = t.to(device)
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    return t


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """A new :class:`Tensor` of ``data`` (a list, a number, a numpy array or
    a tensor) on ``place``: the :func:`~paddle_tpu_torch.framework.place.set_device`
    choice, else the card; with neither it raises."""
    if place is None and isinstance(data, torch.Tensor):
        place = to_torch_device(None)
    return Tensor(data, dtype=dtype, place=place, stop_gradient=stop_gradient)


def to_tensor_like(value, ref):
    """A Python number or array as a tensor beside ``ref``: a number takes
    ``ref``'s dtype when ``ref`` is floating (Paddle's scalar rule), a
    float otherwise float32. A number becomes a 0-d CPU tensor, which torch
    combines with a tensor on any device."""
    if isinstance(value, torch.Tensor):
        return value
    if isinstance(value, (bool, int, float)):
        if ref.dtype.is_floating_point:
            return torch.tensor(value, dtype=ref.dtype)
        return torch.tensor(value, dtype=torch.float32 if isinstance(value, float) else None)
    arr = np.asarray(value)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy()).to(ref.device)
