"""``Layer``: Paddle's layer base on ``torch.nn.Module`` (``paddle_tpu/nn/layer_base.py``).

A ``Layer`` is a ``torch.nn.Module``, so the port's optimizers, compiled
steps and predictors take it as they are, with Paddle's methods on top:
``create_parameter`` (an initializer or a ``ParamAttr``-like ``attr``,
the parameter made where :func:`~paddle_tpu_torch.framework.place.parameter_device`
says), ``add_parameter``, ``add_sublayer``, ``sublayers``,
``named_sublayers``, ``parameters``/``named_parameters`` with
``include_sublayers``, ``register_buffer(persistable=)``,
``state_dict``/``set_state_dict`` under the JAX package's key names
(``layer1.0.bn1._mean``), ``register_forward_pre_hook``/
``register_forward_post_hook``, ``clear_gradients``, ``full_name`` and
``to(place)``.

Torch's meaning stays where the call forms agree: ``parameters()`` is
Paddle's list (torch's generator is iterated the same way), and
``state_dict()`` holds detached values (torch's), which ``set_state_dict``
and ``paddle_tpu_torch.save`` read alike.
"""
from __future__ import annotations

import functools
import inspect
import itertools
from collections import defaultdict

import numpy as np
import torch

from ..framework.dtype import get_default_dtype, torch_dtype
from ..framework.place import Place, building_on, parameter_device, to_torch_device
from ..framework.tensor import Parameter
from . import initializer as I

__all__ = ["Layer", "ParamAttr"]

_name_counts = defaultdict(itertools.count)


def _torch_generator(device):
    """Torch's own default generator of ``device`` (which ``torch.manual_seed``
    and ``paddle_tpu_torch.seed`` seed): what a layer draws from without a
    generator of its own; None on ``meta``."""
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda":
        return torch.cuda.default_generators[
            device.index if device.index is not None else torch.cuda.current_device()]
    return torch.default_generator if device.type == "cpu" else None


class ParamAttr:
    """A parameter's name, initializer and ``trainable`` flag (Paddle's
    ``ParamAttr``), as ``weight_attr``/``bias_attr`` take it."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0, regularizer=None,
                 trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


def _placing(init):
    """``init`` (a layer's constructor that takes ``generator`` or
    ``device``) run inside :func:`~paddle_tpu_torch.framework.place.building_on`
    the device those name, so the sublayers it makes without either (batch
    norms, layer norms) take the same device."""
    sig = inspect.signature(init)

    @functools.wraps(init)
    def wrapped(self, *args, **kwargs):
        bound = sig.bind_partial(self, *args, **kwargs).arguments
        device, generator = bound.get("device"), bound.get("generator")
        if device is None and generator is None:
            return init(self, *args, **kwargs)
        with building_on(parameter_device(device, generator)):
            return init(self, *args, **kwargs)

    return wrapped


class Layer(torch.nn.Module):
    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        init = cls.__dict__.get("__init__")
        if init is not None and {"generator", "device"} & set(inspect.signature(init).parameters):
            cls.__init__ = _placing(init)

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtype
        prefix = name_scope or type(self).__name__.lower()
        self._full_name = f"{prefix}_{next(_name_counts[prefix])}"

    # -- parameters -------------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, generator=None, device=None):
        """A :class:`~paddle_tpu_torch.framework.tensor.Parameter` of
        ``shape`` drawn by ``attr`` (an initializer, a :class:`ParamAttr`)
        or else ``default_initializer`` (else Xavier, zeros for a bias),
        from ``generator`` (by default torch's own of its device)."""
        init, name, trainable = default_initializer, None, True
        if isinstance(attr, I.Initializer):
            init = attr
        elif attr is not None and attr is not False:
            init = getattr(attr, "initializer", None) or init
            name = getattr(attr, "name", None)
            trainable = getattr(attr, "trainable", True)
        init = I._resolve(init, is_bias=is_bias)
        dev = parameter_device(device, generator)
        if generator is None:
            generator = _torch_generator(dev)
        data = init(list(shape), dtype or self._dtype or get_default_dtype(),
                    generator=generator, device=dev)
        p = Parameter(data, name=name, trainable=trainable)
        if attr is not None and attr is not False and not isinstance(attr, I.Initializer):
            p.regularizer = getattr(attr, "regularizer", None)
            p.need_clip = getattr(attr, "need_clip", True)
            p.optimize_attr = {"learning_rate": getattr(attr, "learning_rate", 1.0)}
        return p

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True, persistent=None):
        if persistent is not None:
            persistable = persistent
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = torch.as_tensor(np.asarray(tensor))
        super().register_buffer(name, tensor, persistent=persistable)
        return tensor

    def parameters(self, include_sublayers=True, recurse=None):
        """Paddle's list of the parameters (each shared one once)."""
        return list(super().parameters(include_sublayers if recurse is None else recurse))

    def named_parameters(self, prefix="", include_sublayers=True, remove_duplicate=True,
                         recurse=None):
        return super().named_parameters(prefix, include_sublayers if recurse is None
                                        else recurse, remove_duplicate)

    def named_buffers(self, prefix="", include_sublayers=True, remove_duplicate=True,
                      recurse=None):
        return super().named_buffers(prefix, include_sublayers if recurse is None else recurse,
                                     remove_duplicate)

    def buffers(self, include_sublayers=True, recurse=None):
        return list(super().buffers(include_sublayers if recurse is None else recurse))

    # -- sublayers ----------------------------------------------------------
    def sublayers(self, include_self=False):
        return [m for m in self.modules() if include_self or m is not self]

    def named_sublayers(self, prefix="", include_self=False):
        for name, m in self.named_modules(prefix=prefix):
            if m is not self or include_self:
                yield name, m

    def full_name(self):
        return self._full_name

    # -- state --------------------------------------------------------------
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy each entry of ``state_dict`` (tensors or numpy arrays, under
        this layer's names) into its parameter or buffer in place, cast to
        its dtype and device. Returns ``(missing, unexpected)`` names."""
        own = dict(self.named_parameters())
        own.update(dict(self.named_buffers()))
        missing = [k for k in own if k not in state_dict]
        unexpected = [k for k in state_dict if k not in own]
        with torch.no_grad():
            for name, target in own.items():
                if name not in state_dict:
                    continue
                v = state_dict[name]
                v = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
                if tuple(v.shape) != tuple(target.shape):
                    raise ValueError(f"set_state_dict: {name} has shape {tuple(v.shape)}, the "
                                     f"layer's is {tuple(target.shape)}")
                torch.Tensor.copy_(target, v.detach().to(target.dtype))
        return missing, unexpected

    load_dict = set_state_dict

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    # -- hooks and placement ------------------------------------------------
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, output)``, its non-None result replacing
        the output."""
        return self.register_forward_hook(hook)

    def to(self, *args, **kwargs):
        """``to(place)`` with a place or a Paddle device name, or any of
        ``torch.nn.Module.to``'s forms."""
        if args and (isinstance(args[0], Place) or (
                isinstance(args[0], str) and args[0].split(":")[0] in ("gpu", "tpu"))):
            args = (to_torch_device(args[0]),) + args[1:]
        if "dtype" in kwargs and isinstance(kwargs["dtype"], str):
            kwargs["dtype"] = torch_dtype(kwargs["dtype"])
        return super().to(*args, **kwargs)
