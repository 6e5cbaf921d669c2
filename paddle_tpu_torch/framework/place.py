"""Device places (``paddle_tpu/framework/place.py``).

``CPUPlace`` and ``CUDAPlace`` name a ``torch.device``; ``TPUPlace``, the
name Paddle scripts written for the JAX package use for the accelerator,
is the card here (it resolves through
:func:`paddle_tpu_torch.device.resolve_device`). :func:`set_device` picks
the place that :func:`~paddle_tpu_torch.framework.tensor.to_tensor` and
new layers' parameters take by default; with no call the default is the
card, and with no card :func:`default_device` raises rather than falling
back to the CPU (``set_device("cpu")`` asks for the CPU).
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["Place", "CPUPlace", "CUDAPlace", "TPUPlace", "set_device", "get_device",
           "is_compiled_with_tpu", "default_device", "place_of", "parameter_device",
           "building_on"]


class Place:
    """Base place. Equality is by (kind, device_id)."""

    kind = "undefined"

    def __init__(self, device_id: int = 0):
        self._device_id = int(device_id)

    def get_device_id(self) -> int:
        return self._device_id

    def __eq__(self, other):
        return (isinstance(other, Place) and self.kind == other.kind
                and self._device_id == other._device_id)

    def __hash__(self):
        return hash((self.kind, self._device_id))

    def __repr__(self):
        return f"Place({self.kind}:{self._device_id})"

    def torch_device(self) -> torch.device:
        if self.kind == "cpu":
            return torch.device("cpu")
        from ..device import resolve_device

        resolve_device()  # raises without a card
        return torch.device("cuda", self._device_id)


class CPUPlace(Place):
    kind = "cpu"

    def __init__(self):
        super().__init__(0)


class CUDAPlace(Place):
    kind = "gpu"


class TPUPlace(CUDAPlace):
    """The accelerator place of scripts written for the JAX package: on this
    port it is the CUDA card of the same index, resolved through
    :func:`paddle_tpu_torch.device.resolve_device`."""


def is_compiled_with_tpu() -> bool:
    """Whether an accelerator (here a CUDA card) is visible."""
    return torch.cuda.is_available()


_expected_place: Place | None = None


def set_device(device: str | Place) -> Place:
    """``set_device("gpu")``, ``"gpu:1"``, ``"cuda:0"``, ``"tpu"`` (the card)
    or ``"cpu"``: the place later tensors and parameters take."""
    global _expected_place
    if isinstance(device, Place):
        _expected_place = device
        return device
    name, _, idx = str(device).partition(":")
    idx = int(idx) if idx else 0
    if name == "cpu":
        _expected_place = CPUPlace()
    elif name in ("gpu", "cuda", "tpu", "xpu"):
        _expected_place = CUDAPlace(idx)
    else:
        raise ValueError(f"unknown device {device!r}")
    return _expected_place


def _default_place() -> Place:
    place = _expected_place
    if place is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: call paddle_tpu_torch.set_device('cpu') to run "
                               "on the CPU")
        place = CUDAPlace(torch.cuda.current_device())
    if place.kind != "cpu" and not _precision_set:
        _set_precision()
    return place


_precision_set = False


def _set_precision():
    """Tensors on the card compute float32 in float32, as every entry point
    of the port does (``framework/jit.py``): no TF32 in matrix products or
    convolutions."""
    global _precision_set
    from .jit import _set_precision as set_f32

    set_f32()
    _precision_set = True


def get_device() -> str:
    """``"cpu"`` or ``"gpu:<index>"``: the default place."""
    p = _default_place()
    return "cpu" if p.kind == "cpu" else f"gpu:{p.get_device_id()}"


def default_device() -> torch.device:
    """The default place as a ``torch.device``: the :func:`set_device`
    choice, else the card; raises with neither."""
    return _default_place().torch_device()


def place_of(device) -> Place:
    """The :class:`Place` of a ``torch.device``."""
    device = torch.device(device)
    return CPUPlace() if device.type == "cpu" else CUDAPlace(device.index or 0)


def to_torch_device(place) -> torch.device:
    """A place given as a :class:`Place`, a ``torch.device`` or a name
    (``"cpu"``, ``"gpu:0"``) as a ``torch.device``; None is the default."""
    if place is None:
        return default_device()
    if isinstance(place, Place):
        return place.torch_device()
    if isinstance(place, str):
        name, _, idx = place.partition(":")
        if name in ("gpu", "tpu", "xpu"):
            return CUDAPlace(int(idx) if idx else 0).torch_device()
    return torch.device(place)


_building = threading.local()


@contextlib.contextmanager
def building_on(device):
    """Inside the block, layers made without a ``device`` or ``generator``
    of their own make their parameters on ``device``: a layer built with
    one (``ResNet(generator=g)``) places its batch norms beside its
    convolutions."""
    prev = getattr(_building, "device", None)
    _building.device = device
    try:
        yield
    finally:
        _building.device = prev


def parameter_device(device=None, generator=None) -> torch.device | None:
    """Where a layer makes a parameter: ``device`` when given; else the
    device of the ``generator`` that draws it; else that of the enclosing
    layer's (:func:`building_on`); else the :func:`set_device` choice or
    the card. With none of these (no card, no call) it is
    torch's default device: a layer can be built without a card, and only
    the entry points that run it (``to_tensor``, the executor, the
    predictors) refuse to run without one."""
    if device is not None:
        return to_torch_device(device)
    if generator is not None:
        return generator.device
    enclosing = getattr(_building, "device", None)
    if enclosing is not None:
        return enclosing
    if _expected_place is not None:
        return _expected_place.torch_device()
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return None
