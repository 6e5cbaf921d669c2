"""Fused momentum / L2-decay update in place: the CUDA kernel and its plain version.

Replaces ``paddle_tpu/ops/pallas/optimizer_update.py`` ``_pallas_update``:
one pass over param, grad and velocity computes ::

    g' = grad + wd * param          (when wd != 0)
    v' = mu * velocity + g'
    p' = param - lr * (g' + mu * v')   (Nesterov)
       | param - lr * v'               (plain)

and writes ``p'`` and ``v'`` over ``param`` and ``velocity``
(``csrc/optimizer_update.cu``). Memory bound: five float32 streams for a
few flops an element. Every operation rounds on its own, in the order of
:func:`_plain_update` (the JAX package's ``_jnp_update``), so the kernel
equals the plain version bit for bit. Every parameter takes the kernel,
whatever its size: the TPU's ``size >= 128`` rule (``:131-135``) was its
tiling's.

The kernel updates many tensors in one launch: the JAX package's
``pallas_call``s sit inside one compiled train step, where a launch from
Python per parameter would leave the card idle between them.
:func:`fused_momentum_update_multi` groups the tensors into launches of
at most :data:`MAX_TENSORS` (:func:`launch_groups`) and passes each
group's pointers and block prefix sums by value; :data:`LAUNCHES` counts
launches and :data:`TENSORS` the tensors they updated.

``lr`` reaches the kernel as a pointer to one float32 in device memory:
the train step's lr tensor, which it writes before each step, so a launch
captured in a CUDA graph reads each replay's lr where a value passed by
value would stay the one of the capture. A Python ``lr`` is written to a
new 0-dim tensor on the card first, which a capture refuses.

Tensors on the CPU take :func:`_plain_update` (written in place the same
way); tensors on the card launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from ._tally import bump, check_outputs, counted

__all__ = ["fused_momentum_update", "fused_momentum_update_multi", "launch_groups",
           "MAX_TENSORS", "CHUNK", "LAUNCHES", "TENSORS"]

#: tensors one launch updates at most, and elements a block owns: the
#: kernel's ``kMaxTensors`` and ``kChunk`` (checked against the library)
MAX_TENSORS = 110
CHUNK = 8192

#: kernel launches, and tensors they updated, since the last reset
#: (counted where the kernel launches)
LAUNCHES = 0
TENSORS = 0
_count_lock = threading.Lock()

_ARGS = [ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_void_p, ctypes.c_float,
         ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _plain_update(param, grad, velocity, lr, mu, wd, nesterov):
    """``(new_param, new_velocity)``: the update's expression, op by op
    (``_jnp_update``), with its scalars rounded where the JAX package's
    train step rounds them: ``mu`` and ``wd`` are weak Python scalars there,
    taken in the parameter's type, while ``lr`` is a float32 array, so the
    last product and difference are float32, rounded once to the
    parameter's type. For float32 parameters all of this is float32 (the
    kernel's arithmetic, bit for bit); for bf16 (O2) it is ``_jnp_update``'s
    rounding (a Python ``mu`` in torch would multiply in float32)."""
    dt = param.dtype
    mu_t, wd_t = (torch.tensor(c, dtype=dt) for c in (mu, wd))
    g = grad + wd_t * param if wd else grad
    v = mu_t * velocity + g
    step = g + mu_t * v if nesterov else v
    lr_t = lr.float() if isinstance(lr, torch.Tensor) else torch.tensor(lr, dtype=torch.float32)
    return (param.float() - lr_t * step.float()).to(dt), v


def launch_groups(numels, max_tensors=MAX_TENSORS, chunk=CHUNK):
    """The launches for tensors of ``numels`` elements (each > 0), in order:
    a list of ``(indices, block_starts)``, each group at most
    ``max_tensors`` long, ``block_starts`` the prefix sums of
    ``ceil(numel / chunk)`` over the group, from 0."""
    groups, idx, starts = [], [], [0]
    for i, n in enumerate(numels):
        if n <= 0:
            raise ValueError(f"launch_groups: tensor {i} has {n} elements")
        blocks = -(-int(n) // chunk)
        if idx and (len(idx) == max_tensors or starts[-1] + blocks > 2**31 - 1):
            groups.append((idx, starts))
            idx, starts = [], [0]
        idx.append(i)
        starts.append(starts[-1] + blocks)
    if idx:
        groups.append((idx, starts))
    return groups


def _entry():
    lib = _build.library("optimizer_update")
    fn = lib.ptt_momentum_update_multi
    if fn.argtypes is None:
        if (lib.ptt_momentum_max_tensors(), lib.ptt_momentum_chunk()) != (MAX_TENSORS, CHUNK):
            raise RuntimeError("optimizer_update: MAX_TENSORS / CHUNK differ from the kernel's")
        fn.argtypes = _ARGS
        fn.restype = ctypes.c_int
    return fn


def _update_cost(params, grads, velocities, lr, momentum=0.9, weight_decay=0.0,
                 use_nesterov=False):
    """Row 14's work: each param, grad and velocity read, each param and
    velocity written (``20·P`` bytes in f32); no products."""
    return 0, sum(t.numel() * t.element_size() * n
                  for ts, n in ((params, 2), (grads, 1), (velocities, 2)) for t in ts)


@counted(_update_cost)
@torch.no_grad()
def fused_momentum_update_multi(params, grads, velocities, lr, momentum=0.9, weight_decay=0.0,
                                use_nesterov=False):
    """One momentum (+ L2 decay) step of every tensor of ``params``, written
    over it and its velocity. ``lr`` is a Python number or a 0-dim float32
    tensor on the tensors' device (the train step's). On the card: one
    launch a group of :func:`launch_groups`; empty tensors are skipped."""
    params, grads, velocities = list(params), list(grads), list(velocities)
    if not len(params) == len(grads) == len(velocities):
        raise ValueError(f"fused_momentum_update_multi: {len(params)} params, {len(grads)} "
                         f"grads and {len(velocities)} velocities")
    mu, wd = float(momentum), float(weight_decay)
    if not isinstance(lr, torch.Tensor):
        lr = float(lr)
    for p, g, v in zip(params, grads, velocities):
        if not (p.shape == g.shape == v.shape):
            raise ValueError(f"fused_momentum_update: param {tuple(p.shape)}, grad "
                             f"{tuple(g.shape)} and velocity {tuple(v.shape)} differ")
    tensors = params + grads + velocities
    if all(t.device.type == "cpu" for t in tensors):
        for p, g, v in zip(params, grads, velocities):
            new_p, new_v = _plain_update(p, g, v, lr, mu, wd, use_nesterov)
            p.copy_(new_p)
            v.copy_(new_v)
        return
    dev = params[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("fused_momentum_update: all tensors must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"fused_momentum_update: the kernel takes float32, got "
                        f"{sorted({str(t.dtype) for t in tensors})}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_momentum_update: param, grad and velocity must be contiguous")
    live = [i for i, p in enumerate(params) if p.numel() > 0]
    if not live:  # nothing is launched or counted
        return
    lr = _lr_on(dev, lr)
    groups = launch_groups([params[i].numel() for i in live])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        fn = _entry()
        for idx, starts in groups:
            sel = [live[j] for j in idx]
            words = ([params[i].data_ptr() for i in sel] + [grads[i].data_ptr() for i in sel]
                     + [velocities[i].data_ptr() for i in sel]
                     + [params[i].numel() for i in sel] + starts)
            table = (ctypes.c_int64 * len(words))(*words)
            err = fn(table, len(sel), lr.data_ptr(), mu, wd, int(bool(use_nesterov)), stream)
            _build.check(err, "fused_momentum_update")
            with _count_lock:
                bump(globals(), "LAUNCHES")
                bump(globals(), "TENSORS", len(sel))
            check_outputs(globals(), "LAUNCHES", *(params[i] for i in sel),
                          *(velocities[i] for i in sel))


def _lr_on(dev, lr):
    """``lr`` as the one float32 in ``dev``'s memory the kernel reads."""
    if isinstance(lr, torch.Tensor):
        if lr.device != dev or lr.dtype != torch.float32 or lr.numel() != 1:
            raise ValueError(f"fused_momentum_update: lr must be one float32 on {dev}, got "
                             f"{lr.dtype} {tuple(lr.shape)} on {lr.device}")
        return lr
    if torch.cuda.is_current_stream_capturing():
        raise ValueError("fused_momentum_update: a Python lr would stay the capture's in every "
                         "replay; pass the lr as a float32 tensor on the card")
    return torch.full((), lr, dtype=torch.float32, device=dev)


def fused_momentum_update(param, grad, velocity, lr, momentum=0.9, weight_decay=0.0,
                          use_nesterov=False):
    """One momentum (+ L2 decay) step of ``param``, written over ``param``
    and ``velocity``, which it returns: :func:`fused_momentum_update_multi`
    over a list of one."""
    fused_momentum_update_multi([param], [grad], [velocity], lr, momentum, weight_decay,
                                use_nesterov)
    return param, velocity
