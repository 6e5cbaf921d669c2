"""Static-graph optimizers (``paddle_tpu/static/optimizer.py:20-132``): SGD, Momentum and Adam.

``minimize(loss)`` appends the backward (:func:`~.backward.append_backward`),
the global-norm clip when ``grad_clip`` is given (as graph ops,
``_append_clip``), and one update op a parameter (``sgd``,
``momentum_update``, ``adam_update`` after an ``increment`` of
``adam_step``). The ops, their order, names and attributes are the JAX
package's. The lr is a persistable float32 scalar in the scope, an input of
every update op, so a schedule never means a new capture: :meth:`set_lr`
and :meth:`sync_lr` fill the scope's tensor in place (``fill_``), where the
JAX package calls ``global_scope().set``; in the port a ``Scope.set`` of a
name already there starts a new generation, and so a new capture.
Velocities and moments are parameters the startup program makes
(``<param>@velocity``, ``@moment1``, ``@moment2``), updated in place by the
executor as the parameters are.
"""
from __future__ import annotations

from .. import ops
from ..nn import initializer as I
from .backward import append_backward
from .executor import global_scope
from .nn import create_parameter
from .program import default_main_program

__all__ = ["SGD", "Momentum", "Adam"]


class StaticOptimizer:
    def __init__(self, learning_rate=0.001, grad_clip=None):
        self._lr = learning_rate
        self._grad_clip = grad_clip
        self._lr_name = None

    def _lr_var(self, prog):
        if self._lr_name is None:
            var = create_parameter([], "float32", name=prog._unique_name("learning_rate"),
                                   initializer=I.Constant(self._get_lr_value()),
                                   trainable=False)
            var.stop_gradient = True
            self._lr_name = var.name
        return prog.global_block().var(self._lr_name)

    def _get_lr_value(self):
        lr = self._lr
        return float(lr() if callable(lr) else lr)

    def _fill_lr(self, value):
        scope = global_scope()
        if self._lr_name is not None and scope.has(self._lr_name):
            scope.get(self._lr_name).fill_(value)  # rounded to float32

    def set_lr(self, value):
        self._lr = float(value)
        self._fill_lr(self._lr)

    def sync_lr(self):
        """Write the current (possibly scheduled) lr into the scope."""
        self._fill_lr(self._get_lr_value())

    def minimize(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        prog = default_main_program()
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        if self._grad_clip is not None:
            params_grads = self._append_clip(params_grads)
        lr = self._lr_var(prog)
        self._append_update_ops(prog, params_grads, lr)
        return None, params_grads

    def _append_clip(self, params_grads):
        """``ClipGradByGlobalNorm``-style clipping as graph ops: the squares'
        sum, its root, ``min(1, clip_norm / max(norm, 1e-12))``, and each
        gradient times it."""
        sq = None
        for _, g in params_grads:
            s = ops.sum(ops.square(g))
            sq = s if sq is None else ops.add(sq, s)
        gnorm = ops.sqrt(sq)
        clip_norm = self._grad_clip.clip_norm
        factor = ops.minimum(ops.full([], 1.0), ops.divide(
            ops.full([], float(clip_norm)), ops.maximum(gnorm, ops.full([], 1e-12))))
        return [(p, ops.multiply(g, factor)) for p, g in params_grads]

    def _append_update_ops(self, prog, params_grads, lr):
        raise NotImplementedError


class SGD(StaticOptimizer):
    def _append_update_ops(self, prog, params_grads, lr):
        block = prog.global_block()
        for p, g in params_grads:
            # __inplace__: the update op writes the parameter it reads
            block.append_op("sgd", {"X": [p.name, g.name, lr.name]}, {"Out": [p.name]},
                            {"__inplace__": [p.name]})


class Momentum(StaticOptimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, use_nesterov=False, grad_clip=None):
        super().__init__(learning_rate, grad_clip)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _append_update_ops(self, prog, params_grads, lr):
        block = prog.global_block()
        for p, g in params_grads:
            vel = create_parameter(p.shape, str(p.dtype), name=p.name + "@velocity",
                                   initializer=I.Constant(0.0), trainable=False)
            block.append_op(
                "momentum_update", {"X": [p.name, g.name, vel.name, lr.name]},
                {"Out": [p.name, vel.name]},
                {"mu": self._momentum, "use_nesterov": self._use_nesterov,
                 "__inplace__": [p.name, vel.name]})


class Adam(StaticOptimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 grad_clip=None):
        super().__init__(learning_rate, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _append_update_ops(self, prog, params_grads, lr):
        block = prog.global_block()
        step = create_parameter([], "float32", name=prog._unique_name("adam_step"),
                                initializer=I.Constant(0.0), trainable=False)
        step.stop_gradient = True
        block.append_op("increment", {"X": [step.name]}, {"Out": [step.name]},
                        {"value": 1.0, "__inplace__": [step.name]})
        for p, g in params_grads:
            m1 = create_parameter(p.shape, str(p.dtype), name=p.name + "@moment1",
                                  initializer=I.Constant(0.0), trainable=False)
            m2 = create_parameter(p.shape, str(p.dtype), name=p.name + "@moment2",
                                  initializer=I.Constant(0.0), trainable=False)
            block.append_op(
                "adam_update", {"X": [p.name, g.name, m1.name, m2.name, lr.name, step.name]},
                {"Out": [p.name, m1.name, m2.name]},
                {"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon,
                 "__inplace__": [p.name, m1.name, m2.name]})
