"""Learning-rate schedulers (``paddle_tpu/optimizer/lr.py``): the base class.

Schedulers are host-side state, a float per step; the optimizer reads
``scheduler()`` at every step. Only :class:`LRScheduler` is ported so
far; the concrete schedules are queued.
"""
from __future__ import annotations

__all__ = ["LRScheduler"]


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = learning_rate
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = learning_rate
        self.step()

    def get_lr(self):
        raise NotImplementedError

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, state):
        self.last_epoch = state["last_epoch"]
        self.last_lr = state["last_lr"]
