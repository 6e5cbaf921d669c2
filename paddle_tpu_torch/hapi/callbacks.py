"""Training callbacks (``paddle_tpu/hapi/callbacks.py``; incubate/hapi/callbacks.py)."""
from __future__ import annotations

import numpy as np


class Callback:
    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def __getattr__(self, name):
        if not name.startswith("on_"):
            raise AttributeError(name)

        def call(*args, **kwargs):
            for cb in self.callbacks:
                getattr(cb, name)(*args, **kwargs)

        return call

    def set_model(self, model):
        for cb in self.callbacks:
            cb.set_model(model)

    def set_params(self, params):
        for cb in self.callbacks:
            cb.set_params(params)


class ProgBarLogger(Callback):
    """Per-epoch stdout logging (simplified progress bar)."""

    def __init__(self, log_freq=10, verbose=1):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = 0

    def on_train_batch_end(self, step, logs=None):
        self.steps += 1
        if self.verbose and self.steps % self.log_freq == 0:
            msg = " - ".join(
                f"{k}: {float(np.asarray(v)):.4f}"
                for k, v in (logs or {}).items()
                if np.ndim(v) == 0 or np.size(v) == 1
            )
            print(f"Epoch {self.epoch} step {self.steps}: {msg}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            msg = " - ".join(
                f"{k}: {float(np.asarray(v)):.4f}"
                for k, v in (logs or {}).items()
                if np.ndim(v) == 0 or np.size(v) == 1
            )
            print(f"Epoch {epoch} done: {msg}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(f"{self.save_dir}/final")


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="min", patience=0, min_delta=0,
                 baseline=None, save_best_model=True):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.wait = 0
        self.best = None
        self.stopped_epoch = 0
        self.mode = mode
        self.stop_training = False

    def _better(self, cur):
        if self.best is None:
            return True
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        if self.monitor not in logs:
            return
        cur = float(np.asarray(logs[self.monitor]).reshape(-1)[0])
        if self._better(cur):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stop_training = True
                self.model.stop_training = True
