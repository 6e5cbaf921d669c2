"""paddle.Model in the port (``paddle_tpu/hapi/model.py``): the train, eval and predict facade.

Reference parity: incubate/hapi/model.py (Model :637, fit :1110,
evaluate :1309, predict :1406). ``train_batch`` runs the port's compiled
train step (``framework/jit.py``: a CUDA graph captured at a batch
signature's second call, replayed after; the CPU runs it eagerly) and reads
the loss on the host each step, as the JAX package's; ``eval_batch`` and
``predict_batch`` run the network's forward eagerly in eval mode, without
``auto_cast``. ``fit`` runs under a ``TrainingMonitor``, calls
``FLAGS_fault_injection``'s ``step`` point before every step and resumes
from ``incubate.auto_checkpoint`` snapshots when the environment asks for
them. Steps and loaders take the :func:`~paddle_tpu_torch.set_device`
choice, else the card (and raise with neither).

A mesh or a fleet strategy needs ``parallel``/``distributed``, which the
port has not yet (ROADMAP.md Queue A item 9): a strategy raises
``NotImplementedError``, never trains without it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import jit as fjit
from ..io import DataLoader
from .callbacks import CallbackList, ProgBarLogger

__all__ = ["Model", "summary"]

_NEEDS_DISTRIBUTED = ("needs parallel/distributed, which the port does not have yet "
                      "(ROADMAP.md Queue A item 9)")


def _device():
    from ..framework.place import default_device

    return default_device()


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self.stop_training = False
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._train_step = None
        self._amp = None

    # -- configuration ------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None, amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = metrics if isinstance(metrics, (list, tuple)) else (
            [metrics] if metrics is not None else []
        )
        self._amp = amp_configs
        self._train_step = None
        return self

    # -- core steps ---------------------------------------------------------
    def _build_train_step(self):
        loss_obj = self._loss
        use_amp = bool(self._amp)

        def loss_fn(network, *batch):
            # convention: last element is the label
            *xs, y = batch
            if use_amp:
                from .. import amp as amp_mod

                with amp_mod.auto_cast():
                    out = network(*xs)
                out = out.float()
            else:
                out = network(*xs)
            loss = loss_obj(out, y)
            if isinstance(loss, (list, tuple)):
                loss = loss[0]
            return loss.mean() if loss.ndim > 0 else loss

        # fleet.distributed_optimizer carries a DistributedStrategy
        if getattr(self._optimizer, "user_defined_strategy", None) is not None:
            raise NotImplementedError(f"Model.fit with a fleet strategy {_NEEDS_DISTRIBUTED}")
        return fjit.train_step(self.network, self._optimizer, loss_fn, device=_device())

    def train_batch(self, inputs, labels=None):
        if self._train_step is None:
            self._train_step = self._build_train_step()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        labels = labels if labels is not None else []
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        metrics = self._train_step(*inputs, *labels)
        return {"loss": float(metrics["loss"])}

    def _forward_eval(self, inputs):
        device = _device()
        self.network.to(device)
        self.network.eval()
        try:
            with torch.no_grad():
                return self.network(*[_to_tensor(x, device) for x in inputs])
        finally:
            self.network.train()

    def eval_batch(self, inputs, labels=None):
        self._sync_from_step()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        out = self._forward_eval(inputs)
        logs = {}
        y = labels if not isinstance(labels, (list, tuple)) else labels[0]
        if labels is not None and self._loss is not None:
            with torch.no_grad():
                loss = self._loss(out, _to_tensor(y, out.device))
            if isinstance(loss, (list, tuple)):
                loss = loss[0]
            logs["loss"] = float(loss.mean())
        for m in self._metrics:
            res = m.compute(out, _to_tensor(y, out.device))
            m.update(res)
        return logs, out

    def predict_batch(self, inputs):
        self._sync_from_step()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        return self._forward_eval(inputs)

    def _sync_from_step(self):
        if self._train_step is not None:
            self._train_step.sync()

    # -- high-level loops ---------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=1,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None):
        loader = _as_loader(train_data, batch_size, shuffle, drop_last,
                            num_workers)
        eval_loader = (
            _as_loader(eval_data, batch_size, False, False, num_workers)
            if eval_data is not None else None
        )
        cbks = CallbackList(
            (callbacks or []) + ([ProgBarLogger(log_freq, verbose)] if verbose else [])
        )
        cbks.set_model(self)
        cbks.set_params({"epochs": epochs, "verbose": verbose})
        self.stop_training = False

        cbks.on_train_begin()
        logs = {}

        # auto-checkpoint: with PADDLE_RUNNING_ENV=PADDLE_EDL_AUTO_CHECKPOINT
        # fit resumes from the newest snapshot and snapshots periodically
        from ..incubate import auto_checkpoint as acp

        if acp.AutoCheckpointChecker().valid():
            self._sync_from_step()
            # one deterministic name per model instance, claimed again after
            # a registry reset, so a restarted program finds its snapshots
            if (getattr(self, "_acp_epoch", None) != acp.registry_epoch()
                    or not hasattr(self, "_acp_name")):
                self._acp_name = acp.claim_name(type(self.network).__name__)
                self._acp_epoch = acp.registry_epoch()
            acp.register(self.network, self._optimizer,
                         name=self._acp_name,
                         sync_fn=self._sync_from_step)
            # the restore rewrites the model and optimizer in place; the
            # step is rebuilt from them
            self._train_step = None
            epoch_iter = acp.train_epoch_range(epochs)
        else:
            epoch_iter = iter(range(epochs))

        from ..distributed import chaos
        from ..monitor import TrainingMonitor

        mon = TrainingMonitor("fit", interval=None if verbose else 0)
        gstep = 0
        try:
            for epoch in epoch_iter:
                cbks.on_epoch_begin(epoch)
                for step, batch in enumerate(loader):
                    chaos.inject("step", step=gstep)
                    gstep += 1
                    cbks.on_train_batch_begin(step)
                    xs, ys = _split_batch(batch)
                    with mon.step(examples=_batch_examples(xs)):
                        logs = self.train_batch(xs, ys)
                    cbks.on_train_batch_end(step, logs)
                if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                    eval_logs = self.evaluate(
                        eval_loader, batch_size=batch_size, verbose=0,
                        _prepared=True,
                    )
                    logs.update(
                        {f"eval_{k}": v for k, v in eval_logs.items()})
                    cbks.on_eval_end(eval_logs)
                cbks.on_epoch_end(epoch, logs)
                if save_dir and (epoch + 1) % save_freq == 0:
                    self.save(f"{save_dir}/{epoch}")
                if self.stop_training:
                    break
        finally:
            mon.close()
            if acp.AutoCheckpointChecker().valid():
                # in-flight snapshots become durable (or fail loudly) before
                # fit returns; a writer error raises only when the loop
                # itself succeeded
                import sys as _sys

                acp.wait_pending(
                    raise_errors=_sys.exc_info()[0] is None)
        cbks.on_train_end(logs)
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=1,
                 num_workers=0, callbacks=None, _prepared=False):
        loader = (
            eval_data if _prepared
            else _as_loader(eval_data, batch_size, False, False, num_workers)
        )
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            xs, ys = _split_batch(batch)
            logs, _ = self.eval_batch(xs, ys)
            if "loss" in logs:
                losses.append(logs["loss"])
        out = {}
        if losses:
            out["loss"] = float(np.mean(losses))
        for m in self._metrics:
            name = m.name()
            val = m.accumulate()
            if isinstance(name, list):
                out.update(dict(zip(name, val)))
            else:
                out[name] = val
        return out

    def predict(self, test_data, batch_size=1, num_workers=0, stack_outputs=False,
                callbacks=None):
        loader = _as_loader(test_data, batch_size, False, False, num_workers)
        outs = []
        for batch in loader:
            # labeled datasets (x..., y): the trailing label is dropped
            xs, _ = _split_batch(batch)
            out = self.predict_batch(xs)
            outs.append(out.detach().to("cpu").numpy()
                        if isinstance(out, torch.Tensor) else out)
        if stack_outputs:
            return np.concatenate(outs, axis=0)
        return outs

    # -- persistence / introspection ----------------------------------------
    def save(self, path, training=True):
        """``path.pdparams`` (the network's state dict) and, with
        ``training``, ``path.pdopt`` (the optimizer's), in the JAX
        package's files."""
        from ..framework import serialization

        self._sync_from_step()
        serialization.save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            serialization.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework import serialization

        state = serialization.load(path + ".pdparams", return_numpy=True)
        self.network.set_state_dict(state)
        self._train_step = None
        if not reset_optimizer and self._optimizer is not None:
            try:
                opt_state = serialization.load(path + ".pdopt", return_numpy=True)
                self._optimizer.set_state_dict(opt_state)
            except FileNotFoundError:
                pass

    def serve(self, input_spec, host="127.0.0.1", port=0, model_dir=None,
              warmup=True, **serving_kwargs):
        """Export the network with ``jit.save`` over ``input_spec``, load it
        into a predictor (``inference.create_predictor``, on the
        :func:`~paddle_tpu_torch.set_device` choice, else the card) and start an
        :class:`~paddle_tpu_torch.serving.InferenceServer` on ``host:port``
        (``port=0``: ephemeral); extra keywords (``replicas``, ``buckets``,
        ...) go to the server. Returns the started server."""
        import tempfile

        from .. import jit_api
        from ..inference import Config, create_predictor
        from ..serving import InferenceServer

        self._sync_from_step()
        specs = [
            s if isinstance(s, jit_api.InputSpec) else jit_api.InputSpec(s)
            for s in input_spec
        ]
        dirname = model_dir or tempfile.mkdtemp(prefix="ptt_serve_")
        jit_api.save(self.network, dirname, input_spec=specs)
        predictor = create_predictor(Config(dirname), device=_device())
        server = InferenceServer(predictor, port=port, host=host,
                                 **serving_kwargs)
        return server.start(warmup=warmup)

    def parameters(self):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        total = sum(int(np.prod(p.shape)) for p in self.network.parameters())
        trainable = sum(
            int(np.prod(p.shape))
            for p in self.network.parameters()
            if getattr(p, "trainable", True)
        )
        s = {
            "total_params": total,
            "trainable_params": trainable,
        }
        print(f"Total params: {total:,} (trainable {trainable:,})")
        return s


def _to_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x)).to(device)


def _batch_examples(xs):
    """Leading-dim size of the first input (None when unknowable), from its
    shape only: no device read."""
    x = xs[0] if isinstance(xs, (list, tuple)) and xs else xs
    shape = getattr(x, "shape", None)
    if shape is None and isinstance(x, (list, tuple)):
        shape = (len(x),)
    try:
        return int(shape[0]) if shape else None
    except Exception:
        return None


def _split_batch(batch, labeled=True):
    if isinstance(batch, (list, tuple)) and len(batch) >= 2 and labeled:
        return list(batch[:-1]), batch[-1]
    if isinstance(batch, (list, tuple)):
        return list(batch), None
    return [batch], None


def _as_loader(data, batch_size, shuffle, drop_last, num_workers):
    if isinstance(data, DataLoader):
        return data
    return DataLoader(
        data, batch_size=batch_size, shuffle=shuffle, drop_last=drop_last,
        num_workers=num_workers,
    )


def _layer_cost(layer, args):
    """(FLOPs, bytes) of one call of ``layer`` on ``args``, counted by the
    port's cost model over the aten ops and kernel wrappers it runs
    (``monitor.cost_model.count_work``), where the JAX package lowers the
    layer with ``jax.jit`` and reads XLA's cost analysis."""
    from ..monitor import cost_model

    try:
        with cost_model.count_work() as work:
            layer(*args)
    except Exception:
        return None
    return work.flops, work.bytes_accessed


def summary(net, input_size=None, dtypes=None, cost=False):
    """paddle.summary (hapi/model_summary.py): layer table + param counts.

    ``cost=True`` runs one forward over ``input_size`` (zeros, eval mode,
    on the parameters' device) and reports each leaf layer's FLOPs and
    bytes from the port's cost model (:func:`_layer_cost`), with the fused
    conv + batch norm + relu route off so each layer runs on its own.
    FLOPs may differ from the JAX package's by design (ROADMAP.md: the cost
    model counts the ops that run); the parameter counts do not.
    """
    captured = {}  # id(layer) -> args
    cost_rows = {}
    if cost:
        if input_size is None:
            raise ValueError("summary(cost=True) needs input_size")
        hooks = []
        leaves = [(n, l) for n, l in net.named_sublayers()
                  if not list(l.children())]
        if not leaves:  # the net itself is a single leaf layer
            leaves = [(type(net).__name__, net)]

        def make_hook(lid):
            def pre_hook(layer, inputs):
                if lid not in captured:
                    captured[lid] = tuple(inputs)
                return None
            return pre_hook

        for _, l in leaves:
            hooks.append(l.register_forward_pre_hook(make_hook(id(l))))
        sizes = (input_size if isinstance(input_size, (list, tuple))
                 and isinstance(input_size[0], (list, tuple))
                 else [input_size])
        dts = dtypes or ["float32"] * len(sizes)
        if isinstance(dts, str):
            dts = [dts] * len(sizes)
        first = next(iter(net.parameters()), None)
        device = first.device if first is not None else torch.device("cpu")
        xs = [torch.from_numpy(np.zeros(s, dtype=d)).to(device) for s, d in zip(sizes, dts)]
        uncosted = []
        was_training = net.training
        net.eval()
        from ..flags import get_flags, set_flags
        prev_fuse = get_flags(["use_fused_conv_bn"])
        set_flags({"use_fused_conv_bn": False})
        try:
            with torch.no_grad():
                net(*xs)
                for name, l in leaves:
                    if id(l) not in captured:
                        continue
                    c = _layer_cost(l, captured[id(l)])
                    if c is not None:
                        cost_rows[name] = c
                    else:
                        uncosted.append(name)
        finally:
            set_flags(prev_fuse)
            if was_training:
                net.train()
            for h in hooks:
                h.remove()
        never_ran = [n for n, l in leaves if id(l) not in captured]
        uncosted.extend(never_ran)

    rows = []
    total, trainable = 0, 0
    for name, layer in [("", net)] + list(net.named_sublayers()):
        own = sum(
            int(np.prod(p.shape)) for p in layer._parameters.values()
            if p is not None
        )
        if own or not name or name in cost_rows:
            cls = type(layer).__name__
            rows.append((name or cls, cls, own))
    for _, p in net.named_parameters():
        n = int(np.prod(p.shape))
        total += n
        if getattr(p, "trainable", True):
            trainable += n
    hdr = f"{'Layer':40s} {'Type':24s} {'Params':>12s}"
    if cost:
        hdr += f" {'FLOPs':>14s} {'Bytes':>14s}"
    lines = [hdr]
    for n, c, p in rows:
        line = f"{n[:40]:40s} {c[:24]:24s} {p:12,d}"
        if cost and n in cost_rows:
            fl, by = cost_rows[n]
            line += f" {fl:14,.0f} {by:14,.0f}"
        lines.append(line)
    lines.append("-" * (78 + (30 if cost else 0)))
    lines.append(f"Total params: {total:,d}")
    lines.append(f"Trainable params: {trainable:,d}")
    lines.append(f"Non-trainable params: {total - trainable:,d}")
    out = {"total_params": total, "trainable_params": trainable}
    if cost:
        total_flops = sum(f for f, _ in cost_rows.values())
        total_bytes = sum(b for _, b in cost_rows.values())
        lines.append(f"Total FLOPs (fwd, per-layer sum): {total_flops:,.0f}")
        lines.append(f"Total bytes accessed: {total_bytes:,.0f}")
        out["layer_costs"] = cost_rows
        out["total_flops"] = total_flops
        out["total_bytes"] = total_bytes
        out["uncosted_layers"] = uncosted
        if uncosted:
            lines.append(
                f"NOT costed ({len(uncosted)} layers — the count failed, "
                f"totals underreport): {', '.join(uncosted[:8])}"
                + ("…" if len(uncosted) > 8 else ""))
    text = "\n".join(lines)
    print(text)
    return out
