"""Auto-checkpoint: env-configured periodic training snapshots + resume (``paddle_tpu/incubate/auto_checkpoint.py``).

Reference parity: python/paddle/fluid/incubate/checkpoint/auto_checkpoint.py
— AutoCheckpointChecker (:71, env config :116-188), train_epoch_range
(resume semantics), checkpoint_saver.py (rotated snapshots over the fs
layer). Environment variables (reference names kept):

    PADDLE_RUNNING_ENV=PADDLE_EDL_AUTO_CHECKPOINT   enable
    PADDLE_EDL_HDFS_CHECKPOINT_PATH=<dir>           checkpoint directory
    PADDLE_JOB_ID=<id>                              namespace inside dir
    PADDLE_EDL_SAVE_CHECKPOINT_INTER=<secs>         min seconds between saves
                                                    (FLAGS_checkpoint_save_inter_s
                                                    >= 0 overrides)

A snapshot is the model's state dict, the optimizer's and the epoch,
written to <dir>/<job>/epoch_<n>/ with rotation, in the JAX package's
files (either package resumes from the other's); a compiled train step is
rebuilt from the model and optimizer on resume.

Crash consistency + async (distributed/checkpoint.py underneath): the
state is copied to the host on the caller's thread (training updates the
live tensors in place right after), then serialized + fsynced on the
background writer thread
(``FLAGS_checkpoint_async``) and published by one atomic tmp→rename
only after a checksummed MANIFEST.json is durable. A process killed
mid-save leaves a manifest-less ``epoch_N.tmp`` that is swept on the
next load; a checksum-failing published snapshot is skipped in favor of
the next-newest — resume never half-loads a torn snapshot.
"""
from __future__ import annotations

import os
import time

__all__ = ["AutoCheckpointChecker", "train_epoch_range", "register",
           "reset_registry", "wait_pending"]


class AutoCheckpointChecker:
    """auto_checkpoint.py:71 — reads the env configuration once."""

    def __init__(self):
        self.running_env = os.getenv("PADDLE_RUNNING_ENV", "")
        self.ckpt_dir = os.getenv("PADDLE_EDL_HDFS_CHECKPOINT_PATH", "")
        self.job_id = os.getenv("PADDLE_JOB_ID", "default_job")
        try:
            self.save_inter = float(
                os.getenv("PADDLE_EDL_SAVE_CHECKPOINT_INTER", "900")
            )
        except ValueError:
            self.save_inter = 900.0
        from ..flags import flag

        # runtime override without touching the environment
        flag_inter = float(flag("checkpoint_save_inter_s"))
        if flag_inter >= 0:
            self.save_inter = flag_inter

    def valid(self) -> bool:
        return (
            self.running_env == "PADDLE_EDL_AUTO_CHECKPOINT"
            and bool(self.ckpt_dir)
        )

    @property
    def job_dir(self):
        return os.path.join(self.ckpt_dir, self.job_id)


# what a snapshot covers: name -> (model, optimizer|None, sync_fn|None)
_REGISTRY: dict[str, tuple] = {}
_NAME_COUNTS: dict[str, int] = {}
_REGISTRY_EPOCH = 0  # bumped by reset_registry; stale claims re-claim


def registry_epoch() -> int:
    return _REGISTRY_EPOCH


def claim_name(prefix: str) -> str:
    """Deterministic registry name: ``prefix-N`` where N counts prior
    claims of the same prefix in this process. Identical restarted
    programs re-derive the same names, so resume finds its snapshot
    files, while two different models in one process stay disjoint.
    Callers caching the claimed name must also cache registry_epoch()
    and re-claim after a reset (see hapi.Model.fit)."""
    n = _NAME_COUNTS.get(prefix, 0)
    _NAME_COUNTS[prefix] = n + 1
    return f"{prefix}-{n}"


def register(model, optimizer=None, name="default", sync_fn=None):
    """Register eager objects whose state the snapshots cover.

    ``sync_fn`` is called before each save — compiled train steps keep
    state on device (framework/jit.py), so the eager objects must be
    synced for state_dict() to see the trained values.
    """
    _REGISTRY[name] = (model, optimizer, sync_fn)


def reset_registry():
    global _REGISTRY_EPOCH
    _REGISTRY.clear()
    _NAME_COUNTS.clear()
    _REGISTRY_EPOCH += 1


def wait_pending(timeout=None, raise_errors=True):
    """Drain in-flight async snapshot writes (durable or failed-loudly)."""
    from ..distributed import checkpoint as _ckpt

    return _ckpt.wait_pending(timeout=timeout, raise_errors=raise_errors)


def _snapshot_path(checker, epoch):
    return os.path.join(checker.job_dir, f"epoch_{epoch}")


def _capture_registry():
    """Capture every registered object's state: ``sync_fn`` first, then a
    host copy of each tensor of its state dicts, which the background
    writer reads while training goes on updating the live tensors."""
    from ..distributed import checkpoint as _ckpt

    entries = []
    for name, (model, optimizer, sync_fn) in _REGISTRY.items():
        if sync_fn is not None:
            sync_fn()
        params = _ckpt.detach_refs(model.state_dict())
        opt = (_ckpt.detach_refs(optimizer.state_dict())
               if optimizer is not None else None)
        entries.append((name, params, opt))
    return entries


def _save_snapshot(checker, epoch, fs, async_=None):
    """Capture now; serialize + publish inline or on the writer thread."""
    import functools

    from ..distributed import checkpoint as _ckpt
    from ..flags import flag

    if async_ is None:
        async_ = bool(flag("checkpoint_async"))
    entries = _capture_registry()
    final = _snapshot_path(checker, epoch)
    job = functools.partial(_write_epoch_snapshot, checker.job_dir, final,
                            entries, int(epoch), fs)
    if async_:
        from ..monitor import registry as _reg

        _reg.counter("checkpoint/async_saves").inc()
        return _ckpt.submit(job, label=final)
    job()
    return None


def _write_epoch_snapshot(job_dir, final, entries, epoch, fs):
    """Writer body: data files -> checksummed manifest -> atomic rename
    -> rotation. FLAGS_fault_injection's ``mid_save`` point sits between
    the data files and the manifest — the torn window crash-consistent
    rotation must survive."""
    from ..distributed import chaos
    from ..distributed import checkpoint as _ckpt
    from ..framework.serialization import dumps
    from ..flags import flag
    from ..monitor import flight_recorder as _flight
    from ..monitor import registry as _reg
    from ..profiler import RecordEvent

    t0 = time.perf_counter()
    tmp = final + ".tmp"
    fs.delete(tmp)
    fs.mkdirs(tmp)
    files = {}
    with RecordEvent("checkpoint::serialize"):
        for name, params, opt in entries:
            fname = f"{name}.pdparams"
            crc, size = _ckpt.write_bytes(
                os.path.join(tmp, fname), dumps(params))
            files[fname] = {"crc32": crc, "size": size}
            chaos.inject("mid_save")
            if opt is not None:
                fname = f"{name}.pdopt"
                crc, size = _ckpt.write_bytes(
                    os.path.join(tmp, fname), dumps(opt))
                files[fname] = {"crc32": crc, "size": size}
    _ckpt.write_manifest(tmp, files, epoch=epoch, time=time.time())
    with RecordEvent("checkpoint::publish"):
        fs.delete(final)
        fs.rename(tmp, final)  # atomic publish
        _ckpt._fsync_dir(os.path.dirname(final) or ".")
    _reg.counter("checkpoint/saves").inc()
    _flight.record_event(
        "checkpoint_saved", path=final, step=epoch,
        ms=round((time.perf_counter() - t0) * 1e3, 3))
    # rotation: drop oldest INTACT snapshots beyond FLAGS_checkpoint_keep
    checker_like = _PathChecker(job_dir)
    found = _list_snapshots(checker_like, fs)
    for old in found[:-max(int(flag("checkpoint_keep")), 1)]:
        fs.delete(_snapshot_path(checker_like, old))


class _PathChecker:
    """Minimal checker stand-in for writer-thread rotation (the real
    AutoCheckpointChecker reads env, which may have changed mid-run)."""

    def __init__(self, job_dir):
        self.job_dir = job_dir


def _list_snapshots(checker, fs):
    dirs, _ = fs.ls_dir(checker.job_dir)
    epochs = []
    for d in dirs:
        if d.startswith("epoch_") and not d.endswith(".tmp"):
            try:
                epochs.append(int(d[len("epoch_"):]))
            except ValueError:
                continue
    return sorted(epochs)


def _load_latest(checker, fs):
    """Restore registered objects from the newest *intact* snapshot;
    returns the epoch it covered, or -1.

    Startup hygiene + fallback: stale ``epoch_N.tmp`` dirs (a writer
    died mid-save) are swept first; a published snapshot whose manifest
    is missing or whose files fail their checksums is skipped — with a
    flight-recorder event + counter — in favor of the next-newest."""
    from ..distributed import checkpoint as _ckpt
    from ..framework.serialization import load
    from ..monitor import flight_recorder as _flight
    from ..monitor import registry as _reg

    # an in-process restart (elastic_run) may arrive while the writer
    # thread still holds queued snapshots — drain first so resume sees
    # everything that was captured before the crash (writer errors were
    # already recorded; the fallback scan below handles their absence)
    _ckpt.wait_pending(raise_errors=False)
    _ckpt.sweep_tmp(checker.job_dir)
    found = _list_snapshots(checker, fs)
    for epoch in reversed(found):
        path = _snapshot_path(checker, epoch)
        try:
            _ckpt.validate(path)
        except _ckpt.CheckpointCorruptError as e:
            # legacy (pre-manifest) snapshots wrote a `meta` epoch file
            # and no MANIFEST.json; they published atomically, so a
            # manifest-less dir WITH meta is an intact old-format
            # snapshot — an upgraded job must resume from it, not
            # silently restart at epoch 0. Anything else is torn.
            if not fs.is_file(os.path.join(path, "meta")):
                _reg.counter("checkpoint/corrupt_skipped").inc()
                _flight.record_event("checkpoint_skipped_corrupt",
                                     path=path, error=str(e)[:200])
                continue
            _flight.record_event("checkpoint_legacy_snapshot", path=path)
        for name, (model, optimizer, _sync) in _REGISTRY.items():
            params_file = os.path.join(path, f"{name}.pdparams")
            if not fs.is_file(params_file):
                # registered after this snapshot was written (e.g. a second
                # Model.fit in the same process): nothing to restore for it
                continue
            model.set_state_dict(load(params_file))
            opt_file = os.path.join(path, f"{name}.pdopt")
            if optimizer is not None and fs.is_file(opt_file):
                optimizer.set_state_dict(load(opt_file))
        _reg.counter("checkpoint/restores").inc()
        _flight.record_event("checkpoint_restored", path=path, step=epoch)
        return epoch
    return -1


def train_epoch_range(max_epoch_num, save_checkpoint_inter=None):
    """Resumable epoch loop (auto_checkpoint.py train_epoch_range).

    Yields epoch indices. With the auto-checkpoint env configured, the
    registered model/optimizer are restored from the newest intact
    snapshot and completed epochs are skipped; a snapshot is written
    when at least ``save_checkpoint_inter`` seconds (env/flag default)
    elapsed since the last one, and always at the final epoch. Saves
    run off the epoch path on the background writer
    (``FLAGS_checkpoint_async``); the loop drains them before returning
    so a completed run's final snapshot is durable.
    """
    from .fs_local import local_fs

    checker = AutoCheckpointChecker()
    if not checker.valid():
        yield from range(max_epoch_num)
        return

    fs = local_fs()
    inter = (checker.save_inter if save_checkpoint_inter is None
             else float(save_checkpoint_inter))
    start = _load_latest(checker, fs) + 1
    last_save = time.monotonic()
    for epoch in range(start, max_epoch_num):
        yield epoch
        now = time.monotonic()
        if now - last_save >= inter or epoch == max_epoch_num - 1:
            _save_snapshot(checker, epoch, fs)
            last_save = now
    # normal completion: make the async snapshots durable before the
    # caller moves on (a crash after this point resumes past max_epoch)
    wait_pending()
