"""``incubate.auto_checkpoint`` and ``distributed.chaos`` in the port.

The single-process counterparts of ``tests/test_auto_checkpoint.py`` (the
local file system, the environment's configuration, resume, rotation,
``sync_fn``, the checksummed manifest, the fallback past a corrupt or
torn snapshot, a legacy ``meta`` snapshot, the stale ``.tmp`` sweep, a
save failing at ``mid_save``), snapshots read across the packages, and
``FLAGS_fault_injection``'s directives at the train-step boundary of
``Model.fit``. The ``kill -9`` writer test of the JAX suite is marked slow
there and has no counterpart here.
"""
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu.nn as jnn  # noqa: E402
from paddle_tpu.distributed import chaos as jchaos  # noqa: E402
from paddle_tpu.incubate import auto_checkpoint as jacp  # noqa: E402

import paddle_tpu_torch as paddle  # noqa: E402
import paddle_tpu_torch.nn as nn  # noqa: E402
import paddle_tpu_torch.optimizer as opt  # noqa: E402
from paddle_tpu_torch.distributed import chaos  # noqa: E402
from paddle_tpu_torch.distributed import checkpoint as ckpt  # noqa: E402
from paddle_tpu_torch.errors import InvalidArgumentError  # noqa: E402
from paddle_tpu_torch.flags import set_flags  # noqa: E402
from paddle_tpu_torch.framework import place as _place  # noqa: E402
from paddle_tpu_torch.framework.serialization import save as ser_save  # noqa: E402
from paddle_tpu_torch.incubate import auto_checkpoint as acp  # noqa: E402
from paddle_tpu_torch.incubate.fs_local import LocalFS  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean():
    prev = _place._expected_place
    paddle.set_device("cpu")
    acp.reset_registry()
    jacp.reset_registry()
    chaos.reset()
    yield
    acp.reset_registry()
    jacp.reset_registry()
    chaos.reset()
    set_flags({"fault_injection": "", "checkpoint_async": True})
    _place._expected_place = prev


def _env(monkeypatch, tmp_path, inter="0"):
    monkeypatch.setenv("PADDLE_RUNNING_ENV", "PADDLE_EDL_AUTO_CHECKPOINT")
    monkeypatch.setenv("PADDLE_EDL_HDFS_CHECKPOINT_PATH", str(tmp_path))
    monkeypatch.setenv("PADDLE_JOB_ID", "job_1")
    monkeypatch.setenv("PADDLE_EDL_SAVE_CHECKPOINT_INTER", inter)


def _w(m):
    return m.weight.detach().numpy().copy()


def test_local_fs_roundtrip(tmp_path):
    fs = LocalFS()
    d = str(tmp_path / "a" / "b")
    fs.mkdirs(d)
    assert fs.is_dir(d) and fs.is_exist(d)
    f = os.path.join(d, "x.txt")
    fs.touch(f)
    assert fs.is_file(f)
    assert fs.ls_dir(str(tmp_path / "a")) == (["b"], [])
    fs.rename(d, str(tmp_path / "c"))
    assert fs.is_dir(str(tmp_path / "c"))
    fs.delete(str(tmp_path / "c"))
    assert not fs.is_exist(str(tmp_path / "c"))
    assert fs.ls_dir(str(tmp_path / "nothing")) == ([], [])


def test_checker_disabled_without_env():
    assert not acp.AutoCheckpointChecker().valid()
    assert list(acp.train_epoch_range(3)) == [0, 1, 2]


def test_checker_env_and_flag(monkeypatch, tmp_path):
    _env(monkeypatch, tmp_path, inter="60")
    c = acp.AutoCheckpointChecker()
    assert c.valid() and c.save_inter == 60.0
    assert c.job_dir == str(tmp_path / "job_1")
    set_flags({"checkpoint_save_inter_s": 5.0})
    try:
        assert acp.AutoCheckpointChecker().save_inter == 5.0
    finally:
        set_flags({"checkpoint_save_inter_s": -1.0})


def test_epoch_range_resumes(monkeypatch, tmp_path):
    _env(monkeypatch, tmp_path)
    m = nn.Linear(4, 2)
    o = opt.SGD(learning_rate=0.1, parameters=m.parameters())
    acp.register(m, o)
    seen = []
    for epoch in acp.train_epoch_range(2):
        seen.append(epoch)
        m(torch.ones(2, 4)).mean().backward()
        o.step()
        o.clear_grad()
    assert seen == [0, 1]
    w_done = _w(m)
    acp.reset_registry()
    m2 = nn.Linear(4, 2)
    o2 = opt.SGD(learning_rate=0.1, parameters=m2.parameters())
    acp.register(m2, o2)
    assert list(acp.train_epoch_range(4)) == [2, 3]
    np.testing.assert_array_equal(_w(m2), w_done)
    assert o2.state_dict()["global_step"] == 2
    # a generator abandoned mid-epoch redoes that epoch on resume
    acp.reset_registry()
    acp.register(nn.Linear(4, 2))
    g = acp.train_epoch_range(6)
    assert next(g) == 4
    g.close()
    acp.reset_registry()
    acp.register(nn.Linear(4, 2))
    assert next(acp.train_epoch_range(6)) == 4


def test_snapshot_rotation_and_sync_fn(monkeypatch, tmp_path):
    _env(monkeypatch, tmp_path)
    calls = []
    acp.register(nn.Linear(2, 2), sync_fn=lambda: calls.append(1))
    for _ in acp.train_epoch_range(5):
        pass
    kept = acp._list_snapshots(acp.AutoCheckpointChecker(), LocalFS())
    assert kept == [3, 4] and len(calls) == 5  # FLAGS_checkpoint_keep = 2


def test_snapshot_has_checksummed_manifest(monkeypatch, tmp_path):
    _env(monkeypatch, tmp_path)
    m = nn.Linear(2, 2)
    acp.register(m, opt.SGD(learning_rate=0.1, parameters=m.parameters()))
    for _ in acp.train_epoch_range(2):
        pass
    manifest = ckpt.validate(acp._snapshot_path(acp.AutoCheckpointChecker(), 1))
    assert manifest["epoch"] == 1
    assert set(manifest["files"]) == {"default.pdparams", "default.pdopt"}
    assert all(meta["size"] > 0 for meta in manifest["files"].values())


def test_load_latest_skips_corrupt_and_falls_back(monkeypatch, tmp_path):
    _env(monkeypatch, tmp_path)
    m = nn.Linear(2, 2)
    acp.register(m)
    for _ in acp.train_epoch_range(4):
        pass
    fs, checker = LocalFS(), acp.AutoCheckpointChecker()
    assert acp._list_snapshots(checker, fs) == [2, 3]
    w = _w(m)
    f = os.path.join(acp._snapshot_path(checker, 3), "default.pdparams")
    data = bytearray(open(f, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(f, "wb").write(bytes(data))
    acp.reset_registry()
    m2 = nn.Linear(2, 2)
    acp.register(m2)
    assert acp._load_latest(checker, fs) == 2
    np.testing.assert_array_equal(_w(m2), w)
    os.remove(os.path.join(acp._snapshot_path(checker, 3), "MANIFEST.json"))
    assert acp._load_latest(checker, fs) == 2


def test_load_latest_reads_legacy_meta_snapshot(monkeypatch, tmp_path):
    _env(monkeypatch, tmp_path)
    checker = acp.AutoCheckpointChecker()
    path = acp._snapshot_path(checker, 3)
    os.makedirs(path)
    w = np.full((4, 2), 7.0, np.float32)
    ser_save({"weight": w, "bias": np.full((2,), 7.0, np.float32)},
             os.path.join(path, "default.pdparams"))
    with open(os.path.join(path, "meta"), "w") as f:
        f.write("3")
    m = nn.Linear(4, 2)
    acp.register(m)
    assert acp._load_latest(checker, LocalFS()) == 3
    np.testing.assert_array_equal(_w(m), w)


def test_load_latest_sweeps_stale_tmp(monkeypatch, tmp_path):
    _env(monkeypatch, tmp_path)
    acp.register(nn.Linear(2, 2))
    for _ in acp.train_epoch_range(2):
        pass
    checker = acp.AutoCheckpointChecker()
    stale = acp._snapshot_path(checker, 9) + ".tmp"
    os.makedirs(stale)
    open(os.path.join(stale, "default.pdparams"), "wb").write(b"partial")
    assert acp._load_latest(checker, LocalFS()) == 1
    assert not os.path.exists(stale)


def test_mid_save_failure_keeps_previous_snapshot(monkeypatch, tmp_path):
    _env(monkeypatch, tmp_path)
    acp.register(nn.Linear(2, 2))
    for _ in acp.train_epoch_range(1):
        pass
    fs, checker = LocalFS(), acp.AutoCheckpointChecker()
    set_flags({"fault_injection": "raise:point=mid_save,n=1", "checkpoint_async": False})
    chaos.reset()
    with pytest.raises(chaos.ChaosInjected):
        acp._save_snapshot(checker, 1, fs)
    set_flags({"fault_injection": "", "checkpoint_async": True})
    assert os.path.isdir(acp._snapshot_path(checker, 1) + ".tmp")
    assert not os.path.exists(acp._snapshot_path(checker, 1))
    assert acp._load_latest(checker, fs) == 0
    assert not os.path.exists(acp._snapshot_path(checker, 1) + ".tmp")


def test_mid_save_in_a_step_checkpoint(tmp_path):
    """The same point inside ``distributed.checkpoint``'s writer: the step
    snapshot is left torn and ``latest_checkpoint`` never takes it."""
    set_flags({"fault_injection": "raise:point=mid_save,n=1"})
    chaos.reset()
    with pytest.raises(chaos.ChaosInjected):
        ckpt.save(str(tmp_path / "step_1"), {"w": torch.ones(2)}, step=1, async_=False)
    assert ckpt.latest_checkpoint(str(tmp_path)) == (None, None)


def test_snapshots_cross_the_packages(monkeypatch, tmp_path):
    """A JAX snapshot resumes the port and a port snapshot the JAX package."""
    _env(monkeypatch, tmp_path)
    jm = jnn.Linear(3, 2)
    jacp.register(jm)
    for _ in jacp.train_epoch_range(2):
        pass
    m = nn.Linear(3, 2)
    acp.register(m)
    assert list(acp.train_epoch_range(3)) == [2]
    np.testing.assert_array_equal(_w(m), np.asarray(jm.weight.numpy()))
    acp.reset_registry()
    acp.register(m)
    for _ in acp.train_epoch_range(4):  # epoch 3, trained here, snapshotted by the port
        with torch.no_grad():
            m.weight.fill_(0.25)
    jacp.reset_registry()
    jm2 = jnn.Linear(3, 2)
    jacp.register(jm2)
    assert list(jacp.train_epoch_range(5)) == [4]
    np.testing.assert_array_equal(np.asarray(jm2.weight.numpy()), np.full((3, 2), 0.25))


# -- chaos at the step boundary -------------------------------------------------------


def test_parse_equals_jax_and_refuses_garbage():
    spec = "kill:point=step,step=3,rank=1;delay:point=step,step=2,ms=250;raise:point=mid_save,n=2"
    assert chaos.parse(spec) == jchaos.parse(spec)
    for bad in ("boom:point=step", "raise:point=nowhere", "raise:point=step,step=x",
                "raise:point=step,step"):
        with pytest.raises(InvalidArgumentError):
            chaos.parse(bad)


def _fit(epochs=1, callbacks=()):
    rng = np.random.RandomState(0)
    x = rng.randn(32, 4).astype("float32")
    y = rng.randint(0, 2, 32).astype("int64")
    net = nn.Linear(4, 2)
    model = paddle.Model(net)
    model.prepare(opt.SGD(learning_rate=0.05, parameters=net.parameters()),
                  nn.CrossEntropyLoss())
    steps = []

    from paddle_tpu_torch.hapi.callbacks import Callback

    class Count(Callback):
        def on_train_batch_end(self, step, logs=None):
            steps.append(step)

    model.fit(paddle.io.TensorDataset([x, y]), batch_size=8, epochs=epochs, verbose=0,
              shuffle=False, callbacks=[Count(), *callbacks])
    return steps


def test_raise_at_a_step_of_fit():
    set_flags({"fault_injection": "raise:point=step,step=5"})
    steps = []
    with pytest.raises(chaos.ChaosInjected, match="step=5"):
        steps = _fit(epochs=2)
    assert steps == []  # fit raised before returning
    set_flags({"fault_injection": "raise:point=step,step=5,rank=1"})
    assert len(_fit(epochs=2)) == 8  # another rank's directive does not fire here


def test_delay_at_a_step_of_fit():
    t0 = time.perf_counter()
    _fit()
    plain = time.perf_counter() - t0
    set_flags({"fault_injection": "delay:point=step,step=1,ms=300"})
    t0 = time.perf_counter()
    assert len(_fit()) == 4
    assert time.perf_counter() - t0 >= 0.3
    assert plain < 30  # the directive, not the run, took the time


def test_a_directive_fires_once_a_process():
    set_flags({"fault_injection": "raise:point=step,step=0"})
    with pytest.raises(chaos.ChaosInjected):
        _fit()
    assert len(_fit()) == 4  # fired already: the next fit runs through


def _flag_defaults(path):
    import ast

    out = {}
    for node in ast.walk(ast.parse(open(path).read())):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "define_flag"
                and len(node.args) >= 2):
            out[ast.literal_eval(node.args[0])] = ast.literal_eval(node.args[1])
    return out


def test_every_port_flag_has_the_jax_default():
    """The port's flags (the four of this slice among them) exist in the JAX
    package's ``flags.py`` with the same default."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _flag_defaults(os.path.join(root, "paddle_tpu_torch", "flags.py"))
    jax_flags = _flag_defaults(os.path.join(root, "paddle_tpu", "flags.py"))
    assert {"io_prefetch_overlap", "fault_injection", "checkpoint_keep",
            "checkpoint_save_inter_s", "checkpoint_async"} <= set(port)
    assert {k: v for k, v in port.items() if jax_flags.get(k, object()) != v} == {}
    assert len(port) == 61
