"""``paddle_tpu_torch.Model`` against ``paddle_tpu.Model`` (``tests/test_hapi.py``'s counterparts).

The same network is built in both packages and the JAX weights are carried
into the port by ``set_state_dict`` (numpy); the data are the same numpy
arrays. ``fit`` runs both packages' compiled train steps (the port's runs
eagerly on the CPU) without shuffle, so each step sees the same batch:
every step's loss must agree within rel 1e-5 in f32, over 2 epochs, under
SGD, Momentum and Adam, on a small MLP and on the LeNet. ``evaluate``'s
loss and ``Accuracy(topk=(1, 2))``, ``predict``, ``save``/``load`` across
the packages, the callbacks, ``summary``'s parameter counts, AMP (O1:
bf16 rounds at other points in the two packages, rel 2e-2; the measured
value is in the assertion's message), auto-checkpoint resume and the
fleet-strategy refusal follow. ``test_data_parallel_wrapper``,
``test_run_check`` and the two ``download`` tests wait for the port's
``distributed`` and ``utils`` (ROADMAP.md Queue A items 9 and 10).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import paddle_tpu as jp  # noqa: E402
import paddle_tpu.nn as jnn  # noqa: E402
import paddle_tpu.optimizer as jopt  # noqa: E402
from paddle_tpu.hapi import EarlyStopping as JEarlyStopping  # noqa: E402
from paddle_tpu.hapi import ModelCheckpoint as JModelCheckpoint  # noqa: E402
from paddle_tpu.hapi.callbacks import Callback as JCallback  # noqa: E402
from paddle_tpu.incubate import auto_checkpoint as jacp  # noqa: E402
from paddle_tpu.metric import Accuracy as JAccuracy  # noqa: E402
from paddle_tpu.models import LeNet as JLeNet  # noqa: E402

import paddle_tpu_torch as paddle  # noqa: E402
import paddle_tpu_torch.nn as nn  # noqa: E402
import paddle_tpu_torch.optimizer as opt  # noqa: E402
from paddle_tpu_torch.framework import place as _place  # noqa: E402
from paddle_tpu_torch.hapi import EarlyStopping, ModelCheckpoint  # noqa: E402
from paddle_tpu_torch.hapi.callbacks import Callback  # noqa: E402
from paddle_tpu_torch.incubate import auto_checkpoint as acp  # noqa: E402
from paddle_tpu_torch.metric import Accuracy  # noqa: E402
from paddle_tpu_torch.models import LeNet  # noqa: E402

torch.set_num_threads(1)
LOSS_RTOL = 1e-5
AMP_LOSS_RTOL = 2e-2


@pytest.fixture(autouse=True)
def _on_the_cpu():
    prev = _place._expected_place
    paddle.set_device("cpu")
    yield
    _place._expected_place = prev


def _data(kind, n=48, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "mlp":
        x = rng.randn(n, 8).astype("float32")
        w = rng.randn(8, 3).astype("float32")
        return x, (x @ w).argmax(1).astype("int64")
    x = rng.rand(n, 1, 28, 28).astype("float32")
    return x, rng.randint(0, 10, n).astype("int64")


def _nets(kind):
    if kind == "mlp":
        jnet = jnn.Sequential(jnn.Linear(8, 32), jnn.ReLU(), jnn.Linear(32, 3))
        net = nn.Sequential(nn.Linear(8, 32), nn.ReLU(), nn.Linear(32, 3))
    else:
        jnet, net = JLeNet(), LeNet()
    net.set_state_dict({k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()})
    return jnet, net


_OPTS = {
    "sgd": lambda mod, ps: mod.SGD(learning_rate=0.05, parameters=ps),
    "momentum": lambda mod, ps: mod.Momentum(learning_rate=0.05, momentum=0.9, parameters=ps),
    "adam": lambda mod, ps: mod.Adam(learning_rate=1e-3, parameters=ps),
}


def _models(kind, opt_name="sgd", metrics=True, amp=None):
    jnet, net = _nets(kind)
    jm, m = jp.Model(jnet), paddle.Model(net)
    jm.prepare(_OPTS[opt_name](jopt, jnet.parameters()), jnn.CrossEntropyLoss(),
               JAccuracy(topk=(1, 2)) if metrics else None, amp_configs=amp)
    m.prepare(_OPTS[opt_name](opt, net.parameters()), nn.CrossEntropyLoss(),
              Accuracy(topk=(1, 2)) if metrics else None, amp_configs=amp)
    return jm, m


def _recorders():
    jl, tl = [], []

    class J(JCallback):
        def on_train_batch_end(self, step, logs=None):
            jl.append(logs["loss"])

    class T(Callback):
        def on_train_batch_end(self, step, logs=None):
            tl.append(logs["loss"])

    return jl, tl, J(), T()


def _fit_both(jm, m, x, y, epochs=2, batch=16, **kw):
    jl, tl, jc, tc = _recorders()
    # the JAX train step with 64-bit types off, as the JAX package runs it
    with jax.enable_x64(False):
        jm.fit(jp.io.TensorDataset([x, y]), batch_size=batch, epochs=epochs, shuffle=False,
               verbose=0, callbacks=[jc], **kw)
    m.fit(paddle.io.TensorDataset([x, y]), batch_size=batch, epochs=epochs, shuffle=False,
          verbose=0, callbacks=[tc], **kw)
    return np.array(jl), np.array(tl)


@pytest.mark.parametrize("opt_name", sorted(_OPTS))
@pytest.mark.parametrize("kind", ["mlp", "lenet"])
def test_fit_losses_equal_jax(kind, opt_name):
    jm, m = _models(kind, opt_name)
    x, y = _data(kind)
    jl, tl = _fit_both(jm, m, x, y)
    assert len(tl) == len(jl) == 6
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)


@pytest.mark.parametrize("kind", ["mlp", "lenet"])
def test_evaluate_and_predict_equal_jax(kind):
    jm, m = _models(kind, "momentum")
    x, y = _data(kind)
    _fit_both(jm, m, x, y, epochs=1)
    with jax.enable_x64(False):
        jev = jm.evaluate(jp.io.TensorDataset([x, y]), batch_size=16, verbose=0)
        jpred = jm.predict(jp.io.TensorDataset([x, y]), batch_size=16, stack_outputs=True)
    ev = m.evaluate(paddle.io.TensorDataset([x, y]), batch_size=16, verbose=0)
    pred = m.predict(paddle.io.TensorDataset([x, y]), batch_size=16, stack_outputs=True)
    assert sorted(ev) == sorted(jev) == ["acc_top1", "acc_top2", "loss"]
    assert ev["acc_top1"] == jev["acc_top1"] and ev["acc_top2"] == jev["acc_top2"]
    np.testing.assert_allclose(ev["loss"], jev["loss"], rtol=LOSS_RTOL)
    assert pred.shape == np.asarray(jpred).shape
    np.testing.assert_allclose(pred, np.asarray(jpred), rtol=1e-5,
                               atol=1e-5 * np.abs(jpred).max())


def test_predict_shapes():
    _, m = _models("mlp")
    x, y = _data("mlp", n=20)
    outs = m.predict(paddle.io.TensorDataset([x, y]), batch_size=8, stack_outputs=True)
    assert outs.shape == (20, 3)
    outs = m.predict(paddle.io.TensorDataset([x, y]), batch_size=8)
    assert [o.shape for o in outs] == [(8, 3), (8, 3), (4, 3)]


def test_save_load_across_the_packages(tmp_path):
    """A port ``save`` loads into a JAX ``Model.load`` and the reverse: the
    same predictions and the optimizer's state."""
    jm, m = _models("mlp", "momentum")
    x, y = _data("mlp")
    _fit_both(jm, m, x, y, epochs=1)
    m.save(str(tmp_path / "port"))
    jm.save(str(tmp_path / "jax"))
    jm2, m2 = _models("mlp", "momentum")
    jm2.load(str(tmp_path / "port"))
    m2.load(str(tmp_path / "jax"))
    ds, jds = paddle.io.TensorDataset([x, y]), jp.io.TensorDataset([x, y])
    p_port = m.predict(ds, batch_size=48, stack_outputs=True)
    p_jax = np.asarray(jm.predict(jds, batch_size=48, stack_outputs=True))
    np.testing.assert_allclose(np.asarray(jm2.predict(jds, batch_size=48, stack_outputs=True)),
                               p_port, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m2.predict(ds, batch_size=48, stack_outputs=True), p_jax,
                               rtol=1e-5, atol=1e-6)
    vel = m2._optimizer.state_dict()["velocity_0"].numpy()
    jvel = np.asarray(jm._optimizer.state_dict()["velocity_0"])
    np.testing.assert_allclose(vel, jvel, rtol=1e-5, atol=1e-7)
    assert m2._optimizer.state_dict()["global_step"] == 3


def test_early_stopping():
    jm, m = _models("mlp", "sgd", metrics=False)
    x, y = _data("mlp")
    es, jes = (EarlyStopping(monitor="loss", patience=0, mode="min", min_delta=10.0),
               JEarlyStopping(monitor="loss", patience=0, mode="min", min_delta=10.0))
    with jax.enable_x64(False):
        jm.fit(jp.io.TensorDataset([x, y]), eval_data=jp.io.TensorDataset([x, y]),
               batch_size=16, epochs=10, shuffle=False, verbose=0, callbacks=[jes])
    m.fit(paddle.io.TensorDataset([x, y]), eval_data=paddle.io.TensorDataset([x, y]),
          batch_size=16, epochs=10, shuffle=False, verbose=0, callbacks=[es])
    # min_delta=10: no improvement ever counts, so training stops after 2 evals
    assert m.stop_training and jm.stop_training
    assert es.wait == jes.wait and es.stopped_epoch == jes.stopped_epoch
    np.testing.assert_allclose(es.best, jes.best, rtol=LOSS_RTOL)


def test_model_checkpoint(tmp_path):
    jm, m = _models("mlp", "sgd", metrics=False)
    x, y = _data("mlp")
    with jax.enable_x64(False):
        jm.fit(jp.io.TensorDataset([x, y]), batch_size=16, epochs=3, shuffle=False, verbose=0,
               callbacks=[JModelCheckpoint(save_freq=2, save_dir=str(tmp_path / "jax"))])
    m.fit(paddle.io.TensorDataset([x, y]), batch_size=16, epochs=3, shuffle=False, verbose=0,
          callbacks=[ModelCheckpoint(save_freq=2, save_dir=str(tmp_path / "port"))])
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["0.pdopt", "0.pdparams", "2.pdopt", "2.pdparams", "final.pdopt",
                     "final.pdparams"]
    state = paddle.load(str(tmp_path / "port" / "final.pdparams"), return_numpy=True)
    jstate = jp.load(str(tmp_path / "jax" / "final.pdparams"), return_numpy=True)
    for k in jstate:
        np.testing.assert_allclose(state[k], jstate[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["mlp", "lenet"])
def test_summary_counts_params_as_jax(kind, capsys):
    jnet, net = _nets(kind)
    info, jinfo = paddle.summary(net), jp.summary(jnet)
    assert info == jinfo
    assert "Total params" in capsys.readouterr().out
    if kind == "mlp":
        assert info["total_params"] == 8 * 32 + 32 + 32 * 3 + 3
    m = paddle.Model(net)
    assert m.summary() == jp.Model(jnet).summary()


def test_summary_cost_counts_each_leaf_layer():
    """``cost=True`` counts each leaf layer's FLOPs with the port's cost
    model (they may differ from XLA's by design); the parameter counts are
    the JAX package's."""
    jnet, net = _nets("lenet")
    info = paddle.summary(net, input_size=(2, 1, 28, 28), cost=True)
    jinfo = jp.summary(jnet, input_size=(2, 1, 28, 28), cost=True)
    assert info["total_params"] == jinfo["total_params"]
    assert not info["uncosted_layers"]
    assert sorted(info["layer_costs"]) == sorted(jinfo["layer_costs"])
    # the first conv: 2 x 6 x 28 x 28 outputs of 9 multiply-adds each
    assert info["layer_costs"]["features.0"][0] >= 2 * 2 * 6 * 28 * 28 * 9
    assert info["total_flops"] > 0 and info["total_bytes"] > 0
    with pytest.raises(ValueError):
        paddle.summary(net, cost=True)


def test_fit_with_amp_agrees_with_jax():
    jm, m = _models("mlp", "adam", metrics=False, amp="O1")
    x, y = _data("mlp")
    jl, tl = _fit_both(jm, m, x, y, epochs=3)
    assert np.isfinite(tl).all()
    worst = float(np.max(np.abs(tl / jl - 1)))
    assert worst <= AMP_LOSS_RTOL, f"AMP losses part by rel {worst}"


def test_fit_auto_checkpoint_resumes_as_jax(monkeypatch, tmp_path):
    """``fit`` under ``PADDLE_RUNNING_ENV=PADDLE_EDL_AUTO_CHECKPOINT``: the
    first run snapshots its epochs; a second run resumes past them and
    trains nothing, its weights the first run's, in both packages. The port
    resumes from the JAX package's snapshots too."""
    monkeypatch.setenv("PADDLE_RUNNING_ENV", "PADDLE_EDL_AUTO_CHECKPOINT")
    monkeypatch.setenv("PADDLE_JOB_ID", "job_1")
    monkeypatch.setenv("PADDLE_EDL_SAVE_CHECKPOINT_INTER", "0")
    rng = np.random.RandomState(0)
    x = rng.randn(32, 4).astype("float32")
    y = rng.randint(0, 2, (32,)).astype("int64")

    def run(pkg, nnmod, optmod, ckpt_dir, seed):
        monkeypatch.setenv("PADDLE_EDL_HDFS_CHECKPOINT_PATH", str(ckpt_dir))
        jnet = jnn.Linear(4, 2)
        if pkg is jp:
            jacp.reset_registry()
            net = jnet
        else:
            acp.reset_registry()
            net = nnmod.Linear(4, 2)
            net.set_state_dict({k: np.asarray(v.numpy()) * seed
                                for k, v in jnet.state_dict().items()})
        model = pkg.Model(net)
        model.prepare(optmod.SGD(learning_rate=0.05, parameters=net.parameters()),
                      nnmod.CrossEntropyLoss())
        with jax.enable_x64(False):
            model.fit(list(zip(x, y)), batch_size=8, epochs=2, verbose=0)
        return np.asarray(net.state_dict()["weight"].numpy())

    w_port = run(paddle, nn, opt, tmp_path / "port", 1)
    snaps = acp._list_snapshots(acp.AutoCheckpointChecker(), __import__(
        "paddle_tpu_torch.incubate.fs_local", fromlist=["LocalFS"]).LocalFS())
    assert snaps == [0, 1]
    w_again = run(paddle, nn, opt, tmp_path / "port", 3)  # fresh weights, restored
    np.testing.assert_array_equal(w_again, w_port)
    w_jax = run(jp, jnn, jopt, tmp_path / "jax", 1)
    w_from_jax = run(paddle, nn, opt, tmp_path / "jax", 5)
    np.testing.assert_array_equal(w_from_jax, w_jax)


def test_a_fleet_strategy_is_refused():
    _, m = _models("mlp")
    m._optimizer.user_defined_strategy = object()
    x, y = _data("mlp")
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        m.fit(paddle.io.TensorDataset([x, y]), batch_size=16, epochs=1, verbose=0)


def test_serve_answers_as_the_network():
    """``Model.serve``: ``jit.save`` -> ``create_predictor`` (on the
    ``set_device`` choice) -> ``InferenceServer``; a POST answers the
    network's eval forward."""
    import json
    import urllib.request

    _, m = _models("mlp")
    srv = m.serve([paddle.jit.InputSpec([None, 8], "float32", "x")], port=0, buckets=(1, 2, 4))
    try:
        x, _ = _data("mlp", n=3)
        req = urllib.request.Request(srv.url + "/predict",
                                     data=json.dumps({"inputs": x.tolist()}).encode(),
                                     headers={"Content-Type": "application/json"})
        out = json.loads(urllib.request.urlopen(req, timeout=60).read())
    finally:
        srv.stop(drain=True)
    (got,) = out["outputs"].values()
    m.network.eval()
    with torch.no_grad():
        want = m.network(torch.from_numpy(x)).numpy()
    assert out["rows"] == 3
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-5, atol=1e-6)
