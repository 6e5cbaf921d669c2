"""Paddle's inference handle API in the port (``paddle_tpu_torch/inference``)
against the JAX package's (``paddle_tpu/inference/predictor.py``).

A LeNet-5 static program built, initialized and saved by the JAX package is
served by both: ``AnalysisConfig`` -> ``create_predictor`` ->
``get_input_handle(...).copy_from_cpu`` -> ``run()`` ->
``get_output_handle(...).copy_to_cpu()``. The port's answers equal the JAX
``Predictor``'s within 1e-5 of the largest logit, and ``run()`` equals
``run(inputs)`` bit for bit; a clone's handles are its own. The switches
with no effect warn as the JAX package's do; ``disable_gpu()`` puts the
predictor on the CPU, and without it and without a card the predictor
refuses to start."""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.inference as jinf
import paddle_tpu.static as jstatic
from paddle_tpu import nets as jnets
from paddle_tpu import ops as jops
from paddle_tpu_torch import inference
from paddle_tpu_torch.errors import InvalidArgumentError

ATOL = 1e-5


@pytest.fixture(scope="module")
def lenet_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lenet") / "model")
    jpaddle.seed(11)
    jstatic.enable_static()
    jstatic.reset_default_programs()
    jstatic.global_scope().clear()
    try:
        img = jstatic.data("img", [None, 1, 28, 28], "float32")
        h = jnets.simple_img_conv_pool(img, 6, 3, 2, 2, conv_padding=1, act="relu")
        h = jnets.simple_img_conv_pool(h, 16, 5, 2, 2, act="relu")
        h = jstatic.nn.fc(h, 120, activation="relu")
        h = jstatic.nn.fc(h, 84, activation="relu")
        logits = jops.softmax(jstatic.nn.fc(h, 10))
        exe = jstatic.Executor()
        exe.run_startup()
        jstatic.save_inference_model(path, ["img"], [logits], exe)
    finally:
        jstatic.disable_static()
        jstatic.reset_default_programs()
    yield path
    jstatic.global_scope().clear()  # the JAX predictors load into it


def _images(seed, n):
    return np.random.RandomState(seed).rand(n, 1, 28, 28).astype(np.float32)


def _cpu_config(path):
    cfg = inference.AnalysisConfig(path)
    cfg.disable_gpu()
    return cfg


def _serve(pred, x):
    name = pred.get_input_names()[0]
    h = pred.get_input_handle(name)
    h.copy_from_cpu(x)
    assert h.shape() == list(x.shape)
    pred.run()
    out = pred.get_output_handle(pred.get_output_names()[0])
    return out.copy_to_cpu()


def test_handles_equal_the_jax_predictors(lenet_dir):
    pred = inference.create_predictor(_cpu_config(lenet_dir))
    assert isinstance(pred, inference.ProgramPredictor) and pred.device.type == "cpu"
    jpred = jinf.create_predictor(jinf.AnalysisConfig(lenet_dir))
    assert pred.get_input_names() == jpred.get_input_names() == ["img"]
    assert pred.get_output_names() == jpred.get_output_names()
    for n in (1, 5):
        x = _images(n, n)
        got, want = _serve(pred, x), _serve(jpred, x)
        assert got.shape == want.shape == (n, 10)
        np.testing.assert_allclose(got, want, atol=ATOL * np.abs(want).max(), rtol=0)
        np.testing.assert_array_equal(got, pred.run([x])[0])
        assert pred.get_output_handle(pred.get_output_names()[0]).shape() == [n, 10]


def test_handle_copies_fix_layout_and_reshape(lenet_dir):
    pred = inference.create_predictor(_cpu_config(lenet_dir))
    x = _images(3, 4)
    want = pred.run([x])[0]
    h = pred.get_input_tensor("img")
    h.copy_from_cpu(x.astype(">f4"))  # big-endian: the feed's byte order fixed
    pred.run()
    np.testing.assert_array_equal(pred.get_output_tensor(pred.get_output_names()[0])
                                  .copy_to_cpu(), want)
    wide = np.zeros((4, 1, 28, 56), np.float32)
    wide[..., ::2] = x
    h.copy_from_cpu(wide[..., ::2])  # a strided view
    flat = x.reshape(4, 784)
    h.copy_from_cpu(flat)
    h.reshape([4, 1, 28, 28])
    assert h.shape() == [4, 1, 28, 28]
    np.testing.assert_array_equal(pred.run()[0], want)


def test_a_clones_handles_are_its_own(lenet_dir):
    pred = inference.create_predictor(_cpu_config(lenet_dir))
    twin = pred.clone()
    assert twin.store is pred.store
    a, b = _images(7, 2), _images(8, 3)
    pred.get_input_handle("img").copy_from_cpu(a)
    twin.get_input_handle("img").copy_from_cpu(b)
    assert pred.get_input_handle("img") is not twin.get_input_handle("img")
    pred.run()
    twin.run()
    out = pred.get_output_names()[0]
    np.testing.assert_array_equal(pred.get_output_handle(out).copy_to_cpu(), pred.run([a])[0])
    np.testing.assert_array_equal(twin.get_output_handle(out).copy_to_cpu(), pred.run([b])[0])


def test_run_before_staging_raises(lenet_dir):
    pred = inference.create_predictor(_cpu_config(lenet_dir))
    with pytest.raises(InvalidArgumentError, match="not set"):
        pred.run()
    with pytest.raises(InvalidArgumentError, match="expected 1 inputs"):
        pred.run([_images(0, 1), _images(0, 1)])


@pytest.mark.parametrize("switch,args", [("enable_memory_optim", ()),
                                         ("set_cpu_math_library_num_threads", (4,)),
                                         ("enable_tensorrt_engine", ()),
                                         ("enable_mkldnn", ())])
def test_switches_without_effect_warn_as_in_the_jax_package(switch, args):
    with pytest.warns(UserWarning, match=f"Config.{switch} has no effect"):
        getattr(inference.Config(), switch)(*args)
    with pytest.warns(UserWarning, match=f"Config.{switch} has no effect"):
        getattr(jinf.Config(), switch)(*args)


def test_device_switches(lenet_dir, monkeypatch):
    cfg = inference.AnalysisConfig()
    assert cfg.use_gpu() and cfg.device() is None  # the current card
    cfg.set_model(lenet_dir)
    assert cfg.model_dir() == lenet_dir
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # choosing the card has an effect: no warning
        cfg.enable_use_gpu(100, 1)
    assert cfg.device() == "cuda:1"
    cfg.disable_gpu()
    assert not cfg.use_gpu() and cfg.device() == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert inference.create_predictor(cfg).device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inference.create_predictor(inference.AnalysisConfig(lenet_dir))
    assert inference.AnalysisConfig is inference.Config
