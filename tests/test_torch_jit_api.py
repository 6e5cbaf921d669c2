"""``paddle.jit``: ``to_static``, ``save`` and ``load`` (``tests/test_jit_api.py``'s
counterpart), and the Paddle-style ResNet of the chip check's phase 12m
at a small size (one bottleneck a stage, 32 x 32, 10 classes) against the
JAX package's, written from each package's public names
(``chip_smoke.paddle_style_resnet``), the weights carried by
``set_state_dict``: in dygraph, through ``to_static``, and through
``jit.save`` -> ``create_predictor`` at IR levels 0 and 1, within RN_RTOL
of the largest |logit|; a directory either package's ``jit.save`` writes
answers alike in both packages' ``jit.load`` and predictors."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402
import paddle_tpu.nn as jnn  # noqa: E402
import paddle_tpu.nn.functional as jF  # noqa: E402
from paddle_tpu.flags import set_flags as jset_flags  # noqa: E402
from paddle_tpu.inference import Config as JConfig  # noqa: E402
from paddle_tpu.inference import create_predictor as jcreate_predictor  # noqa: E402

import chip_smoke  # noqa: E402
import paddle_tpu_torch as paddle  # noqa: E402
import paddle_tpu_torch.nn as nn  # noqa: E402
import paddle_tpu_torch.nn.functional as F  # noqa: E402
from paddle_tpu_torch.flags import flag, set_flags  # noqa: E402
from paddle_tpu_torch.framework import place as _place  # noqa: E402
from paddle_tpu_torch.inference import Config, create_predictor  # noqa: E402
from paddle_tpu_torch.jit_api import InputSpec  # noqa: E402

torch.set_num_threads(1)
RN_RTOL = 1e-5  # tests/test_torch_static_resnet.py's: max |error| over the largest |logit|
GRAD_RTOL = 1e-4  # a first gradient's max |error| over its largest entry
STAGES, CLASSES, HW = (1, 1, 1, 1), 10, 32


@pytest.fixture(autouse=True)
def _on_the_cpu():
    prev = _place._expected_place
    paddle.set_device("cpu")
    yield
    _place._expected_place = prev


class Net(nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(4, 16)
        self.fc2 = nn.Linear(16, 3)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(4, 16)
        self.fc2 = jnn.Linear(16, 3)

    def forward(self, x):
        return self.fc2(jF.relu(self.fc1(x)))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_to_static_function():
    @paddle.jit.to_static
    def f(x):
        return x * 2 + 1

    out = f(paddle.to_tensor(np.arange(4, dtype="float32")))
    np.testing.assert_allclose(out.numpy(), np.arange(4) * 2 + 1)


def test_to_static_function_reading_the_host_raises_and_runs_nothing():
    ran = []

    @paddle.jit.to_static
    def f(x):
        ran.append(1)
        if x.sum().item() > 0:  # item() reads the host; the AST pass leaves it so
            ran.append(2)
            return x
        return -x

    with pytest.raises(RuntimeError, match="compiled step"):
        f(paddle.to_tensor(np.ones(3, np.float32)))
    assert ran == [1] and len(f.store) == 0


def test_to_static_layer_matches_eager():
    paddle.seed(0)
    m = Net()
    x = paddle.to_tensor(np.random.RandomState(0).randn(5, 4).astype("float32"))
    m.eval()
    ref = m(x).numpy()
    assert paddle.jit.to_static(m) is m
    np.testing.assert_allclose(m(x).numpy(), ref, rtol=1e-5, atol=1e-6)


def test_jit_save_load_roundtrip(tmp_path):
    paddle.seed(1)
    m = Net()
    m.eval()
    x = np.random.RandomState(1).randn(6, 4).astype("float32")
    ref = m(paddle.to_tensor(x)).numpy()
    path = str(tmp_path / "net_model")
    paddle.jit.save(m, path, input_spec=[InputSpec([None, 4], "float32")])
    out = paddle.jit.load(path)(paddle.to_tensor(x))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_jit_saved_model_loads_in_predictor(tmp_path):
    paddle.seed(2)
    m = Net()
    m.eval()
    x = np.random.RandomState(2).randn(3, 4).astype("float32")
    ref = m(paddle.to_tensor(x)).numpy()
    path = str(tmp_path / "net_model2")
    paddle.jit.save(m, path, input_spec=[InputSpec([None, 4], "float32")])
    (out,) = create_predictor(Config(path), device="cpu").run([x])
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_a_saved_directory_answers_alike_in_both_packages(tmp_path, saver):
    jm, m = JNet(), Net()
    m.set_state_dict({k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    jm.eval()
    m.eval()
    x = np.random.RandomState(3).randn(5, 4).astype("float32")
    want = np.asarray(jm(jp.to_tensor(x)).numpy())
    d = str(tmp_path / saver)
    if saver == "jax":
        jp.jit.save(jm, d, input_spec=[jp.jit.InputSpec([None, 4], "float32", "x")])
    else:
        paddle.jit.save(m, d, input_spec=[InputSpec([None, 4], "float32", "x")])
    answers = {
        "port load": paddle.jit.load(d)(paddle.to_tensor(x)).numpy(),
        "port predictor": create_predictor(Config(d), device="cpu").run([x])[0],
        "jax load": np.asarray(jp.jit.load(d)(jp.to_tensor(x)).numpy()),
        "jax predictor": np.asarray(jcreate_predictor(JConfig(d)).run([x])[0]),
    }
    for k, got in answers.items():
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=k)


# -- phase 12m's net, small ------------------------------------------------------------


@pytest.fixture(scope="module")
def nets():
    jp.seed(4)
    jnet = chip_smoke.paddle_style_resnet(jp, stages=STAGES, classes=CLASSES)
    with torch.random.fork_rng():
        prev = _place._expected_place
        paddle.set_device("cpu")
        net = chip_smoke.paddle_style_resnet(paddle, stages=STAGES, classes=CLASSES)
        _place._expected_place = prev
    missing, unexpected = net.set_state_dict(
        {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()})
    assert not missing and not unexpected
    return jnet, net


def _images(rows, seed):
    return np.random.RandomState(seed).randn(rows, 3, HW, HW).astype(np.float32)


def test_small_net_names_its_weights_as_models_resnet(nets):
    import copy

    from paddle_tpu_torch.models.resnet import BottleneckBlock, ResNet

    net = copy.deepcopy(nets[1])
    ref = ResNet(BottleneckBlock, list(STAGES), num_classes=CLASSES)
    assert sorted(net.state_dict()) == sorted(ref.state_dict())
    assert net.set_state_dict(ref.state_dict()) == ([], [])


def test_small_net_trains_in_dygraph_as_jax(nets):
    """Two Momentum steps (lr 0.1) in train mode: the first loss within
    1e-5, each first gradient within GRAD_RTOL of its largest entry, and
    the second loss within the chip check's ResNet loss limit (the first
    step spreads the float32 differences of the gradients, which batch
    norms over 4 images at 1 x 1 amplify)."""
    import copy

    jnet, net = copy.deepcopy(nets[0]), copy.deepcopy(nets[1])
    x, y = _images(4, 5), np.random.RandomState(6).randint(0, CLASSES, (4,)).astype(np.int64)
    jopt = jp.optimizer.Momentum(0.1, 0.9, parameters=jnet.parameters())
    opt = paddle.optimizer.Momentum(0.1, 0.9, parameters=net.parameters())
    jgrads = dict(jnet.named_parameters())
    for step in range(2):
        jloss = jF.cross_entropy(jnet(jp.to_tensor(x)), jp.to_tensor(y))
        jloss.backward()
        loss = F.cross_entropy(net(paddle.to_tensor(x)), paddle.to_tensor(y))
        loss.backward()
        if step == 0:
            np.testing.assert_allclose(float(loss), float(jloss.numpy()), rtol=1e-5)
            for n, p in net.named_parameters():
                want = np.asarray(jgrads[n].grad.numpy())
                assert _rel(p.grad.numpy(), want) <= GRAD_RTOL, n
        else:
            np.testing.assert_allclose(float(loss), float(jloss.numpy()), rtol=0,
                                       atol=chip_smoke.RN_LOSS_ATOL)
        jopt.step()
        jopt.clear_grad()
        opt.step()
        opt.clear_grad()


@pytest.mark.parametrize("level", [0, 1])
def test_small_net_serves_through_jit_save_as_jax(nets, tmp_path, level):
    jnet, net = nets
    jnet.eval()
    net.eval()
    x = _images(3, 7)
    want = np.asarray(jnet(jp.to_tensor(x)).numpy())
    eager = net(paddle.to_tensor(x)).numpy()
    static = paddle.jit.to_static(chip_smoke.paddle_style_resnet(
        paddle, stages=STAGES, classes=CLASSES))
    static.set_state_dict(net.state_dict())
    static.eval()
    d = str(tmp_path / "rn")
    paddle.jit.save(net, d, input_spec=[InputSpec([None, 3, HW, HW], "float32", "image")])
    old, jold = flag("ir_opt_level"), 1
    set_flags({"ir_opt_level": level})
    jset_flags({"ir_opt_level": level})
    try:
        pred = create_predictor(Config(d), device="cpu")
        got = {"dygraph": eager, "to_static": static(paddle.to_tensor(x)).numpy(),
               "predictor": pred.run([x])[0],
               "jax predictor": np.asarray(jcreate_predictor(JConfig(d)).run([x])[0])}
        from paddle_tpu_torch.analysis import optimize_program

        types = [op.type for op in optimize_program(
            pred._program, ["image"], pred.get_output_names(),
            feed_shapes={"image": (3, 3, HW, HW)}).program.global_block().ops]
    finally:
        set_flags({"ir_opt_level": old})
        jset_flags({"ir_opt_level": jold})
    for k, v in got.items():
        assert v.shape == (3, CLASSES) and _rel(v, want) <= RN_RTOL, k
    fused = sum(1 + 2 * b for b in STAGES[:1]) + 2 * (sum(STAGES) - 1)
    assert types.count("fused_conv_bn_relu") == (fused if level else 0)
    assert types.count("adaptive_pool2d") == types.count("linear") == 1
