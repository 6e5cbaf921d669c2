"""Port parity: the static int8 deploy slice, in both directions.

A small fc/gelu/layer_norm program (hidden 32, FFN 64, 2 layers, the shape
of the served 12-layer one) is built in both packages with the same float32
weights (made by the JAX package's startup, carried through the scopes as
numpy) and the same calibration batches from a numpy seed.

- A directory the JAX package calibrates and ``save_int8_model``s loads in
  the port's ``create_predictor(Config(dir), device="cpu")``, and a directory
  the port writes loads in the JAX ``Predictor``: same answers.
- Tolerance of those answers: given equal int8 inputs the int32 accumulators
  are equal, so the packages differ only by float32 rounding of the float
  ops between the products (1e-6 of the largest output, held for the median
  entry) unless that rounding flips one activation across a quantization
  boundary, which moves an output by about ``scale_x * scale_y / 127`` (one
  activation step times the largest weight); the largest entry is held to
  the largest such step over the program's int8 products.
- The port's PTQ of the same weights and batches gives scales equal to
  float32 rounding and int8 weights equal bit for bit.
"""
import json
import os
from urllib.request import Request, urlopen

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu.static as jstatic  # noqa: E402
from paddle_tpu import ops as jops  # noqa: E402
from paddle_tpu import slim as jslim  # noqa: E402
from paddle_tpu.framework import serialization as jserialization  # noqa: E402
from paddle_tpu.inference import Config as JConfig  # noqa: E402
from paddle_tpu.inference import create_predictor as jcreate_predictor  # noqa: E402

import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu_torch import convert, ops, slim, static  # noqa: E402
from paddle_tpu_torch.errors import InvalidArgumentError, UnimplementedError  # noqa: E402
from paddle_tpu_torch.framework import serialization  # noqa: E402
from paddle_tpu_torch.inference import Config, Predictor, ProgramPredictor  # noqa: E402
from paddle_tpu_torch.inference import create_predictor  # noqa: E402
from paddle_tpu_torch.inference.passes import IrPassManager  # noqa: E402
from paddle_tpu_torch.serving import InferenceServer  # noqa: E402
from paddle_tpu_torch.slim.ptq import _clamped_scale, _collect_var_abs_max  # noqa: E402

torch.set_num_threads(1)

HIDDEN, FFN, LAYERS, CLASSES = 32, 64, 2, 2


def _net(st, op_mod):
    """The served program's shape at a small size, in either package."""
    x = st.data("x", [None, HIDDEN], "float32")
    h = x
    for _ in range(LAYERS):
        a = st.nn.fc(h, FFN, activation="gelu")
        a = st.nn.fc(a, HIDDEN)
        h = st.nn.layer_norm(op_mod.add(h, a))
    return x, st.nn.fc(h, CLASSES)


def _fc_net(st, layers=((16, "relu"), (4, None))):
    x = st.data("x", [None, 8], "float32")
    h = x
    for width, act in layers:
        h = st.nn.fc(h, width, activation=act)
    return x, h


def _batches(seed=0, n=4, rows=16, width=HIDDEN):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(rows, width).astype("float32")} for _ in range(n)]


@pytest.fixture
def jax_static():
    jstatic.enable_static()
    jstatic.reset_default_programs()
    jstatic.global_scope().clear()
    yield
    jstatic.disable_static()
    jstatic.reset_default_programs()
    jstatic.global_scope().clear()


@pytest.fixture
def port_static():
    static.enable_static()
    static.reset_default_programs()
    static.global_scope().clear()
    yield
    static.disable_static()
    static.reset_default_programs()
    static.global_scope().clear()


def _jax_build(net=_net):
    """(exe, program, fetch var, float32 weights by name) in the JAX package."""
    x, y = net(jstatic, jops)
    exe = jstatic.Executor()
    exe.run_startup()
    scope = jstatic.global_scope()
    weights = {n: np.array(scope.get(n)) for n in scope.var_names()}
    return exe, jstatic.default_main_program(), y, weights


def _port_build(weights, net=_net):
    x, y = net(static, ops)
    exe = static.Executor("cpu")
    scope = static.global_scope()
    for name, arr in weights.items():
        scope.set(name, arr)
    exe.run_startup()  # nothing left to draw: every parameter is in the scope
    assert sorted(scope.var_names()) == sorted(weights)
    return exe, static.default_main_program(), y


def _jax_leave_static():
    jstatic.disable_static()
    jstatic.reset_default_programs()
    jstatic.global_scope().clear()


def _jax_predict(path, arrays):
    pred = jcreate_predictor(JConfig(path))
    outs = []
    for a in arrays:
        pred.get_input_handle("x").copy_from_cpu(a)
        pred.run()
        outs.append(np.array(pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()))
    return pred, outs


def _flip_step(meta, program):
    """The largest ``scale_x * scale_y / 127`` over the program's int8
    products: what one activation's rounding flip can move an output by."""
    return max(op.attrs["scale_x"] * op.attrs["scale_y"] / 127.0
               for op in program.global_block().ops if op.type.endswith("_int8"))


def _assert_same_answers(got, want, program, meta):
    err = np.abs(got - want)
    assert np.median(err) <= 1e-6 * np.abs(want).max(), np.median(err)
    assert err.max() <= _flip_step(meta, program), err.max()


def test_program_to_dict_matches_the_jax_package(jax_static, port_static):
    """The same network built in both packages serializes to the same
    dictionary: op types, slots, attributes, variable shapes and dtypes, and
    the names too, since both draw them from the same per-prefix counters
    (``param_N``, ``mul_N``, ...). Compared after a JSON round trip, which is
    how a program is stored (tuples become lists)."""
    _, jprog, jy, weights = _jax_build()
    _, tprog, ty = _port_build(weights)
    want = json.loads(json.dumps(jprog.to_dict()))
    got = json.loads(json.dumps(tprog.to_dict()))
    assert [op["type"] for op in got["blocks"][0]["ops"]] == [
        op["type"] for op in want["blocks"][0]["ops"]]
    assert got == want
    assert ty.name == jy.name and ty.shape == list(jy.shape) == [-1, CLASSES]
    # and a program crosses by its dictionary
    assert json.loads(json.dumps(static.Program.from_dict(want).to_dict())) == want


def test_float_program_gives_the_jax_answers(jax_static, port_static):
    """Same weights, same feed: 2e-6 of the largest output (f32 sums in
    another order, ``gelu`` and ``rsqrt`` by other implementations)."""
    jexe, jprog, jy, weights = _jax_build()
    texe, tprog, ty = _port_build(weights)
    feed = _batches(7, n=1, rows=5)[0]
    want = np.asarray(jexe.run(jprog, feed=feed, fetch_list=[jy])[0])
    got = texe.run(tprog, feed=feed, fetch_list=[ty])[0]
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()


def test_jax_saved_int8_directory_serves_in_the_port(jax_static, tmp_path):
    jexe, jprog, jy, _ = _jax_build()
    tests = [b["x"] for b in _batches(1, n=3, rows=5)]
    ptq = jslim.PostTrainingQuantization(jexe, jprog, _batches())
    ptq.quantize()
    path = str(tmp_path / "jax_int8")
    ptq.save_int8_model(path, ["x"], [jy])
    _jax_leave_static()
    _, want = _jax_predict(path, tests)

    pred = create_predictor(Config(path), device="cpu")
    assert isinstance(pred, ProgramPredictor) and pred.device.type == "cpu"
    types = [op.type for op in pred._program.global_block().ops]
    assert types.count("mul_int8") == 2 * LAYERS + 1 == types.count("quantize_static")
    assert "quant_dequant_static" not in types and "mul" not in types
    meta = pred.quant_metadata()
    assert meta["int8_weights"] and meta == jslim.load_quant_metadata(path)
    # int8 weights are int8 in the scope, and no float copy of them is there
    for qname in meta["int8_weights"]:
        assert pred._scope.get(qname).dtype == torch.int8
        assert not pred._scope.has(qname[:-len("@int8")])
    assert pred.get_input_names() == ["x"] and pred.get_output_names() == [jy.name]
    for a, w in zip(tests, want):
        _assert_same_answers(pred.run([a])[0], w, pred._program, meta)
    assert pred.clone()._scope is pred._scope and pred.clone()._program is pred._program


def test_port_ptq_of_the_same_weights_is_bit_equal_and_serves_in_jax(jax_static, port_static,
                                                                     tmp_path):
    jexe, jprog, jy, weights = _jax_build()
    calib = _batches()
    tests = [b["x"] for b in _batches(1, n=3, rows=5)]
    jptq = jslim.PostTrainingQuantization(jexe, jprog, calib)
    jptq.quantize()
    jpath = str(tmp_path / "jax_int8")
    jptq.save_int8_model(jpath, ["x"], [jy])
    _jax_leave_static()

    texe, tprog, ty = _port_build(weights)
    ref = [texe.run(tprog, feed={"x": a}, fetch_list=[ty])[0] for a in tests]
    tptq = slim.PostTrainingQuantization(texe, tprog, calib)
    assert tptq.quantize() is tprog
    tpath = str(tmp_path / "port_int8")
    assert tptq.save_int8_model(tpath, ["x"], [ty]) == [ty.name]
    static.disable_static()

    # scales: activations to f32 rounding of the calibrated maxima, weights exactly
    jmeta, tmeta = jslim.load_quant_metadata(jpath), slim.load_quant_metadata(tpath)
    assert {k: v for k, v in tmeta.items() if k != "scales"} == {
        k: v for k, v in jmeta.items() if k != "scales"}
    assert sorted(tmeta["scales"]) == sorted(jmeta["scales"])
    for name, s in jmeta["scales"].items():
        if name in weights:
            assert tmeta["scales"][name] == s, name
        else:
            np.testing.assert_allclose(tmeta["scales"][name], s, rtol=2e-6, err_msg=name)
    # the int8 weights: bit for bit
    jparams = jserialization.load(os.path.join(jpath, "__params__"), return_numpy=True)
    tparams = serialization.load(os.path.join(tpath, "__params__"), return_numpy=True)
    assert sorted(tparams) == sorted(jparams)
    for name, arr in jparams.items():
        assert tparams[name].dtype == arr.dtype, name
        if arr.dtype == np.int8:
            np.testing.assert_array_equal(tparams[name], arr, err_msg=name)
        else:
            np.testing.assert_array_equal(tparams[name], arr, err_msg=name)
    assert sum(a.dtype == np.int8 for a in tparams.values()) == 2 * LAYERS + 1
    # same program but for the calibrated activation scales
    with open(os.path.join(jpath, "__model__")) as f:
        jmodel = json.load(f)
    with open(os.path.join(tpath, "__model__")) as f:
        tmodel = json.load(f)
    assert tmodel["feed_names"] == jmodel["feed_names"] == ["x"]
    assert tmodel["fetch_names"] == jmodel["fetch_names"]
    strip = lambda m: [(o["type"], o["inputs"], o["outputs"],  # noqa: E731
                        {k: v for k, v in o["attrs"].items() if not k.startswith("scale")})
                       for o in m["program"]["blocks"][0]["ops"]]
    assert strip(tmodel) == strip(jmodel)

    # the JAX Predictor serves the port's directory with the port's answers
    tpred = create_predictor(Config(tpath), device="cpu")
    jpred, want = _jax_predict(tpath, tests)
    assert "mul_int8" in [op.type for op in jpred._program.global_block().ops]
    for a, w, r in zip(tests, want, ref):
        got = tpred.run([a])[0]
        _assert_same_answers(got, w, tpred._program, tmeta)
        # and int8 stays inside the documented envelope of the float program
        assert np.abs(got - r).max() < 0.05 * np.abs(r).max() + 0.05


def test_simulation_program_tracks_the_int8_program(port_static, tmp_path):
    """The calibrated simulation program (``quant_dequant_static``) and the
    deployed int8 program compute the same grid values; only the order of
    the dequantizing multiplies differs (the JAX package's own round-trip
    test holds them to rtol 1e-4, atol 1e-5)."""
    ptt.seed(3)
    x, y = _net(static, ops)
    exe = static.Executor("cpu")
    exe.run_startup()
    prog = static.default_main_program()
    a = _batches(2, n=1, rows=6)[0]["x"]
    ptq = slim.PostTrainingQuantization(exe, prog, _batches())
    ptq.quantize()
    sim = exe.run(prog, feed={"x": a}, fetch_list=[y])[0]
    assert "quant_dequant_static" in [op.type for op in prog.global_block().ops]
    ptq.save_quantized_model(str(tmp_path / "sim"), ["x"], [y])
    ptq.save_int8_model(str(tmp_path / "int8"), ["x"], [y])
    static.disable_static()
    got = create_predictor(Config(str(tmp_path / "int8")), device="cpu").run([a])[0]
    np.testing.assert_allclose(got, sim, rtol=1e-4, atol=1e-5)
    sim_pred = create_predictor(Config(str(tmp_path / "sim")), device="cpu")
    assert sim_pred.quant_metadata() is None
    np.testing.assert_allclose(sim_pred.run([a])[0], sim, rtol=1e-6, atol=1e-6)


def test_mixed_bit_widths_dequantize_each_operand_on_its_own_grid(port_static, tmp_path):
    """w4a8: coarse but scale-correct (a bit-width mix-up would be ~18x off,
    far outside the JAX test's 0.35 envelope)."""
    ptt.seed(6)
    x, y = _fc_net(static)
    exe = static.Executor("cpu")
    exe.run_startup()
    prog = static.default_main_program()
    rng = np.random.RandomState(6)
    calib = [{"x": rng.randn(16, 8).astype("float32")} for _ in range(4)]
    a = rng.randn(8, 8).astype("float32")
    ref = exe.run(prog, feed={"x": a}, fetch_list=[y])[0]
    ptq = slim.PostTrainingQuantization(exe, prog, calib, weight_bits=4, activation_bits=8)
    ptq.quantize()
    path = str(tmp_path / "w4a8")
    ptq.save_int8_model(path, ["x"], [y])
    static.disable_static()
    pred = create_predictor(Config(path), device="cpu")
    ops_ = [op for op in pred._program.global_block().ops if op.type == "mul_int8"]
    assert ops_ and all(op.attrs["y_bit_length"] == 4 and op.attrs["bit_length"] == 8
                        for op in ops_)
    for qname in pred.quant_metadata()["int8_weights"]:
        assert pred._scope.get(qname).abs().max().item() <= 7
    got = pred.run([a])[0]
    assert np.abs(got - ref).max() < 0.35 * np.abs(ref).max() + 0.35


def test_zero_scale_is_clamped(port_static):
    """All-zero calibration batches: every activation's abs-max is 0.0; the
    scales are clamped to 1e-8 and the quantized program stays finite."""
    assert _clamped_scale("v", 0.0) == 1e-8 and _clamped_scale("v", 0.5) == 0.5
    ptt.seed(0)
    x, y = _fc_net(static)
    exe = static.Executor("cpu")
    exe.run_startup()
    prog = static.default_main_program()
    ptq = slim.PostTrainingQuantization(
        exe, prog, [{"x": np.zeros((8, 8), "float32")} for _ in range(2)])
    ptq.quantize()
    assert all(s > 0 for s in ptq.scales.values()) and ptq.scales["x"] == 1e-8
    out = exe.run(prog, feed={"x": np.random.RandomState(0).randn(4, 8).astype("float32")},
                  fetch_list=[y])[0]
    assert np.isfinite(out).all()


def test_calibration_fetch_set_is_validated(port_static):
    ptt.seed(1)
    x, y = _fc_net(static)
    exe = static.Executor("cpu")
    exe.run_startup()
    static.global_scope().set("ghost_var", np.ones(3, "float32"))
    with pytest.raises(InvalidArgumentError, match="ghost_var"):
        _collect_var_abs_max(static.default_main_program(), static.global_scope(), exe,
                             [{"x": np.zeros((4, 8), "float32")}], [y.name, "ghost_var"])
    with pytest.raises(RuntimeError, match="quantize"):
        slim.PostTrainingQuantization(exe, static.default_main_program(), []).save_int8_model(
            "unused", ["x"], [y])


def _conv_net(st, op_mod):
    x = st.data("x", [None, 3, 8, 8], "float32")
    h = st.nn.conv2d(x, 4, 3, padding=1, activation="relu")
    return x, st.nn.fc(h, 5)


def test_conv_weight_ships_as_int8_and_is_restored_by_folding(jax_static, port_static, tmp_path):
    """``conv2d`` has no int8 compute path: its weight ships as int8 and a
    ``dequantize_static`` restores it, which constant folding runs once at
    load (``pass_stats["folded"] >= 1``, no such op left). The same program
    served by the JAX package gives the same answers (1e-5 of the largest
    output: the convolution's sums in another order, no flip seen)."""
    jexe, jprog, jy, weights = _jax_build(_conv_net)
    _jax_leave_static()
    texe, tprog, ty = _port_build(weights, _conv_net)
    rng = np.random.RandomState(8)
    calib = [{"x": rng.randn(4, 3, 8, 8).astype("float32")} for _ in range(3)]
    a = rng.randn(2, 3, 8, 8).astype("float32")
    ptq = slim.PostTrainingQuantization(texe, tprog, calib)
    ptq.quantize()
    path = str(tmp_path / "conv_int8")
    ptq.save_int8_model(path, ["x"], [ty])
    static.disable_static()
    with open(os.path.join(path, "__model__")) as f:
        saved_types = [o["type"] for o in json.load(f)["program"]["blocks"][0]["ops"]]
    assert "dequantize_static" in saved_types and "mul_int8" in saved_types

    pred = create_predictor(Config(path), device="cpu")
    types = [op.type for op in pred._program.global_block().ops]
    assert pred.pass_stats["folded"] >= 1 and "dequantize_static" not in types
    # the bias's reshape reads only a parameter and folds too
    assert pred.pass_stats["folded"] == 2 and "reshape" not in types
    assert pred.pass_stats["ops_after"] == len(types) == pred.pass_stats["ops_before"] - 2
    raw = create_predictor(_no_passes(path), device="cpu")
    assert raw.pass_stats == {}
    assert "dequantize_static" in [op.type for op in raw._program.global_block().ops]
    got = pred.run([a])[0]
    np.testing.assert_array_equal(raw.run([a])[0], got)
    _, want = _jax_predict(path, [a])
    assert np.abs(got - want[0]).max() <= 1e-5 * np.abs(want[0]).max()


def _no_passes(path):
    cfg = Config(path)
    cfg.switch_ir_optim(False)
    return cfg


def test_dead_ops_are_eliminated_and_unknown_passes_refused(port_static):
    ptt.seed(2)
    x, y = _fc_net(static)
    dead = ops.relu(ops.add(y, y))  # nothing fetches it
    exe = static.Executor("cpu")
    exe.run_startup()
    prog = static.default_main_program()
    n = len(prog.global_block().ops)
    stats = IrPassManager().apply(prog, static.global_scope(), ["x"], [y.name])
    assert stats == {"ops_before": n, "folded": 0, "dce_removed": 2, "ops_after": n - 2}
    assert dead.name not in {o for op in prog.global_block().ops for o in op.output_names()}
    with pytest.raises(ptt.errors.NotFoundError, match="fuse_everything"):
        IrPassManager(["fuse_everything"])


def test_served_over_http_at_buckets_1_2_4(port_static, tmp_path):
    """The int8 program behind the port's ``InferenceServer`` on the CPU:
    answers equal a direct ``Predictor.run`` of the same rows (batching and
    padding change no row: 1e-6 of the largest output)."""
    ptt.seed(4)
    x, y = _net(static, ops)
    exe = static.Executor("cpu")
    exe.run_startup()
    ptq = slim.PostTrainingQuantization(exe, static.default_main_program(), _batches())
    ptq.quantize()
    path = str(tmp_path / "served")
    ptq.save_int8_model(path, ["x"], [y])
    static.disable_static()
    pred = create_predictor(Config(path), device="cpu")
    ref = create_predictor(Config(path), device="cpu")
    srv = InferenceServer(pred, port=0, replicas=2, buckets=(1, 2, 4), batch_timeout_ms=1.0)
    srv.start()
    try:
        for a in [b["x"] for b in _batches(5, n=4, rows=1)] + [_batches(6, n=1, rows=3)[0]["x"]]:
            body = json.dumps({"inputs": a.tolist()}).encode()
            r = urlopen(Request(srv.url + "/predict", data=body,
                                headers={"Content-Type": "application/json"}), timeout=60)
            assert r.status == 200
            got = np.asarray(json.loads(r.read())["outputs"][y.name], dtype="float32")
            want = ref.run([a])[0]
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    finally:
        srv.stop(drain=True)


def test_device_rule_and_unported_ops(monkeypatch, port_static, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        static.Executor()
    ptt.seed(5)
    x, y = _fc_net(static)
    exe = static.Executor("cpu")
    exe.run_startup()
    prog = static.default_main_program()
    path = str(tmp_path / "float")
    static.save_inference_model(path, ["x"], [y], exe)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_predictor(Config(path))
    pred = create_predictor(Config(path), device="cpu")
    a = np.random.RandomState(5).randn(3, 8).astype("float32")
    np.testing.assert_array_equal(pred.run([a])[0], exe.run(prog, feed={"x": a},
                                                            fetch_list=[y])[0])
    with pytest.raises(InvalidArgumentError, match="expected 1 inputs"):
        pred.run([a, a])
    prog.global_block().append_op("while", {"X": [x.name]}, {"Out": [y.name]}, {})
    with pytest.raises(UnimplementedError, match="while"):
        exe.run(prog, feed={"x": a}, fetch_list=[y])
    with pytest.raises(InvalidArgumentError, match="neither fed"):
        exe.run(static.Program.from_dict(prog.to_dict()), feed={}, fetch_list=[x.name])
    # the module-backed predictor of the earlier slices still stands beside it
    assert Predictor(torch.nn.Identity(), pred.input_spec, ["y"], device="cpu").run([a])[0].shape \
        == a.shape


def test_captured_constant_travels_with_the_program(port_static, tmp_path):
    """An eager tensor used in a static program becomes a named constant:
    it is part of ``to_dict()``, is saved with the parameters, and the JAX
    ``Predictor`` runs the saved directory to the same answer (1e-6 of the
    largest output)."""
    ptt.seed(8)
    x, h = _fc_net(static)
    y = ops.add(h, torch.tensor([1.0, -2.0, 3.0, 0.5]))
    exe = static.Executor("cpu")
    exe.run_startup()
    prog = static.default_main_program()
    (cname,) = prog._constants
    assert cname in prog.to_dict()["constants"] and prog.global_block().var(cname).persistable
    a = np.random.RandomState(8).randn(3, 8).astype("float32")
    want = exe.run(prog, feed={"x": a}, fetch_list=[y])[0]
    path = str(tmp_path / "const")
    static.save_inference_model(path, ["x"], [y], exe)
    static.disable_static()
    assert cname in serialization.load(os.path.join(path, "__params__"), return_numpy=True)
    np.testing.assert_array_equal(create_predictor(Config(path), device="cpu").run([a])[0], want)
    _, got = _jax_predict(path, [a])
    assert np.abs(got[0] - want).max() <= 1e-6 * np.abs(want).max()


def test_serialization_crosses_both_ways(tmp_path):
    obj = {"w": np.arange(6, dtype=np.int8).reshape(2, 3), "nested": [np.float32(2.5), "s"],
           "t": np.linspace(0, 1, 4, dtype=np.float32)}
    jserialization.save(obj, str(tmp_path / "j.bin"))
    got = serialization.load(str(tmp_path / "j.bin"), return_numpy=True)
    assert got["w"].dtype == np.int8 and (got["w"] == obj["w"]).all() and got["nested"][1] == "s"
    serialization.save({"w": torch.from_numpy(obj["w"]), "t": obj["t"]}, str(tmp_path / "t.bin"))
    back = jserialization.load(str(tmp_path / "t.bin"), return_numpy=True)
    assert back["w"].dtype == np.int8 and (back["w"] == obj["w"]).all()
    np.testing.assert_array_equal(back["t"], obj["t"])


def test_convert_checks_the_parameters_against_the_program(port_static):
    ptt.seed(9)
    x, y = _fc_net(static)
    exe = static.Executor("cpu")
    exe.run_startup()
    prog = static.default_main_program()
    scope = static.global_scope()
    params = {n: scope.numpy(n) for n in scope.var_names()}
    loaded, new_scope = convert.int8_model_from_numpy(prog.to_dict(), params)
    assert new_scope is not scope and sorted(new_scope.var_names()) == sorted(params)
    a = np.ones((2, 8), "float32")
    np.testing.assert_array_equal(
        exe.run(loaded, feed={"x": a}, fetch_list=[y.name], scope=new_scope)[0],
        exe.run(prog, feed={"x": a}, fetch_list=[y])[0])
    with pytest.raises(KeyError, match="param_0"):
        convert.int8_model_from_numpy(prog.to_dict(),
                                      {k: v for k, v in params.items() if k != "param_0"})
    with pytest.raises(ValueError, match="param_0"):
        convert.int8_model_from_numpy(prog.to_dict(), dict(params, param_0=np.zeros((3, 3), "f4")))
