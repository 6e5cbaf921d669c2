"""The port's program-IR optimizer against the JAX package's.

The counterparts of ``tests/test_ir_opt.py`` (the three fusions through
``Executor.run`` at levels 0 and 1, every refusal, training programs
unchanged, DCE, the pass manager, the version cache, remat under a strict
budget), and beyond them: on programs saved by either package and read by
both, the port's optimizer and the JAX optimizer rewrite to the same op
list (types, inputs, outputs, attributes), and the two rewritten programs
give the same answers on the same weights.

Tolerances: the port's fused ops on the CPU run their kernels' plain
versions (the conv as an unfolded product, ``ops/cuda/conv_bn_relu.py``;
the LayerNorm of the sum with its own statistics), which sum in another
order than the unfused ops, so the fused answers are held to 1e-6 of the
largest |answer| (f32 rounding of short sums; the JAX package, whose fused
op is the unfused sequence on the CPU, is bit-exact there); the int8
contraction to 1e-4 / 1e-5 as in the JAX file.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu.static as jstatic  # noqa: E402
from paddle_tpu import ops as jops  # noqa: E402
from paddle_tpu.analysis import optimize_program as joptimize_program  # noqa: E402
from paddle_tpu.analysis import optimizer_passes as joptimizer_passes  # noqa: E402
from paddle_tpu.flags import set_flags as jset_flags  # noqa: E402

from paddle_tpu_torch import ops, profiler, static  # noqa: E402
from paddle_tpu_torch.analysis import (  # noqa: E402
    MemoryBudgetError,
    optimize_program,
    optimizer_passes,
    optimizer_stats,
    plan_memory,
)
from paddle_tpu_torch.analysis import optimizer as iropt  # noqa: E402
from paddle_tpu_torch.errors import NotFoundError  # noqa: E402
from paddle_tpu_torch.flags import set_flags  # noqa: E402
from paddle_tpu_torch.ops.registry import eval_meta, kernel  # noqa: E402

MB = 1024 * 1024
FUSED_RTOL = 1e-6
PACKAGES = {"port": (static, ops), "jax": (jstatic, jops)}


@pytest.fixture(autouse=True)
def _static_reset():
    for st, _ in PACKAGES.values():
        st.enable_static()
        st.reset_default_programs()
        st.global_scope().clear()
    iropt.reset_optimizer_stats()
    yield
    set_flags({"ir_opt_level": 1, "memory_budget_check": "warn", "device_peaks": ""})
    jset_flags({"ir_opt_level": 1, "memory_budget_check": "warn", "device_peaks": ""})
    for st, _ in PACKAGES.values():
        st.disable_static()
        st.reset_default_programs()
        st.global_scope().clear()


def _conv_bn_relu_net(st=static, o=ops):
    """conv2d -> batch_norm(is_test) -> relu + fc head, fusion-eligible."""
    img = st.data("img", [2, 3, 8, 8], "float32")
    h = st.nn.conv2d(img, num_filters=4, filter_size=3, padding=1, bias_attr=False)
    h = o.relu(st.nn.batch_norm(h, is_test=True))
    out = st.nn.fc(h, 5)
    return {"img": np.random.RandomState(0).randn(2, 3, 8, 8).astype("float32")}, out


def _ln_residual_net(st=static, o=ops, mean=True):
    """fc -> add(residual) -> layer_norm, fusion-eligible; the fetch is the
    mean of the normalized rows (``mean=False``: the rows)."""
    x = st.data("x", [4, 16], "float32")
    ff = st.nn.fc(x, 16, activation="relu", bias_attr=False)
    h = st.nn.layer_norm(o.add(ff, x))
    out = o.mean(h) if mean else h
    return {"x": np.random.RandomState(1).randn(4, 16).astype("float32")}, out


def _int8_net(st=static, o=None, activation="qdq"):
    """The PTQ residue: an int8 weight restored by ``dequantize_static``
    under an f32 matmul, the activation behind a quant-dequant sim op (or
    itself a ``dequantize_static`` of an int8 feed)."""
    block = st.default_main_program().global_block()
    rng = np.random.RandomState(2)
    w = rng.randn(8, 6).astype("float32")
    w_scale = float(np.max(np.abs(w)))
    w8 = np.clip(np.round(w / w_scale * 127.0), -127, 127).astype("int8")
    block.create_var(name="w@int8", shape=[8, 6], dtype="int8", persistable=True)
    st.global_scope().set("w@int8", w8)
    block.create_var(name="w@deq", shape=[8, 6], dtype="float32")
    block.append_op("dequantize_static", {"X": ["w@int8"]}, {"Out": ["w@deq"]},
                    {"scale": w_scale, "bit_length": 8, "dtype": "float32"})
    if activation == "qdq":
        st.data("x", [4, 8], "float32")
        block.create_var(name="x@qdq", shape=[4, 8], dtype="float32")
        block.append_op("quant_dequant_static", {"X": ["x"]}, {"Out": ["x@qdq"]},
                        {"scale": 4.0, "bit_length": 8})
        a, feeds = "x@qdq", {"x": rng.randn(4, 8).astype("float32")}
    else:
        st.data("x8", [4, 8], "int8")
        block.create_var(name="x@deq", shape=[4, 8], dtype="float32")
        block.append_op("dequantize_static", {"X": ["x8"]}, {"Out": ["x@deq"]},
                        {"scale": 3.0, "bit_length": 8, "dtype": "float32"})
        a, feeds = "x@deq", {"x8": rng.randint(-127, 128, (4, 8)).astype("int8")}
    block.create_var(name="y", shape=[4, 6], dtype="float32")
    op_type = "matmul" if activation == "qdq" else "mul"
    block.append_op(op_type, {"X": [a, "w@deq"]}, {"Out": ["y"]}, {})
    return feeds, "y"


def _types(program):
    return [op.type for op in program.global_block().ops]


def _golden_vs_level(feeds, fetch, level=1):
    """The real executor at level 0, then at ``level``: (golden, optimized)."""
    exe = static.Executor("cpu")
    exe.run_startup()
    set_flags({"ir_opt_level": 0})
    golden = np.asarray(exe.run(feed=feeds, fetch_list=[fetch])[0])
    set_flags({"ir_opt_level": level})
    got = np.asarray(exe.run(feed=feeds, fetch_list=[fetch])[0])
    return golden, got


def _close(got, want, rtol=FUSED_RTOL):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


# -- fusion positives ------------------------------------------------------------------------


def test_conv_bn_relu_fuses_and_is_golden():
    feeds, out = _conv_bn_relu_net()
    prog = static.default_main_program()
    golden, got = _golden_vs_level(feeds, out)
    _close(got, golden)
    res = optimize_program(prog, sorted(feeds), [out.name], level=1)
    assert res.changed
    types = _types(res.program)
    assert "fused_conv_bn_relu" in types
    assert "conv2d" not in types and "batch_norm" not in types
    assert "conv2d" in _types(prog)  # the original program is untouched


def test_layernorm_residual_fuses_and_is_golden():
    feeds, out = _ln_residual_net(mean=False)
    prog = static.default_main_program()
    golden, got = _golden_vs_level(feeds, out)
    _close(got, golden)
    res = optimize_program(prog, sorted(feeds), [out.name], level=1)
    assert res.changed
    types = _types(res.program)
    assert "fused_layernorm_residual" in types
    assert "layer_norm" not in types and "elementwise_add" not in types


def test_int8_matmul_contraction():
    """A qdq'd activation and a ``dequantize_static``'d int8 weight under an
    f32 matmul contract to one quantize + ``matmul_int8``."""
    feeds, y = _int8_net()
    prog = static.default_main_program()
    golden, got = _golden_vs_level(feeds, y)
    np.testing.assert_allclose(golden, got, rtol=1e-4, atol=1e-5)
    types = _types(optimize_program(prog, ["x"], ["y"], level=1).program)
    assert "matmul_int8" in types and "quantize_static" in types
    assert "matmul" not in types and "quant_dequant_static" not in types


def test_dequantized_int8_operands_contract_onto_mul_int8():
    """Both operands ``dequantize_static`` of int8 tensors under a ``mul``:
    one ``mul_int8`` of the two int8 tensors, nothing left to dequantize."""
    feeds, y = _int8_net(activation="int8")
    golden, got = _golden_vs_level(feeds, y)
    np.testing.assert_allclose(golden, got, rtol=1e-4, atol=1e-5)
    res = optimize_program(static.default_main_program(), ["x8"], ["y"], level=1)
    assert _types(res.program) == ["mul_int8"]
    assert res.program.global_block().ops[0].inputs["X"] == ["x8", "w@int8"]


# -- fusion refusals -------------------------------------------------------------------------


def test_fetched_intermediate_blocks_fusion():
    img = static.data("img", [2, 3, 8, 8], "float32")
    h = static.nn.conv2d(img, num_filters=4, filter_size=3, padding=1, bias_attr=False)
    bn = static.nn.batch_norm(h, is_test=True)
    ops.relu(bn)
    res = optimize_program(static.default_main_program(), ["img"], [bn.name], level=1)
    assert "fused_conv_bn_relu" not in _types(res.program)
    assert "conv2d" in _types(res.program)


def test_second_consumer_blocks_fusion():
    img = static.data("img", [2, 3, 8, 8], "float32")
    h = static.nn.conv2d(img, num_filters=4, filter_size=3, padding=1, bias_attr=False)
    bn = static.nn.batch_norm(h, is_test=True)
    out = ops.mean(ops.add(ops.relu(bn), ops.tanh(bn)))  # a second reader of bn
    res = optimize_program(static.default_main_program(), ["img"], [out.name], level=1)
    assert "fused_conv_bn_relu" not in _types(res.program)


def test_grad_consumer_blocks_fusion_and_training_is_byte_identical():
    """``grad::`` ops replay forward intermediates: a training program comes
    back unchanged, the same object and the same bytes."""
    x = static.data("x", [4, 16], "float32")
    label = static.data("label", [4, 1], "int64")
    ff = static.nn.fc(x, 16, activation="relu")
    h = static.nn.layer_norm(ops.add(ff, x))
    logits = static.nn.fc(h, 10)
    loss = ops.mean(ops.softmax_with_cross_entropy(logits, label))
    static.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    prog = static.default_main_program()
    assert any(op.type.startswith("grad::") for op in prog.global_block().ops)
    before = prog.serialize_to_string()
    res = optimize_program(prog, ["label", "x"], [loss.name], level=1)
    assert not res.changed and res.program is prog
    assert prog.serialize_to_string() == before


def test_residual_shape_mismatch_blocks_ln_fusion():
    x = static.data("x", [4, 16], "float32")
    b = static.nn.create_parameter([16], "float32")
    out = ops.mean(static.nn.layer_norm(ops.add(x, b)))  # a bias add, not a residual
    res = optimize_program(static.default_main_program(), ["x"], [out.name], level=1)
    assert "fused_layernorm_residual" not in _types(res.program)


# -- DCE and the pass manager ------------------------------------------------------------------


def test_dead_op_elimination_drops_unfetched_chain():
    x = static.data("x", [4, 8], "float32")
    live = ops.relu(x)
    ops.tanh(ops.sigmoid(x))  # a dead chain: nothing fetches it
    res = optimize_program(static.default_main_program(), ["x"], [live.name], level=1)
    assert res.changed
    assert _types(res.program) == ["relu"]


def test_unknown_pass_name_raises():
    with pytest.raises(NotFoundError):
        iropt.PassManager(["not_a_pass"])


def test_registered_pipeline_order():
    names = optimizer_passes()
    assert names == joptimizer_passes() == [
        "fuse_conv_bn_relu", "fuse_layernorm_residual", "fuse_int8_matmul", "constant_folding",
        "dead_op_elimination", "rematerialize"]


def test_level_zero_is_identity():
    feeds, out = _conv_bn_relu_net()
    prog = static.default_main_program()
    res = optimize_program(prog, sorted(feeds), [out.name], level=0)
    assert res.program is prog and not res.changed and res.stats == []


def test_optimize_result_caches_per_version():
    feeds, out = _ln_residual_net()
    prog = static.default_main_program()
    profiler.reset_counters()
    r1 = optimize_program(prog, sorted(feeds), [out.name], level=1)
    r2 = optimize_program(prog, sorted(feeds), [out.name], level=1)
    assert r2.program is r1.program  # the same clone, no re-run
    c = profiler.counters()
    assert c.get("ir_opt::cache_miss", 0) == 1 and c.get("ir_opt::cache_hit", 0) == 1
    prog.global_block().create_var(name="extra", shape=[], dtype="float32")
    prog.global_block().append_op("relu", {"X": [out.name]}, {"Out": ["extra"]}, {})
    optimize_program(prog, sorted(feeds), [out.name], level=1)
    assert profiler.counters().get("ir_opt::cache_miss", 0) == 2


def test_per_pass_stats_shape():
    from paddle_tpu_torch.monitor import registry as reg

    feeds, out = _ln_residual_net()
    before = reg.counter("ir_opt/fuse_layernorm_residual/ops_rewritten").value
    optimize_program(static.default_main_program(), sorted(feeds), [out.name], level=1)
    row = optimizer_stats()["fuse_layernorm_residual"]
    assert set(row) == {"runs", "ops_rewritten", "bytes_saved", "wall_ms"}
    assert row["ops_rewritten"] >= 1 and row["runs"] >= 1
    assert reg.counter("ir_opt/fuse_layernorm_residual/ops_rewritten").value - before == 1
    assert profiler.counters()["ir_opt::fuse_layernorm_residual::ops_rewritten"] >= 1


def test_executor_replays_one_clone_per_signature():
    """The executor's gate hands back the same optimized clone at every run
    of a signature (its capture key: the program's identity and version),
    and one liveness table is built for it."""
    feeds, out = _conv_bn_relu_net()
    exe = static.Executor("cpu")
    exe.run_startup()
    for _ in range(3):
        exe.run(feed=feeds, fetch_list=[out])
    (key,) = exe._drops_of
    prog = static.default_main_program()
    clone = optimize_program(prog, sorted(feeds), [out.name],
                             feed_shapes={"img": (2, 3, 8, 8)}, device=exe.device).program
    assert clone is not prog and key[:2] == (clone._identity_token, clone._version)
    assert exe.gate(prog, list(feeds), [out.name], {"img": (2, 3, 8, 8)})[0] is clone


# -- rematerialization -------------------------------------------------------------------------


def _holding_chain():
    """Four 1 MiB activations of a 1 MiB feed held across a serial sum."""
    x = static.data("x", [64, 4096], "float32")
    held = [ops.scale(x, scale=float(i + 1)) for i in range(4)]
    acc = ops.relu(held[0])
    for h in held[1:]:
        acc = ops.add(acc, h)
    out = ops.mean(acc)
    return {"x": np.random.RandomState(3).randn(64, 4096).astype("float32")}, out


def test_remat_converts_strict_rejection_into_admit():
    feeds, out = _holding_chain()
    set_flags({"device_peaks": f"hbm_bytes={4 * MB + 256 * 1024}",
               "memory_budget_check": "strict", "ir_opt_level": 1})
    exe = static.Executor("cpu")
    with pytest.raises(MemoryBudgetError):
        exe.run(feed=feeds, fetch_list=[out])
    set_flags({"ir_opt_level": 2})
    admitted = np.asarray(exe.run(feed=feeds, fetch_list=[out])[0])
    set_flags({"device_peaks": "", "memory_budget_check": "warn", "ir_opt_level": 0})
    golden = np.asarray(exe.run(feed=feeds, fetch_list=[out])[0])
    assert np.array_equal(golden, admitted)


def test_remat_peak_reduction_at_least_20pct():
    feeds, out = _holding_chain()
    prog = static.default_main_program()
    shapes = {"x": (64, 4096)}
    set_flags({"device_peaks": f"hbm_bytes={4 * MB + 256 * 1024}"})
    res = optimize_program(prog, ["x"], [out.name], level=2, feed_shapes=shapes)
    set_flags({"device_peaks": ""})
    p0 = plan_memory(prog, ["x"], [out.name], feed_shapes=shapes).peak_bytes
    p2 = plan_memory(res.program, ["x"], [out.name], feed_shapes=shapes).peak_bytes
    assert (p0 - p2) / p0 >= 0.20
    assert any(op.type == "scale" and "@remat" in op.outputs["Out"][0]
               for op in res.program.global_block().ops)


def test_remat_not_attempted_at_level_one():
    feeds, out = _holding_chain()
    prog = static.default_main_program()
    set_flags({"device_peaks": f"hbm_bytes={4 * MB + 256 * 1024}"})
    res = optimize_program(prog, ["x"], [out.name], level=1, feed_shapes={"x": (64, 4096)})
    assert not res.changed and res.program is prog


def test_remat_noop_without_budget():
    feeds, out = _holding_chain()
    res = optimize_program(static.default_main_program(), ["x"], [out.name], level=2,
                           feed_shapes={"x": (64, 4096)}, device="cpu")
    assert all(s.ops_rewritten == 0 for s in res.stats if s.name == "rematerialize")


# -- the port against the JAX optimizer on the same saved programs ----------------------------


def _resnet_block(st, o):
    """A bottleneck with a projection shortcut: two conv+bn+relu chains, two
    conv+bn pairs without a relu, the residual add and its relu."""
    img = st.data("img", [2, 8, 8, 8], "float32")

    def conv_bn(x, c, k, s=1, act=True):
        h = st.nn.batch_norm(st.nn.conv2d(x, num_filters=c, filter_size=k, stride=s,
                                          padding=k // 2, bias_attr=False), is_test=True)
        return o.relu(h) if act else h

    h = conv_bn(conv_bn(img, 4, 1), 4, 3, 2)
    h = conv_bn(h, 16, 1, act=False)
    return o.relu(o.add(h, conv_bn(img, 16, 1, 2, act=False)))


def _ffn(st, o, layers=3):
    """The chip check's phase-11 program at small widths: ``layers`` x
    (fc -> gelu -> fc, the residual add, layer_norm) on a ``[None, 16]``
    feed. The first layer's residual is the feed, declared ``[None, 16]``
    against the fc output's ``[-1, 16]``, so both optimizers leave that
    pair unfused (the fusion admits equal declared shapes only)."""
    h = x = st.data("x", [None, 16], "float32")
    for _ in range(layers):
        a = st.nn.fc(st.nn.fc(h, 32, activation="gelu"), 16)
        h = st.nn.layer_norm(o.add(h, a))
    assert x.name == "x"
    return st.nn.fc(h, 2)


PROGRAMS = {
    "conv_bn_relu": lambda st, o: _conv_bn_relu_net(st, o)[1],
    "ln_residual": lambda st, o: _ln_residual_net(st, o, mean=False)[1],
    "resnet_block": _resnet_block,
    "ffn": _ffn,
}


def _rewritten(op_list):
    return [(op.type, dict(op.inputs), dict(op.outputs),
             {k: (list(v) if isinstance(v, tuple) else v) for k, v in op.attrs.items()})
            for op in op_list]


def _build(writer, name):
    st, o = PACKAGES[writer]
    out = PROGRAMS[name](st, o)
    exe = static.Executor("cpu") if writer == "port" else jstatic.Executor()
    exe.run_startup()
    prog = st.default_main_program().clone(for_test=True)
    weights = {v.name: np.asarray(st.global_scope().numpy(v.name) if writer == "port" else
                                  np.asarray(st.global_scope().get(v.name)))
               for v in prog.list_vars() if v.persistable and st.global_scope().has(v.name)}
    d = prog.to_dict()
    feeds = [vd["name"] for vd in d["blocks"][0]["vars"] if vd["is_data"]]
    return d, weights, feeds, out.name


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_rewritten_op_lists_equal_the_jax_optimizers(name, writer):
    d, _weights, feeds, out = _build(writer, name)
    results = {}
    for pkg, opt in (("port", optimize_program), ("jax", joptimize_program)):
        prog = PACKAGES[pkg][0].Program.from_dict(d)
        res = opt(prog, feeds, [out], level=1)
        assert res.changed
        results[pkg] = _rewritten(res.program.global_block().ops)
    assert results["port"] == results["jax"]
    fused = [t for t, *_ in results["port"] if t.startswith("fused_")]
    assert fused == {"conv_bn_relu": ["fused_conv_bn_relu"],
                     "ln_residual": ["fused_layernorm_residual"],
                     "resnet_block": ["fused_conv_bn_relu"] * 2,
                     "ffn": ["fused_layernorm_residual"] * 2}[name]


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_fused_outputs_agree_with_the_jax_package(name):
    """The JAX-built program and its weights, run by both executors at
    level 1 (each through its own optimizer): the answers agree to
    FUSED_RTOL of the largest."""
    d, weights, feeds, out = _build("jax", name)
    rng = np.random.RandomState(5)
    jprog = jstatic.Program.from_dict(d)
    feed = {n: rng.randn(*[2 if s in (-1, None) else s for s in jprog.global_block().var(n).shape])
            .astype("float32") for n in feeds}
    pscope, jscope = static.Scope(), jstatic.global_scope()
    for n, w in weights.items():
        pscope.set(n, w)
    want = np.asarray(jstatic.Executor().run(jprog, feed=feed, fetch_list=[out],
                                             scope=jscope)[0])
    got = static.Executor("cpu").run(static.Program.from_dict(d), feed=feed, fetch_list=[out],
                                     scope=pscope)[0]
    _close(got, want)


def test_fused_ops_raise_on_meta_and_infer_through_their_shape_rules():
    m = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    conv_args = [m(2, 3, 8, 8), m(4, 3, 3, 3), m(4), m(4), m(4), m(4)]
    ln_args = [m(4, 16), m(4, 16), m(16), m(16)]
    for op, args, attrs in (("fused_conv_bn_relu", conv_args, {"padding": 1}),
                            ("fused_layernorm_residual", ln_args, {})):
        with pytest.raises(ValueError, match="CUDA"):
            kernel(op)(*args, **attrs)
    y, mean, var = eval_meta("fused_conv_bn_relu", conv_args, {"padding": 1, "stride": 2})
    assert y.shape == (2, 4, 4, 4) and mean.shape == var.shape == (4,)
    assert eval_meta("fused_layernorm_residual", ln_args, {}).shape == (4, 16)
    q = torch.empty(4, 8, dtype=torch.int8, device="meta")
    w = torch.empty(8, 6, dtype=torch.int8, device="meta")
    for op in ("mul_int8", "matmul_int8"):
        with pytest.raises(ValueError, match="CUDA"):
            kernel(op)(q, w, scale_x=1.0, scale_y=1.0)
        out = eval_meta(op, [q, w], {"scale_x": 1.0, "scale_y": 1.0})
        assert out.shape == (4, 6) and out.dtype == torch.float32

