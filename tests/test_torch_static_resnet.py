"""A static ResNet through both packages' predictors, fused and unfused.

``chip_smoke.build_static_resnet`` (the program of the chip check's phase
11b) at small size: one bottleneck a stage at 32 x 32, 10 classes, the
weights of the port's dygraph ``ResNet(BottleneckBlock, [1, 1, 1, 1])``
carried into its scope, saved with ``save_inference_model``. The port's
``ProgramPredictor`` and the JAX package's ``Predictor`` serve the
directory at ``ir_opt_level`` 0 and 1, each against the dygraph
``Predictor`` of the same weights, within RN_RTOL of the largest |logit|
(f32 sums over 14 convs in other orders: the fused conv's plain version is
an unfolded product). Both optimizers rewrite it to the same op list and
both planners plan it alike. At full width, its ResNet-50 has the
33 fusible chains and 20 conv + bn pairs the chip check asserts. A training
program comes back unchanged from level 1 and trains to the same losses,
bit for bit, at level 2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu.static as jstatic  # noqa: E402
from paddle_tpu import ops as jops  # noqa: E402
from paddle_tpu.analysis import optimize_program as joptimize_program  # noqa: E402
from paddle_tpu.analysis import plan_memory as jplan_memory  # noqa: E402
from paddle_tpu.flags import set_flags as jset_flags  # noqa: E402
from paddle_tpu.inference import Config as JConfig  # noqa: E402
from paddle_tpu.inference import create_predictor as jcreate_predictor  # noqa: E402

import chip_smoke  # noqa: E402
from paddle_tpu_torch import ops, static  # noqa: E402
from paddle_tpu_torch.analysis import optimize_program, plan_memory  # noqa: E402
from paddle_tpu_torch.flags import set_flags  # noqa: E402
from paddle_tpu_torch.inference import Config, Predictor, create_predictor  # noqa: E402
from paddle_tpu_torch.jit_api import InputSpec  # noqa: E402
from paddle_tpu_torch.models.resnet import BottleneckBlock, ResNet  # noqa: E402

torch.set_num_threads(4)

STAGES, CLASSES, HW = (1, 1, 1, 1), 10, 32
RN_RTOL = 1e-5
FUSED, PAIRS = 1 + 2 * len(STAGES), 2 * len(STAGES)  # the stem + 2 a block; conv3 + shortcut


@pytest.fixture(autouse=True)
def _flags_back():
    yield
    set_flags({"ir_opt_level": 1, "device_peaks": "", "memory_budget_check": "warn"})
    jset_flags({"ir_opt_level": 1})
    for st in (static, jstatic):
        st.disable_static()
        st.reset_default_programs()


def _model():
    return ResNet(BottleneckBlock, list(STAGES), num_classes=CLASSES,
                  generator=torch.Generator().manual_seed(11)).eval()


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(the saved directory, the dygraph model of its weights)."""
    model = _model()
    d = str(tmp_path_factory.mktemp("static_resnet"))
    static.enable_static()
    static.reset_default_programs()
    try:
        _, logits = chip_smoke.build_static_resnet(static, ops, stages=STAGES, classes=CLASSES,
                                                   hw=HW)
        scope = static.Scope()
        prog = static.default_main_program()
        chip_smoke.carry_resnet_weights(model, prog, scope)
        static.save_inference_model(d, ["image"], [logits], static.Executor("cpu"),
                                    main_program=prog.clone(for_test=True), scope=scope)
    finally:
        static.disable_static()
        static.reset_default_programs()
    return d, model


def _images(rows, seed=3):
    return np.random.RandomState(seed).randn(rows, 3, HW, HW).astype(np.float32)


def _rel(got, want):
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("level", [0, 1])
def test_both_predictors_answer_as_the_dygraph_model(saved, level):
    d, model = saved
    x = _images(3)
    want = Predictor(model, [InputSpec([None, 3, HW, HW], "float32", "image")], ["logits"],
                     device="cpu").run([x])[0]
    set_flags({"ir_opt_level": level})
    jset_flags({"ir_opt_level": level})
    pred = create_predictor(Config(d), device="cpu")
    got = pred.run([x])[0]
    jgot = np.asarray(jcreate_predictor(JConfig(d)).run([x])[0])
    assert _rel(got, want) <= RN_RTOL and _rel(jgot, want) <= RN_RTOL
    ran = pred._exe.gate(pred._program, ["image"], pred.get_output_names(),
                         {"image": x.shape})[0]
    types = [op.type for op in ran.global_block().ops]
    assert types.count("fused_conv_bn_relu") == (FUSED if level else 0)
    assert types.count("conv2d") == (PAIRS if level else FUSED + PAIRS)


def test_both_optimizers_rewrite_the_saved_program_alike(saved):
    d, _ = saved
    port, jax_ = create_predictor(Config(d), device="cpu"), jcreate_predictor(JConfig(d))
    fetch = port.get_output_names()
    progs = {}
    for pkg, prog, opt in (("port", port._program, optimize_program),
                           ("jax", jax_._program, joptimize_program)):
        res = opt(prog, ["image"], fetch, level=1)
        stats = {s.name: s.ops_rewritten for s in res.stats}
        assert stats["fuse_conv_bn_relu"] == FUSED and stats["fuse_layernorm_residual"] == 0
        progs[pkg] = res.program
    lists = {pkg: [(op.type, dict(op.inputs), dict(op.outputs), {
        k: (list(v) if isinstance(v, tuple) else v) for k, v in op.attrs.items()})
        for op in p.global_block().ops] for pkg, p in progs.items()}
    assert lists["port"] == lists["jax"]
    shapes = {"image": (2, 3, HW, HW)}
    plan = plan_memory(progs["port"], ["image"], fetch, feed_shapes=shapes)
    jplan = jplan_memory(progs["jax"], ["image"], fetch, feed_shapes=shapes)
    assert (plan.peak_bytes, plan.peak_op_index, plan.baseline_bytes, plan.resident_bytes) == (
        jplan.peak_bytes, jplan.peak_op_index, jplan.baseline_bytes, jplan.resident_bytes)


def test_full_width_resnet50_has_the_chains_the_chip_check_counts():
    """The chip check's own program at 224 x 224 and 1000 classes, built and
    optimized but not run: 33 chains fused, 20 conv + bn pairs left, the
    verifier clean, a plan at each serving bucket."""
    static.enable_static()
    static.reset_default_programs()
    _, logits = chip_smoke.build_static_resnet(static, ops)
    prog = static.default_main_program().clone(for_test=True)
    static.disable_static()
    assert prog.verify(feed_names=["image"], fetch_list=[logits.name]).ok
    for b in chip_smoke.RN_BUCKETS:
        shapes = {"image": (b, 3, chip_smoke.RN_HW, chip_smoke.RN_HW)}
        res = optimize_program(prog, ["image"], [logits.name], level=1, feed_shapes=shapes)
        types = [op.type for op in res.program.global_block().ops]
        assert types.count("fused_conv_bn_relu") == chip_smoke.RN_TRIPLES == 33
        assert types.count("conv2d") == types.count("batch_norm") == chip_smoke.RN_UNFUSED_PAIRS
        plan = plan_memory(res.program, ["image"], [logits.name], feed_shapes=shapes)
        assert plan.peak_bytes > plan.baseline_bytes > 25e6 * 4  # 25.6 M f32 parameters


def _train(level, budget=None, check="strict"):
    """The narrow training program, 2 Momentum steps from fixed weights at
    IR ``level`` (under ``budget`` and ``check``): (losses, the program, the
    program the executor ran)."""
    model = _model()
    rng = np.random.RandomState(8)
    batches = [{"image": _images(4, seed=s), "label": rng.randint(0, CLASSES, (4, 1))
                .astype(np.int64)} for s in (1, 2)]
    static.enable_static()
    static.reset_default_programs()
    try:
        _, _, _, loss = chip_smoke.build_static_resnet(static, ops, stages=STAGES,
                                                       classes=CLASSES, hw=HW, batch=4,
                                                       train=True)
        static.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
        prog = static.default_main_program()
        scope, exe = static.Scope(), static.Executor("cpu")
        exe.run_startup(scope=scope)
        chip_smoke.carry_resnet_weights(model, prog, scope)
        flags = {"ir_opt_level": level}
        if budget is not None:
            flags.update(device_peaks=f"hbm_bytes={budget}", memory_budget_check=check)
        set_flags(flags)
        losses = [float(exe.run(prog, feed=b, fetch_list=[loss], scope=scope)[0])
                  for b in batches]
        shapes = {n: a.shape for n, a in batches[0].items()}
        ran = exe.gate(prog, list(shapes), [loss.name], shapes)[0]
        return losses, prog, ran
    finally:
        set_flags({"ir_opt_level": 1, "device_peaks": "", "memory_budget_check": "warn"})
        static.disable_static()
        static.reset_default_programs()


def test_training_program_comes_back_unchanged_and_trains_alike_at_level_2():
    """Every chain of a training program is read by a ``grad::`` replay, so
    level 1 fuses nothing and returns the program itself; level 2 (remat)
    may recompute activations but leaves the losses bit-equal."""
    losses1, prog, ran1 = _train(1)
    assert ran1 is prog  # nothing rewritten: the original object
    with pytest.warns(RuntimeWarning, match="over_budget"):  # admitted, as far as remat cuts
        losses2, _, ran2 = _train(2, budget=1, check="warn")
    assert losses2 == losses1 and all(np.isfinite(losses1))
    assert [op.type for op in ran2.global_block().ops if "@remat" not in str(op.outputs)] == [
        op.type for op in ran1.global_block().ops]
