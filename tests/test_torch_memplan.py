"""The port's memory planner against the JAX package's.

The counterparts of ``tests/test_memplan.py``: golden programs built alike
in both packages must get the same plan, byte for byte (peak, high-water op,
baseline, the resident curve); the donation-safety findings name the same
op and var; the executor's strict admission refuses before anything runs.
The JAX file's closure against XLA's ``memory_analysis`` has its port
counterpart in ``note_actual`` over the card's measured peak, held here on
given numbers (the CPU measures none); its ``alias_bytes`` test has no
counterpart (the port's executor donates nothing: persistables are copied
back into the scope) and its flight-recorder test waits for the port's
flight recorder (ROADMAP.md).
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu.static as jstatic  # noqa: E402
from paddle_tpu import ops as jops  # noqa: E402
from paddle_tpu.analysis import plan_memory as jplan_memory  # noqa: E402
from paddle_tpu.flags import set_flags as jset_flags  # noqa: E402
from paddle_tpu.static.control_flow import while_loop as jwhile_loop  # noqa: E402

from paddle_tpu_torch import ops, profiler, static  # noqa: E402
from paddle_tpu_torch.analysis import (  # noqa: E402
    DonationError,
    MemoryBudgetError,
    accuracy_records,
    check_memory_budget,
    hbm_budget_bytes,
    note_actual,
    plan_memory,
)
from paddle_tpu_torch.analysis import memory as memmod  # noqa: E402
from paddle_tpu_torch.flags import set_flags  # noqa: E402
from paddle_tpu_torch.static.control_flow import while_loop  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = 4
PACKAGES = {"port": (static, ops, plan_memory, while_loop),
            "jax": (jstatic, jops, jplan_memory, jwhile_loop)}


@pytest.fixture(autouse=True)
def _static_reset():
    for st, _, _, _ in PACKAGES.values():
        st.enable_static()
        st.reset_default_programs()
        st.global_scope().clear()
    yield
    set_flags({"memory_budget_check": "warn", "device_peaks": ""})
    jset_flags({"memory_budget_check": "warn", "device_peaks": ""})
    for st, _, _, _ in PACKAGES.values():
        st.disable_static()
        st.reset_default_programs()
        st.global_scope().clear()


def _same_plan(port, jax):
    """Two plans agree on every number they carry. A captured constant is
    named ``const<N>_<i>`` by a per-package, per-process counter, so names
    compare modulo ``<N>``."""
    def name(n):
        return re.sub(r"^const\d+_", "const_", n) if n else n

    assert (port.peak_bytes, port.peak_op_index, port.peak_op_type, port.baseline_bytes) == (
        jax.peak_bytes, jax.peak_op_index, jax.peak_op_type, jax.baseline_bytes)
    assert port.resident_bytes == jax.resident_bytes
    assert sorted((name(n), b) for n, b, _ in port.top_tensors) == sorted(
        (name(n), b) for n, b, _ in jax.top_tensors)
    assert [(f.kind, f.op_index, name(f.var)) for f in port.findings] == [
        (f.kind, f.op_index, name(f.var)) for f in jax.findings]


def _straightline(st, o):
    """x[4,8] @ w[8,8] -> relu -> mean; every byte hand-countable."""
    x = st.data("x", [4, 8], "float32")
    w = st.nn.create_parameter([8, 8], "float32")
    h = o.matmul(x, w)
    r = o.relu(h)
    m = o.mean(r)
    return x, w, h, r, m


def _plans(build, **kw):
    """``build(static, ops)`` in each package; returns {pkg: plan}."""
    out = {}
    for pkg, (st, o, plan, _) in PACKAGES.items():
        fetch = build(st, o)
        out[pkg] = st.default_main_program().plan_memory(fetch_list=fetch, **kw)
    return out


# -- golden peaks: the exact high-water op and byte count --------------------------------


def test_straightline_peak_exact():
    plans = _plans(lambda st, o: [_straightline(st, o)[-1]], feed_names=["x"],
                   feed_shapes={"x": (4, 8)})
    plan = plans["port"]
    base = 4 * 8 * F32 + 8 * 8 * F32  # x (128) + w (256)
    assert plan.baseline_bytes == base
    # op0 matmul: +h (128); op1 relu: h still live + r (256); op2 mean: r + o (4)
    assert plan.resident_bytes == [base + 128, base + 256, base + 132]
    assert plan.peak_bytes == base + 256
    assert (plan.peak_op_index, plan.peak_op_type) == (1, "relu")
    assert not plan.errors
    names = [(n, b) for n, b, _src in plan.top_tensors]
    assert ("param_0", 256) in names and ("x", 128) in names
    _same_plan(plan, plans["jax"])


def test_advisor_flags_donation_eligible_dead_input():
    def build(st, o):
        _x, _w, h, r, _m = _straightline(st, o)
        build.names = (h.name, r.name)
        return [r.name]

    plans = _plans(build, feed_names=["x"], feed_shapes={"x": (4, 8)})
    h, r = build.names
    adv = plans["port"].advisories
    # h dies at the relu, whose output matches it and declares no aliasing
    assert any(f.kind == "donation-eligible" and f.var == h and f.op_index == 1 for f in adv)
    assert not any(f.var == r for f in adv)  # r is fetched: never advised away
    _same_plan(plans["port"], plans["jax"])


def _sgd_program(st):
    p = st.Program()
    b = p.global_block()
    b.create_var(name="p", shape=[8, 8], dtype="float32", persistable=True)
    b.create_var(name="g", shape=[8, 8], dtype="float32", is_data=True)
    b.create_var(name="lr", shape=[], dtype="float32", persistable=True)
    b.append_op("sgd", {"X": ["p", "g", "lr"]}, {"Out": ["p"]}, {"__inplace__": ["p"]})
    return p


def test_inplace_update_not_double_counted():
    plan = plan_memory(_sgd_program(static), feed_names=["g"], feed_shapes={"g": (8, 8)})
    base = 256 + 256 + 4  # p + g + lr; the in-place write adds nothing
    assert plan.baseline_bytes == base and plan.resident_bytes == [base]
    assert plan.peak_bytes == base and not plan.errors
    _same_plan(plan, jplan_memory(_sgd_program(jstatic), feed_names=["g"],
                                  feed_shapes={"g": (8, 8)}))


def test_while_subblock_peak_exact():
    def build(st, o):
        loop = PACKAGES["port" if st is static else "jax"][3]
        x = st.data("x", [4, 4], "float32")
        w = st.nn.create_parameter([4, 4], "float32")
        m = o.matmul(x, w)
        iv = o.zeros([], "int32")

        def cond(i, c):
            return o.less_than(i, np.asarray(3, "int32"))

        def body(i, c):
            t = o.matmul(c, w)
            return o.add(i, np.asarray(1, "int32")), o.relu(t)

        return [loop(cond, body, [iv, m])[1]]

    plans = _plans(build, feed_names=["x"], feed_shapes={"x": (4, 4)})
    plan = plans["port"]
    # x (64) + w (64) + three captured int32 scalars (the init, the limit, the step)
    base = 64 + 64 + 12
    assert plan.baseline_bytes == base
    body_peak = 64 + 4 + 64  # the body's own: t, the add's output, the relu's
    assert plan.resident_bytes == [base + 64, base + 64 + 4 + 64 + body_peak]
    assert (plan.peak_op_index, plan.peak_op_type) == (1, "while")
    _same_plan(plan, plans["jax"])


# -- donation safety -----------------------------------------------------------------------


def _donated_then_read_program(st):
    p = st.Program()
    b = p.global_block()
    b.create_var(name="v", shape=[4], dtype="float32", is_data=True)
    b.create_var(name="w", shape=[4], dtype="float32")
    b.create_var(name="z", shape=[4], dtype="float32")
    # op0 consumes v's buffer into the differently-named w; op1 reads v
    b.append_op("relu", {"X": ["v"]}, {"Out": ["w"]}, {"__inplace__": ["v"]})
    b.append_op("tanh", {"X": ["v"]}, {"Out": ["z"]}, {})
    return p


def test_donated_then_read_golden():
    kw = dict(feed_names=["v"], fetch_names=["z"], feed_shapes={"v": (4,)})
    plan = plan_memory(_donated_then_read_program(static), **kw)
    errs = [f for f in plan.errors if f.kind == "donated-then-read"]
    assert len(errs) == 1 and (errs[0].op_index, errs[0].op_type, errs[0].var) == (1, "tanh", "v")
    with pytest.raises(DonationError) as ei:
        plan.raise_if_unsafe()
    assert (ei.value.op_index, ei.value.op_type, ei.value.var) == (1, "tanh", "v")
    _same_plan(plan, jplan_memory(_donated_then_read_program(jstatic), **kw))


def test_executor_strict_rejects_donated_then_read():
    set_flags({"memory_budget_check": "strict"})
    exe = static.Executor("cpu")
    with pytest.raises(DonationError):
        exe.run(_donated_then_read_program(static), feed={"v": np.ones(4, "f")},
                fetch_list=["z"])
    assert exe.store.misses == 0 and not exe._drops_of  # refused before it ran


def test_fetching_a_donated_buffer_is_rejected():
    p = static.Program()
    b = p.global_block()
    b.create_var(name="v", shape=[4], dtype="float32", is_data=True)
    b.create_var(name="w", shape=[4], dtype="float32")
    b.append_op("relu", {"X": ["v"]}, {"Out": ["w"]}, {"__inplace__": ["v"]})
    plan = plan_memory(p, feed_names=["v"], fetch_names=["v"], feed_shapes={"v": (4,)})
    assert any(f.kind == "donated-then-read" and f.var == "v" for f in plan.errors)


def test_grad_op_inherited_inplace_is_not_a_donation():
    """``append_backward`` copies the forward's attributes (its
    ``__inplace__`` too) onto the ``grad::`` op, which aliases nothing: a
    batch-norm training program reads as safe."""
    def build(st, o):
        x = st.data("x", [8, 6], "float32")
        label = st.data("y", [8, 6], "float32")
        h = st.nn.batch_norm(x)
        loss = o.mean(o.square(o.subtract(h, label)))
        st.optimizer.Momentum(learning_rate=0.01).minimize(loss)
        return [loss]

    plans = _plans(build, feed_names=["x", "y"], feed_shapes={"x": (8, 6), "y": (8, 6)})
    assert not plans["port"].errors
    _same_plan(plans["port"], plans["jax"])


def test_same_name_inplace_chain_stays_legal():
    p = static.Program()
    b = p.global_block()
    b.create_var(name="s", shape=[4], dtype="float32", persistable=True)
    b.create_var(name="o", shape=[4], dtype="float32")
    b.append_op("relu", {"X": ["s"]}, {"Out": ["s"]}, {"__inplace__": ["s"]})
    b.append_op("tanh", {"X": ["s"]}, {"Out": ["o"]}, {})
    assert not plan_memory(p, fetch_names=["o"]).errors


# -- executor admission: budget verdicts and caching ---------------------------------------


def _run_straightline(exe=None):
    *_, o = _straightline(static, ops)
    exe = exe or static.Executor("cpu")
    exe.run_startup()
    out = exe.run(feed={"x": np.ones((4, 8), "f")}, fetch_list=[o])
    return exe, float(np.asarray(out[0])), o


def test_strict_budget_rejection_names_high_water_op():
    *_, o = _straightline(static, ops)
    set_flags({"device_peaks": "hbm_bytes=500", "memory_budget_check": "strict"})
    exe = static.Executor("cpu")
    exe.run_startup()
    with pytest.raises(MemoryBudgetError) as ei:
        exe.run(feed={"x": np.ones((4, 8), "f")}, fetch_list=[o])
    e = ei.value
    assert e.op_index == 1 and e.op_type == "relu"
    assert e.peak_bytes == 640 and e.budget_bytes == 500
    assert "relu" in str(e) and "param_0" in str(e)
    assert exe.store.misses == 0 and not exe._drops_of  # refused before it ran


def test_baseline_over_budget_still_names_tensors():
    p = static.Program()
    b = p.global_block()
    b.create_var(name="big_w", shape=[64, 64], dtype="float32", persistable=True)
    plan = plan_memory(p, fetch_names=["big_w"])
    assert plan.peak_op_index is None
    assert plan.peak_bytes == plan.baseline_bytes == 64 * 64 * F32
    assert any(n == "big_w" for n, _b, _s in plan.top_tensors)
    with pytest.raises(MemoryBudgetError) as ei:
        check_memory_budget(p, (), ["big_w"], level="strict", budget_bytes=1000)
    assert "baseline" in str(ei.value) and "big_w" in str(ei.value)
    assert "None" not in str(ei.value)


def test_warn_mode_admits_with_a_warning():
    *_, o = _straightline(static, ops)
    set_flags({"device_peaks": "hbm_bytes=500", "memory_budget_check": "warn"})
    exe = static.Executor("cpu")
    exe.run_startup()
    profiler.reset_counters()
    with pytest.warns(RuntimeWarning, match="over_budget"):
        out = exe.run(feed={"x": np.ones((4, 8), "f")}, fetch_list=[o])
    assert np.isfinite(float(np.asarray(out[0])))
    assert profiler.counters().get("memplan::verdict::over_budget") == 1


def test_verdict_caches_per_program_version():
    profiler.reset_counters()
    exe, _loss, o = _run_straightline()
    for _ in range(3):
        exe.run(feed={"x": np.ones((4, 8), "f")}, fetch_list=[o])
    c = profiler.counters()
    assert c.get("memplan::cache_miss", 0) == 1 and c.get("memplan::cache_hit", 0) >= 3
    assert len(static.default_main_program()._memplan_cache) == 1


def test_off_mode_skips_planning_entirely():
    profiler.reset_counters()
    set_flags({"memory_budget_check": "off"})
    _exe, loss, _o = _run_straightline()
    assert np.isfinite(loss)
    c = profiler.counters()
    assert c.get("memplan::cache_miss", 0) == 0 and c.get("memplan::cache_hit", 0) == 0


def test_plan_accuracy_closure():
    """``note_actual`` over a measured run (on the card the executor
    measures one at each signature's first run): the ratio, the gauge and
    the records; ``measured_peak`` adds the plan's resident baseline to the
    bytes the run allocated above its start."""
    from paddle_tpu_torch.monitor import registry as reg

    *_, o = _straightline(static, ops)
    plan = static.default_main_program().plan_memory(["x"], [o], feed_shapes={"x": (4, 8)})
    actual, transient = memmod.measured_peak(1000, 1000 + 300, plan)
    assert (actual, transient) == (plan.baseline_bytes + 300, 300)
    ratio = note_actual(memmod.MeasuredRun("sig", "executor", actual, transient), plan)
    assert ratio == pytest.approx(640 / (384 + 300))
    rec = accuracy_records()[-1]
    assert rec["predicted_bytes"] == 640 and rec["actual_bytes"] == 684
    assert rec["predicted_transient_bytes"] == 256 and rec["actual_transient_bytes"] == 300
    assert reg.gauge("memplan/plan_accuracy").value == pytest.approx(ratio)
    assert note_actual(None, plan) is None


def test_training_program_plans_like_the_jax_package():
    """An Adam step at its feed shapes: the same plan in both packages (the
    JAX file holds this one against XLA's actual; the card measures the
    port's in the chip check)."""
    def build(st, o):
        x = st.data("x", [32, 64], "float32")
        y = st.data("y", [32, 1], "float32")
        w = st.nn.create_parameter([64, 1], "float32")
        loss = o.mean(o.square(o.subtract(o.matmul(x, w), y)))
        st.optimizer.Adam(learning_rate=0.01).minimize(loss)
        return [loss]

    plans = _plans(build, feed_names=["x", "y"], feed_shapes={"x": (32, 64), "y": (32, 1)})
    _same_plan(plans["port"], plans["jax"])
    assert plans["port"].peak_bytes > plans["port"].baseline_bytes


def test_unresolved_batch_dim_degrades_to_warning():
    x = static.data("x", [-1, 8], "float32")
    w = static.nn.create_parameter([8, 8], "float32")
    h = ops.matmul(x, w)
    prog = static.default_main_program()
    plan = prog.plan_memory(feed_names=["x"], fetch_list=[h.name])
    assert "x" in plan.unresolved
    assert any(f.kind == "unresolved-shape" for f in plan.warnings)
    plan2 = prog.plan_memory(feed_names=["x"], fetch_list=[h.name], feed_shapes={"x": (16, 8)})
    assert not plan2.unresolved
    assert plan2.baseline_bytes == 16 * 8 * F32 + 256


def test_check_memory_budget_inconclusive_never_blocks(monkeypatch):
    p = static.Program()
    b = p.global_block()
    b.create_var(name="v", shape=[4], dtype="float32", is_data=True)
    b.create_var(name="o", shape=[4], dtype="float32")
    b.append_op("relu", {"X": ["v"]}, {"Out": ["o"]}, {})

    def boom(*a, **k):
        raise RuntimeError("planner bug")

    monkeypatch.setattr(memmod, "plan_memory", boom)
    kw = dict(feed_shapes={"v": (4,)}, level="strict", budget_bytes=1)
    assert check_memory_budget(p, ["v"], ["o"], **kw) is None
    profiler.reset_counters()
    assert check_memory_budget(p, ["v"], ["o"], **kw) is None
    assert profiler.counters().get("memplan::cache_hit", 0) == 1


def test_budget_is_the_flag_or_the_card():
    """``hbm_budget_bytes``: 0 (inconclusive) on the CPU, the card's memory
    on a CUDA device, ``FLAGS_device_peaks`` ``hbm_bytes=`` over both."""
    assert hbm_budget_bytes("cpu") == 0
    set_flags({"device_peaks": "flops=1e12, hbm_bytes=12345,bogus=3"})
    assert hbm_budget_bytes("cpu") == hbm_budget_bytes() == 12345
    set_flags({"device_peaks": ""})
    plan = plan_memory(_sgd_program(static), feed_names=["g"], feed_shapes={"g": (8, 8)})
    # a budget of 0 never refuses, whatever the plan
    assert check_memory_budget(_sgd_program(static), ["g"], (), feed_shapes={"g": (8, 8)},
                               level="strict", budget_bytes=0).peak_bytes == plan.peak_bytes


# -- capacity consumers: the generation engine ----------------------------------------------


@pytest.fixture(scope="module")
def tiny_gpt():
    from paddle_tpu_torch import models

    cfg = models.gpt_tiny_config()
    cfg.attention_window = 16
    return models.GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(7)).eval()


def _engine(model, **kw):
    from paddle_tpu_torch.generation import GenerationEngine

    return GenerationEngine(model, slots=2, cache_len=16, prefill_buckets="4,8", device="cpu",
                            **kw)


def test_suggest_decode_slots_arithmetic(tiny_gpt):
    eng = _engine(tiny_gpt)
    assert eng.hbm_required_bytes() == eng.param_nbytes() + eng.cache_nbytes()
    budget = eng.param_nbytes() + 3 * eng.slot_nbytes()
    assert eng.suggest_decode_slots(budget) == 3
    assert eng.suggest_decode_slots(budget, "int8") > 3
    assert eng.suggest_decode_slots(eng.param_nbytes() - 1) == 0
    set_flags({"device_peaks": f"hbm_bytes={budget}"})
    assert eng.suggest_decode_slots() == 3  # the flag's budget, on the CPU too


def test_generation_geometry_refused_when_over_budget(tiny_gpt):
    from paddle_tpu_torch import generation
    from paddle_tpu_torch.serving.server import GenerationServer

    assert generation.MemoryBudgetError is MemoryBudgetError  # one class, as in JAX
    set_flags({"device_peaks": "hbm_bytes=1000", "memory_budget_check": "strict"})
    with pytest.raises(MemoryBudgetError) as ei:
        _engine(tiny_gpt)
    assert "suggest_decode_slots" in str(ei.value) and "2 slot(s)" in str(ei.value)
    with pytest.raises(MemoryBudgetError):
        GenerationServer(tiny_gpt, slots=2, cache_len=16, prefill_buckets="4,8", device="cpu")
    set_flags({"memory_budget_check": "warn"})
    with pytest.warns(RuntimeWarning, match="suggest_decode_slots"):
        eng = _engine(tiny_gpt)
    assert eng.slots == 2


def test_backend_cli_refuses_a_geometry_that_does_not_fit(tiny_gpt, tmp_path):
    """The backend process exits 2 with the refusal on stderr, as the JAX
    CLI does, before it serves anything."""
    from paddle_tpu_torch import models

    gpt_dir = models.save_gpt_model(tiny_gpt, str(tmp_path / "gpt"))
    env = dict(os.environ, FLAGS_device_peaks="hbm_bytes=1000",
               FLAGS_memory_budget_check="strict", PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.serving.backend", "--kind", "generate",
         "--gpt-dir", gpt_dir, "--slots", "2", "--cache-len", "16", "--prefill-buckets", "4,8",
         "--device", "cpu", "--port-file", str(tmp_path / "port")],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert r.returncode == 2, r.stderr[-2000:]
    assert "backend refused" in r.stderr and "suggest_decode_slots" in r.stderr
    assert not (tmp_path / "port").exists()
