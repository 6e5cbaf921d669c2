"""The port's program-IR verifier against the JAX package's.

The counterparts of ``tests/test_analysis.py``'s verifier tests (not its
lint and waiver tests: the port has no AST lint yet; nor its flight-recorder
test: the port has no flight recorder yet). Each known-bad golden program
is built alike in both packages, and the port's :class:`VerifyError` must
name what the JAX package's names: the same pass, block, op index, op type
and variable. The executor's gate raises before anything is interpreted or
captured; the verdict is cached per program version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu.static as jstatic  # noqa: E402
from paddle_tpu import ops as jops  # noqa: E402
from paddle_tpu.analysis import VerifyError as JVerifyError  # noqa: E402
from paddle_tpu.analysis import verifier_passes as jverifier_passes  # noqa: E402
from paddle_tpu.flags import set_flags as jset_flags  # noqa: E402

from paddle_tpu_torch import ops, static  # noqa: E402
from paddle_tpu_torch.analysis import VerifyError, verifier_passes, verify_program  # noqa: E402
from paddle_tpu_torch.errors import EnforceNotMet  # noqa: E402
from paddle_tpu_torch.flags import set_flags  # noqa: E402

PACKAGES = {"port": (static, ops, VerifyError), "jax": (jstatic, jops, JVerifyError)}


@pytest.fixture(autouse=True)
def _static_reset():
    for st, _, _ in PACKAGES.values():
        st.reset_default_programs()
        st.global_scope().clear()
    yield
    set_flags({"program_verify": "on"})
    jset_flags({"program_verify": "on"})
    for st, _, _ in PACKAGES.values():
        st.disable_static()
        st.reset_default_programs()
        st.global_scope().clear()


def _feedable(block, name, shape, dtype="float32"):
    return block.create_var(name=name, shape=shape, dtype=dtype, is_data=True)


def _where(e):
    return (e.pass_name, e.block_idx, e.op_index, e.op_type, e.var)


def _both_raise(build, feed_names, fetch, level="on"):
    """Build the program with each package's ``static`` and verify it; both
    must raise. Returns the port's error after checking it names what the
    JAX package's does."""
    errs = {}
    for pkg, (st, _, err) in PACKAGES.items():
        with pytest.raises(err) as ei:
            build(st).verify(feed_names=feed_names, fetch_list=fetch, level=level)
        errs[pkg] = ei.value
    assert _where(errs["port"]) == _where(errs["jax"])
    return errs["port"]


def _ok_both(build, feed_names, fetch, level="on"):
    reports = {pkg: build(st).verify(feed_names=feed_names, fetch_list=fetch, level=level)
               for pkg, (st, _, _) in PACKAGES.items()}
    assert reports["port"].ok and reports["jax"].ok
    warn = {pkg: [(f.pass_name, f.op_index, f.op_type, f.var) for f in r.warnings]
            for pkg, r in reports.items()}
    assert warn["port"] == warn["jax"]
    return reports["port"]


def _nothing_ran(exe):
    """Nothing was interpreted or captured: no graph, no liveness table, no
    while-scan of the program."""
    return exe.store.misses == 0 and not exe._drops_of and not exe._while_of


# -- verifier goldens: one known-bad program per pass, the same op and var named -----------


def _undefined(st):
    p = st.Program()
    b = p.global_block()
    _feedable(b, "x", [2])
    b.create_var(name="h", shape=[2], dtype="float32")
    b.create_var(name="o", shape=[2], dtype="float32")
    b.append_op("relu", {"X": ["x"]}, {"Out": ["h"]}, {})
    b.append_op("tanh", {"X": ["ghost"]}, {"Out": ["o"]}, {})
    return p


def test_undefined_input_names_op_and_var():
    e = _both_raise(_undefined, ["x"], ["o"])
    assert _where(e) == ("def-before-use", 0, 1, "tanh", "ghost")
    assert "ghost" in str(e)


def test_executor_raises_before_any_lowering():
    p = static.Program()
    b = p.global_block()
    _feedable(b, "x", [2])
    b.create_var(name="o", shape=[2], dtype="float32")
    b.append_op("relu", {"X": ["nope"]}, {"Out": ["o"]}, {})
    exe = static.Executor("cpu")
    with pytest.raises(VerifyError):
        exe.run(p, feed={"x": np.ones(2, "f")}, fetch_list=["o"])
    assert _nothing_ran(exe)


def _dtype_mismatch(st):
    p = st.Program()
    b = p.global_block()
    _feedable(b, "i", [2], "int32")
    # declared float32, but the cast to int64 produces an integer
    b.create_var(name="o", shape=[2], dtype="float32")
    b.append_op("cast", {"X": ["i"]}, {"Out": ["o"]}, {"dtype": "int64"})
    return p


def test_dtype_mismatch_names_op_and_var():
    e = _both_raise(_dtype_mismatch, ["i"], ["o"])
    assert _where(e) == ("dtype-consistency", 0, 0, "cast", "o")
    assert "int64" in str(e) and "float32" in str(e)


def _unknown_op(st):
    p = st.Program()
    b = p.global_block()
    _feedable(b, "i", [2])
    b.create_var(name="o", shape=[2], dtype="float32")
    b.append_op("no_such_kernel", {"X": ["i"]}, {"Out": ["o"]}, {})
    return p


def test_unknown_op_type_is_an_error():
    e = _both_raise(_unknown_op, ["i"], ["o"])
    assert e.pass_name == "dtype-consistency" and e.op_type == "no_such_kernel"


def _double_write(st):
    p = st.Program()
    b = p.global_block()
    _feedable(b, "i", [2])
    b.create_var(name="o", shape=[2], dtype="float32")
    b.append_op("relu", {"X": ["i"]}, {"Out": ["o"]}, {})
    b.append_op("tanh", {"X": ["i"]}, {"Out": ["o"]}, {})
    return p


def test_double_write_names_second_writer():
    e = _both_raise(_double_write, ["i"], ["o"])
    assert _where(e)[1:] == (0, 1, "tanh", "o") and e.pass_name == "write-conflicts"
    assert "op #0" in str(e)  # the first writer is named too


def test_undeclared_inplace_flagged_declared_accepted():
    def build(declare):
        def make(st):
            p = st.Program()
            b = p.global_block()
            s = b.create_var(name="step", shape=[], dtype="float32", persistable=True)
            assert s.persistable
            attrs = {"value": 1.0}
            if declare:
                attrs["__inplace__"] = ["step"]
            b.append_op("increment", {"X": ["step"]}, {"Out": ["step"]}, attrs)
            return p
        return make

    e = _both_raise(build(False), [], ["step"])
    assert e.pass_name == "write-conflicts" and e.var == "step"
    assert "__inplace__" in str(e)
    assert _ok_both(build(True), [], ["step"]).ok


def _dead_op(st):
    p = st.Program()
    b = p.global_block()
    _feedable(b, "i", [2])
    b.create_var(name="o", shape=[2], dtype="float32")
    b.create_var(name="junk", shape=[2], dtype="float32")
    b.append_op("relu", {"X": ["i"]}, {"Out": ["o"]}, {})
    b.append_op("tanh", {"X": ["i"]}, {"Out": ["junk"]}, {})
    return p


def test_dead_op_warns_by_default_errors_in_strict():
    rep = _ok_both(_dead_op, ["i"], ["o"])
    dead = [w for w in rep.warnings if w.pass_name == "dead-code"]
    assert dead and dead[0].op_index == 1 and dead[0].var == "junk"
    e = _both_raise(_dead_op, ["i"], ["o"], level="strict")
    assert _where(e) == ("dead-code", 0, 1, "tanh", "junk")


def test_dead_op_strict_through_executor_flag():
    p = _dead_op(static)
    exe = static.Executor("cpu")
    # default level: the dead op is advisory, the program runs
    out = exe.run(p, feed={"i": np.ones(2, "f")}, fetch_list=["o"])
    assert np.asarray(out[0]).shape == (2,)
    set_flags({"program_verify": "strict"})
    with pytest.raises(VerifyError):
        exe.run(p, feed={"i": np.ones(2, "f")}, fetch_list=["o"])


def _bad_subblock(st):
    p = st.Program()
    b = p.global_block()
    _feedable(b, "pred", [], "float32")
    b.create_var(name="o", shape=[], dtype="float32")
    b.append_op("cond", {"X": ["pred"]}, {"Out": ["o"]},
                {"__true_block__": 7, "__false_block__": 1,
                 "__true_outs__": ["t"], "__false_outs__": ["f"]})
    return p


def test_malformed_subblock_golden():
    e = _both_raise(_bad_subblock, ["pred"], ["o"])
    assert e.pass_name == "block-structure" and (e.op_index, e.op_type) == (0, "cond")
    assert "__true_block__=7" in str(e)


def _missing_formal(st):
    p = st.Program()
    b = p.global_block()
    _feedable(b, "x", [2])
    b.create_var(name="o", shape=[2], dtype="float32")
    sub = p._create_block()
    # the sub-block exists but never declares the formal the op names
    b.append_op("while", {"X": ["x"]}, {"Out": ["o"]},
                {"__cond_block__": sub.idx, "__body_block__": sub.idx,
                 "__cond_formals__": ["phantom_formal"],
                 "__body_formals__": ["phantom_formal"],
                 "__cond_out__": "pred", "__body_outs__": ["phantom_formal"],
                 "__n_loop__": 1})
    return p


def test_subblock_missing_formal_golden():
    e = _both_raise(_missing_formal, ["x"], ["o"])
    assert e.pass_name == "block-structure" and e.var == "phantom_formal"


def _relu_of_i(st):
    p = st.Program()
    b = p.global_block()
    _feedable(b, "i", [2])
    b.create_var(name="o", shape=[2], dtype="float32")
    b.append_op("relu", {"X": ["i"]}, {"Out": ["o"]}, {})
    return p


def test_fetch_never_produced():
    e = _both_raise(_relu_of_i, ["i"], ["never_made"])
    assert e.pass_name == "def-before-use" and e.var == "never_made"


def _golden_undefined(st):
    p = st.Program()
    b = p.global_block()
    _feedable(b, "i", [2])
    b.create_var(name="o", shape=[2], dtype="float32")
    b.append_op("relu", {"X": ["nope"]}, {"Out": ["o"]}, {})
    return p, "def-before-use", "nope"


def _golden_dtype(st):
    p = _dtype_mismatch(st)
    return p, "dtype-consistency", "o"


def _golden_double_write(st):
    return _double_write(st), "write-conflicts", "o"


def _golden_bad_subblock(st):
    p = st.Program()
    b = p.global_block()
    _feedable(b, "i", [], "float32")
    b.create_var(name="o", shape=[], dtype="float32")
    b.append_op("cond", {"X": ["i"]}, {"Out": ["o"]},
                {"__true_block__": 9, "__false_block__": 9,
                 "__true_outs__": ["t"], "__false_outs__": ["f"]})
    return p, "block-structure", None


def _golden_dead_op(st):
    return _dead_op(st), "dead-code", "junk"


@pytest.mark.parametrize("golden", [
    _golden_undefined, _golden_dtype, _golden_double_write,
    _golden_bad_subblock, _golden_dead_op,
], ids=["undefined-input", "dtype-mismatch", "double-write", "malformed-subblock", "dead-op"])
def test_every_golden_fails_through_executor_before_lowering(golden):
    """``Executor.run`` on each known-bad golden raises a VerifyError naming
    the op and var the JAX executor's names, before anything ran."""
    p, expect_pass, expect_var = golden(static)
    jp, _, _ = golden(jstatic)
    if expect_pass == "dead-code":
        set_flags({"program_verify": "strict"})
        jset_flags({"program_verify": "strict"})
    exe = static.Executor("cpu")
    with pytest.raises(VerifyError) as ei:
        exe.run(p, feed={"i": np.zeros(2, "f")}, fetch_list=["o"])
    with pytest.raises(JVerifyError) as jei:
        jstatic.Executor().run(jp, feed={"i": np.zeros(2, "f")}, fetch_list=["o"])
    assert _where(ei.value) == _where(jei.value)
    assert ei.value.pass_name == expect_pass
    if expect_var is not None:
        assert ei.value.var == expect_var
    assert ei.value.op_index is not None and ei.value.op_type
    assert _nothing_ran(exe)


# -- the verifier on layer-helper output: aliasing declared, control flow well formed ------


def _train_program(st, o):
    st.enable_static()
    x = st.data("x", [8, 4], "float32")
    y = st.data("y", [8, 1], "float32")
    st.nn.create_parameter([4, 1], "float32", name="w")
    pred = o.matmul(x, st.default_main_program().global_block().var("w"))
    loss = o.mean(o.square(o.subtract(pred, y)))
    st.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return st.default_main_program(), loss


def test_optimizer_updates_verify_clean():
    prog, loss = _train_program(static, ops)
    rep = prog.verify(feed_names=["x", "y"], fetch_list=[loss])
    assert rep.ok and not rep.warnings
    jprog, jloss = _train_program(jstatic, jops)
    assert jprog.verify(feed_names=["x", "y"], fetch_list=[jloss]).ok
    update_ops = [op for blk in prog.blocks for op in blk.ops
                  if op.type in ("adam_update", "increment")]
    assert update_ops
    for op in update_ops:
        written = set(op.outputs.get("Out", []))
        read = set(op.inputs.get("X", []))
        assert written & read <= set(op.attrs["__inplace__"])


def test_batch_norm_alias_verifies_clean():
    static.enable_static()
    x = static.data("x", [4, 3], "float32")
    out = static.nn.batch_norm(x)
    prog = static.default_main_program()
    bn = [op for op in prog.global_block().ops if op.type == "batch_norm"][0]
    assert set(bn.attrs["__inplace__"]) == set(bn.outputs["Out"][1:])
    assert prog.verify(feed_names=["x"], fetch_list=[out]).ok


def test_control_flow_programs_verify_clean():
    static.enable_static()
    x = static.data("x", [4], "float32")

    def cnd(v):
        return ops.less_than(ops.sum(v), ops.full([], 100.0))

    def body(v):
        return ops.add(v, ops.full([4], 1.0))

    (out,) = static.nn.while_loop(cnd, body, [x])
    carries, ys = static.nn.scan(lambda c, s: ([ops.add(c, s)], [c]), [out],
                                 [static.data("seq", [3, 4], "float32")])
    prog = static.default_main_program()
    assert prog.verify(feed_names=["x", "seq"], fetch_list=[carries[0]]).ok


def test_verify_cache_invalidates_on_mutation():
    p = _relu_of_i(static)
    assert p.verify(feed_names=["i"], fetch_list=["o"]).ok
    r1 = p.verify(feed_names=["i"], fetch_list=["o"])
    r2 = p.verify(feed_names=["i"], fetch_list=["o"])
    assert r1 is r2  # cached: the same verdict object
    b = p.global_block()
    b.create_var(name="o2", shape=[2], dtype="float32")
    b.append_op("tanh", {"X": ["missing"]}, {"Out": ["o2"]}, {})
    with pytest.raises(VerifyError):
        p.verify(feed_names=["i"], fetch_list=["o2"])


def test_failed_verdict_is_cached_and_rearmed():
    p, _, _ = _golden_undefined(static)
    with pytest.raises(VerifyError) as e1:
        p.verify(feed_names=["i"], fetch_list=["o"])
    with pytest.raises(VerifyError) as e2:
        p.verify(feed_names=["i"], fetch_list=["o"])
    assert e1.value is e2.value  # the cached verdict, no re-walk


def test_var_only_mutation_rearms_cached_verdict():
    """``create_var`` moves no version; the cache keys the variable count,
    so declaring the missing persistable un-sticks a cached VerifyError."""
    p = static.Program()
    b = p.global_block()
    _feedable(b, "i", [2])
    b.create_var(name="o", shape=[2], dtype="float32")
    b.append_op("elementwise_add", {"X": ["i", "w"]}, {"Out": ["o"]}, {})
    with pytest.raises(VerifyError):
        p.verify(feed_names=["i"], fetch_list=["o"])
    b.create_var(name="w", shape=[2], dtype="float32", persistable=True)
    assert p.verify(feed_names=["i"], fetch_list=["o"]).ok


def test_flag_off_skips_verification():
    p, _, _ = _golden_undefined(static)
    exe = static.Executor("cpu")
    set_flags({"program_verify": "off"})
    with pytest.raises(EnforceNotMet) as ei:
        exe.run(p, feed={"i": np.ones(2, "f")}, fetch_list=["o"])
    assert not isinstance(ei.value, VerifyError)  # the interpreter's own error
    assert "neither fed" in str(ei.value)


def test_verify_program_function_matches_method():
    p = _relu_of_i(static)
    rep = verify_program(p, ["i"], ["o"])
    assert rep.ok and str(rep) == str(p.verify(feed_names=["i"], fetch_list=["o"]))


# -- beyond the JAX file: the registry, programs saved by one package ---------------------


def test_verifier_passes_in_the_jax_order():
    assert [n for n, _ in verifier_passes()] == [n for n, _ in jverifier_passes()] == [
        "block-structure", "def-before-use", "write-conflicts", "dtype-consistency",
        "dead-code"]


def _lenet_like(st, o):
    st.enable_static()
    img = st.data("img", [2, 1, 12, 12], "float32")
    label = st.data("label", [2, 1], "int64")
    h = o.relu(st.nn.conv2d(img, num_filters=4, filter_size=3, padding=1))
    h = o.max_pool2d(h, kernel_size=2, stride=2)
    logits = st.nn.fc(h, 10)
    loss = o.mean(o.softmax_with_cross_entropy(logits, label))
    st.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    return st.default_main_program(), loss


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_program_saved_by_either_package_verifies_alike(writer):
    """A training program with its gradient ops and in-place updates, built
    by one package and read by the other through ``to_dict``: both
    verifiers find it clean with the same warnings; with its first op's
    input renamed away, both name the same op and var."""
    st, o, _ = PACKAGES[writer]
    prog, loss = _lenet_like(st, o)
    d = prog.to_dict()
    st.disable_static()
    for strip in (False, True):
        progs = {pkg: PACKAGES[pkg][0].Program.from_dict(d) for pkg in PACKAGES}
        if strip:
            for p in progs.values():
                p.global_block().ops[0].inputs["X"][0] = "not_there"
        results = {}
        for pkg, p in progs.items():
            try:
                rep = p.verify(feed_names=["img", "label"], fetch_list=[loss.name])
                results[pkg] = [(f.pass_name, f.op_index, f.var) for f in rep.findings]
            except PACKAGES[pkg][2] as e:
                results[pkg] = _where(e)
        assert results["port"] == results["jax"]
        if strip:
            assert results["port"] == ("def-before-use", 0, 0, "conv2d", "not_there")
