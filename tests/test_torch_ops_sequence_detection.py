"""Port parity: the sequence and detection op families, ``nets``, and two small programs over them.

Each op type of ``ops/sequence.py`` and ``ops/detection.py`` is a case of
``tests/_torch_tail_cases.py`` run through the JAX package's registry
kernel and the port's on the same seeded numpy inputs and attributes:
integers (NMS indices and counts among them) exactly, floats to
``RTOL``/``ATOL`` unless a case names its own tolerance. Every case is
also evaluated on ``meta`` tensors (static shape inference): the output
shapes and dtypes are the CPU run's, or, for an op whose output size is
the data's, shape inference refuses. Gradients of ``sequence_pool``,
``sequence_conv`` and ``yolov3_loss`` are held against ``jax.grad``. The
NMS family is held against a serial greedy NMS in numpy on a larger
clustered set, and the fronts of the data-sized sequence forms refuse a
static ``Variable``.

Two programs at a small size are built alike in both packages, the port's
scope a copy of the JAX startup's (``convert.scope_from_numpy``): the
Paddle book's sentiment conv net (vocabulary 50, embedding 16, two
``nets.sequence_conv_pool`` of 16 with filter sizes 3 and 4, ``tanh``,
``sqrt`` pooling, a softmax ``fc`` of 2, cross entropy, static Adam at lr
0.002) trained three steps, losses within 1e-5 relative and parameters
within 1e-5 of their largest entry; and a YOLOv3 post-process (2 classes
at a 64x64 input: ``yolo_box`` at three scales, then ``multiclass_nms``),
rows equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu.nn  # noqa: E402,F401
import paddle_tpu.static as jstatic  # noqa: E402
from paddle_tpu import nets as jnets  # noqa: E402
from paddle_tpu import ops as jops  # noqa: E402
from paddle_tpu.ops import registry as jregistry  # noqa: E402

import paddle_tpu_torch.nn  # noqa: E402,F401
from paddle_tpu_torch import convert, nets, ops, static  # noqa: E402
from paddle_tpu_torch.errors import UnimplementedError  # noqa: E402
from paddle_tpu_torch.ops import registry as pregistry  # noqa: E402
from test_torch_serving_compiled import graphs  # noqa: E402,F401  (the capture path's fixture)

import _torch_tail_cases as tc  # noqa: E402
from chip_smoke import (greedy_rows, sentiment_batches, sentiment_conv_net,  # noqa: E402
                        yolo_heads, yolo_post_process)

torch.set_num_threads(1)


# -- running a case through both packages ---------------------------------------------


def _to(a, conv):
    if a is None:
        return None
    if isinstance(a, list):
        return [conv(v) for v in a]
    return conv(a)


def _attrs(attrs, conv):
    return {k: conv(v) if isinstance(v, np.ndarray) else v for k, v in attrs.items()}


def _outs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def run_jax(c):
    with jax.enable_x64(False):
        out = jregistry.kernel(c.op)(*[_to(a, jnp.asarray) for a in c.inputs],
                                     **_attrs(c.attrs, jnp.asarray), **c.jax_attrs)
        return [np.asarray(o) for o in _outs(out)]


def _port_array(a):
    return torch.from_numpy(np.array(a))


def run_port(c, device="cpu"):
    def conv(a):
        return _port_array(a).to(device)

    out = pregistry.kernel(c.op)(*[_to(a, conv) for a in c.inputs], **_attrs(c.attrs, conv),
                                 **c.port_attrs)
    return [o.detach().cpu().numpy() if isinstance(o, torch.Tensor) else np.asarray(o)
            for o in _outs(out)]


def assert_same(got, want, c):
    assert len(got) == len(want), c.id
    for g, w in zip(got, want):
        assert g.shape == w.shape, (c.id, g.shape, w.shape)
        if w.dtype.kind in "biu":
            assert g.dtype.kind == w.dtype.kind, (c.id, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=c.id)
        else:
            np.testing.assert_allclose(g, w, rtol=c.tol[0], atol=c.tol[1], err_msg=c.id)


def check(c):
    assert_same(run_port(c), run_jax(c), c)


def check_meta(c):
    """The case on ``meta`` tensors: the CPU run's shapes and dtypes, or a
    refusal for an op sized by its data (without a shape rule)."""
    def meta(a):
        t = _port_array(a)
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    metas = [_to(a, meta) for a in c.inputs]
    attrs = dict(_attrs(c.attrs, meta), **c.port_attrs)
    if c.kind == "host" and c.op not in pregistry._SHAPE_RULES:
        with pytest.raises(Exception):
            pregistry.eval_meta(c.op, metas, attrs)
        return
    want = [torch.from_numpy(np.asarray(o)) for o in run_port(c)]
    got = _outs(pregistry.eval_meta(c.op, metas, attrs))
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want], c.id
    assert [g.dtype for g in got] == [w.dtype for w in want], c.id


def params(cases):
    return pytest.mark.parametrize("case", cases, ids=[c.id for c in cases])


# -- the cases ----------------------------------------------------------------------------


@params(tc.SEQUENCE)
def test_sequence_ops_match_jax(case):
    check(case)


@params([c for c in tc.DETECTION if c.kind == "value"])
def test_detection_ops_match_jax(case):
    check(case)


@params(tc.SEQUENCE + tc.DETECTION)
def test_sequence_and_detection_ops_on_meta(case):
    check_meta(case)


def test_every_op_of_the_two_files_has_a_case():
    import inspect

    files = {"sequence", "detection"}
    theirs = {n for n, d in jregistry.all_ops().items()
              if inspect.getmodule(d.fn).__name__.rsplit(".", 1)[-1] in files}
    assert len(theirs) == 40 and theirs <= set(pregistry.all_ops())
    assert {c.op for c in tc.SEQUENCE + tc.DETECTION} == theirs


def test_rpn_target_assign_draws_within_its_budget():
    """``use_random``: the draws differ between the packages; the labels
    keep the budget and the fixed parts agree with the JAX kernel."""
    c = next(c for c in tc.DETECTION if c.op == "rpn_target_assign")
    anchors, gts = (_port_array(a) for a in c.inputs)
    gen = torch.Generator().manual_seed(0)
    labels, best_gt, n_fg, n_bg = pregistry.kernel("rpn_target_assign")(
        anchors, gts, rpn_batch_size_per_im=8, rpn_fg_fraction=0.5, generator=gen)
    want = run_jax(c)
    np.testing.assert_array_equal(best_gt.numpy(), want[1])
    assert int(n_fg) == int(want[2]) and int(n_fg + n_bg) <= 8
    assert int((labels == 1).sum()) == int(n_fg) and int((labels == 0).sum()) == int(n_bg)
    # every drawn positive is a positive of the deterministic rule's pool
    pos_pool = pregistry.kernel("rpn_target_assign")(anchors, gts, rpn_batch_size_per_im=40,
                                                      rpn_fg_fraction=1.0, use_random=False)[0]
    assert bool(((labels == 1) <= (pos_pool == 1)).all())


# -- gradients against jax.grad --------------------------------------------------------------


def grads(op, inputs, attrs, wrt, out_index=None, cot_seed=0):
    """The gradients of ``sum(out * r)`` (``r`` a seeded cotangent; ``out``
    the op's output ``out_index`` when it has several) with respect to the
    inputs ``wrt``, in both packages: ``(jax's, port's)``."""
    def pick(out):
        return out if out_index is None else out[out_index]

    with jax.enable_x64(False):
        out0 = pick(jregistry.kernel(op)(*[jnp.asarray(a) for a in inputs], **attrs))
    r = np.random.RandomState(cot_seed).randn(*np.shape(out0)).astype(np.float32)

    def jloss(*vs):
        args = [jnp.asarray(a) for a in inputs]
        for i, v in zip(wrt, vs):
            args[i] = v
        return jnp.sum(pick(jregistry.kernel(op)(*args, **attrs)) * r)

    with jax.enable_x64(False):
        jg = jax.grad(jloss, argnums=tuple(range(len(wrt))))(*[jnp.asarray(inputs[i])
                                                               for i in wrt])
    args = [_port_array(a) for a in inputs]
    for i in wrt:
        args[i].requires_grad_(True)
    (pick(pregistry.kernel(op)(*args, **attrs)) * torch.from_numpy(r)).sum().backward()
    return [np.asarray(g) for g in jg], [args[i].grad.numpy() for i in wrt]


@pytest.mark.parametrize("pool", ["SUM", "AVERAGE", "SQRT", "MAX", "MIN", "LAST", "FIRST"])
def test_sequence_pool_gradient_matches_jax(pool):
    x = np.random.RandomState(1).randn(4, 5, 3).astype(np.float32)
    want, got = grads("sequence_pool", [x, np.array([3, 5, 1, 4], np.int64)],
                       {"pooltype": pool}, [0])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)


def test_sequence_conv_gradient_matches_jax():
    rs = np.random.RandomState(2)
    x, w = rs.randn(4, 6, 3).astype(np.float32), rs.randn(9, 5).astype(np.float32)
    want, got = grads("sequence_conv", [x, np.array([3, 6, 1, 4], np.int64), w],
                       {"context_length": 3}, [0, 2])
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, rtol=1e-5, atol=1e-5)


@params(tc.YOLOV3)
def test_yolov3_loss_gradient_matches_jax(case):
    want, got = grads("yolov3_loss", case.inputs, case.attrs, [0])
    scale = float(np.abs(want[0]).max())
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6 * scale)


# -- greedy NMS against a serial oracle ------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_multiclass_nms_matches_a_serial_greedy_oracle(seed):
    rs = np.random.RandomState(seed)
    c = rs.uniform(10, 90, (6, 2))
    pick = c[rs.randint(0, 6, 300)] + rs.uniform(-4, 4, (300, 2))
    wh = rs.uniform(6, 20, (300, 2))
    bboxes = np.concatenate([pick - wh / 2, pick + wh / 2], 1).astype(np.float32)
    scores = rs.uniform(0, 1, (7, 300)).astype(np.float32) ** 3
    attrs = dict(score_threshold=0.05, nms_threshold=0.45, keep_top_k=120, background_label=2)
    got, num = pregistry.kernel("multiclass_nms")(torch.from_numpy(bboxes),
                                                  torch.from_numpy(scores), **attrs)
    want, n = greedy_rows(bboxes, scores, 0.05, 0.45, 120, background=2)
    assert int(num) == n
    np.testing.assert_array_equal(got.numpy(), want)
    jrows, jnum = run_jax(tc.Case("multiclass_nms", [bboxes, scores], attrs))
    np.testing.assert_array_equal(got.numpy(), jrows)
    assert int(jnum) == int(num)


def test_nms_fixed_point_takes_one_sweep_a_chain_link():
    """A chain 0 > 1 > 2 > ... where each box overlaps only its neighbours:
    greedy keeps every other box, and the fixed point needs the chain's
    length in sweeps."""
    n = 9
    x = np.arange(n, dtype=np.float32) * 6.0
    bboxes = np.stack([x, np.zeros(n), x + 10.0, np.full(n, 10.0)], 1).astype(np.float32)
    scores = np.linspace(1.0, 0.1, n).astype(np.float32)
    keep, num = pregistry.kernel("nms")(torch.from_numpy(bboxes), torch.from_numpy(scores),
                                        iou_threshold=0.2)  # neighbours: IoU 0.25
    np.testing.assert_array_equal(keep.numpy()[:int(num)], np.arange(0, n, 2))
    np.testing.assert_array_equal(keep.numpy(), run_jax(tc.Case(
        "nms", [bboxes, scores], {"iou_threshold": 0.2}))[0])


# -- the op front ---------------------------------------------------------------------------


@pytest.fixture
def static_mode():
    static.reset_default_programs()
    static.enable_static()
    yield
    static.disable_static()
    static.reset_default_programs()


@pytest.mark.parametrize("call", [
    lambda x, n: ops.sequence_unpad(x, n),
    lambda x, n: ops.sequence_expand(x, n),
    lambda x, n: ops.sequence_erase(n, tokens=(1,)),
    lambda x, n: ops.sequence_mask(n),
    lambda x, n: ops.sequence_pad(x, n),
], ids=["unpad", "expand", "erase", "mask_datalen", "pad_datalen"])
def test_data_sized_sequence_fronts_refuse_a_static_variable(static_mode, call):
    x = static.data("x", [4, 5, 3], "float32")
    n = static.data("n", [4], "int64")
    with pytest.raises(UnimplementedError):
        call(x, n)


def test_static_sequence_ops_append_with_shapes(static_mode):
    x = static.data("x", [4, 5, 3], "float32")
    n = static.data("n", [4], "int64")
    assert ops.sequence_pool(x, n, "MAX").shape == [4, 3]
    assert ops.sequence_mask(n, maxlen=5).shape == [4, 5]
    assert ops.sequence_conv(x, n, np.zeros((9, 2), np.float32), 3).shape == [4, 5, 2]
    rows, num = ops.multiclass_nms(static.data("b", [7, 4], "float32"),
                                   static.data("s", [3, 7], "float32"), keep_top_k=5)
    assert rows.shape == [5, 6] and num.shape == []


def test_nets_resolves_its_five_names():
    assert set(nets.__all__) == set(jnets.__all__) == {
        "simple_img_conv_pool", "img_conv_group", "sequence_conv_pool", "glu",
        "scaled_dot_product_attention"}


def test_nets_glu_and_attention_eagerly_match_jax():
    from paddle_tpu_torch.framework import place

    rs = np.random.RandomState(3)
    x = rs.randn(2, 3, 8).astype(np.float32)
    q, k, v = (rs.randn(2, 5, 8).astype(np.float32) for _ in range(3))
    prev = place._expected_place
    paddle = __import__("paddle_tpu_torch")
    paddle.set_device("cpu")
    try:
        import paddle_tpu as jpaddle

        np.testing.assert_allclose(nets.glu(paddle.to_tensor(x)).numpy(),
                                   np.asarray(jnets.glu(jpaddle.to_tensor(x))._array),
                                   rtol=1e-6, atol=1e-6)
        got = nets.scaled_dot_product_attention(*(paddle.to_tensor(a) for a in (q, k, v)))
        want = jnets.scaled_dot_product_attention(*(jpaddle.to_tensor(a) for a in (q, k, v)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want._array), rtol=1e-5, atol=1e-6)
        for pkg, mod in ((paddle, nets), (jpaddle, jnets)):  # projections: static only
            with pytest.raises(RuntimeError):
                mod.scaled_dot_product_attention(*(pkg.to_tensor(a) for a in (q, k, v)),
                                                 num_heads=2)
    finally:
        place._expected_place = prev


# -- two programs at a small size against the JAX package -------------------------------------


@pytest.fixture
def both_static():
    for st in (jstatic, static):
        st.reset_default_programs()
        st.global_scope().clear()
        st.enable_static()
    yield
    for st in (jstatic, static):
        st.disable_static()
        st.reset_default_programs()
        st.global_scope().clear()


def _copy_scope():
    jscope = jstatic.global_scope()
    convert.scope_from_numpy({n: np.asarray(jscope.get(n)) for n in jscope.var_names()},
                             scope=static.global_scope(), device="cpu")


def test_sentiment_conv_net_trains_like_jax(both_static):
    vocab, emb, hid, seq_len, batch = 50, 16, 16, 12, 4
    costs = [sentiment_conv_net(st, o, nt, vocab, emb, hid, seq_len, batch)[0]
             for st, o, nt in ((jstatic, jops, jnets), (static, ops, nets))]
    jexe = jstatic.Executor()
    jexe.run_startup()
    _copy_scope()
    pexe = static.Executor("cpu")
    for feed in sentiment_batches(3, vocab, seq_len, batch, lo=4):
        want = float(jexe.run(feed=feed, fetch_list=[costs[0]])[0])
        got = float(pexe.run(feed=feed, fetch_list=[costs[1]])[0])
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    names = [n for n in static.global_scope().var_names() if n.startswith("param_")]
    assert len(names) >= 7
    for n in names:
        got, want = static.global_scope().numpy(n), np.asarray(jstatic.global_scope().get(n))
        assert float(np.abs(got - want).max()) <= 1e-5 * max(float(np.abs(want).max()), 1e-30), n


def test_yolov3_post_process_matches_jax(both_static):
    fetches = [yolo_post_process(st, o, 2, 64)[:2] for st, o in ((jstatic, jops), (static, ops))]
    feed = yolo_heads(2, 64, obj_shift=-2.0, cls_shift=0.0)
    want = jstatic.Executor().run(feed=feed, fetch_list=list(fetches[0]))
    exe = static.Executor("cpu")
    got = exe.run(feed=feed, fetch_list=list(fetches[1]))
    assert int(got[1]) == int(want[1]) > 3
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)


def test_host_reading_programs_run_uncaptured_and_the_rest_capture(both_static, graphs):
    """On the capture path (rehearsed on the CPU): the YOLOv3 post-process
    (its NMS reads the host) and a ``print`` program are interpreted at
    every run and counted as uncaptured; a sequence program is captured
    once and replayed."""
    from paddle_tpu_torch.static import executor as pexecutor
    from paddle_tpu_torch.static.op_append import append_static_op

    feed = yolo_heads(2, 64, obj_shift=-2.0, cls_shift=0.0)
    rows, num = yolo_post_process(static, ops, 2, 64)[:2]
    x = static.data("x", [4, 5, 3], "float32")
    n = static.data("n", [4], "int64")
    pooled = ops.sequence_pool(x, n, "SQRT")
    shown = append_static_op("print", [pooled], {"message": "pooled"})
    exe = pexecutor.Executor("cpu")
    seq_feed = {"x": np.ones((4, 5, 3), np.float32), "n": np.array([1, 2, 3, 5], np.int64)}
    first = exe.run(feed=feed, fetch_list=[rows, num])
    for _ in range(2):
        again = exe.run(feed=feed, fetch_list=[rows, num])
        np.testing.assert_array_equal(again[0], first[0])
    assert (len(exe.store), exe.store.uncaptured) == (0, 3) and not graphs
    for _ in range(3):
        out = exe.run(feed=seq_feed, fetch_list=[pooled])[0]
    np.testing.assert_allclose(out, np.sqrt([1, 2, 3, 5])[:, None] * np.ones((1, 3)), rtol=1e-6)
    assert (len(exe.store), exe.store.hits, exe.store.uncaptured) == (1, 2, 3)
    assert len(graphs) == 1
    for _ in range(2):
        exe.run(feed=seq_feed, fetch_list=[shown])
    assert (len(exe.store), exe.store.uncaptured) == (1, 5)


def test_nets_conv_group_and_multi_head_attention_programs_match_jax(both_static):
    """``img_conv_group`` (conv + batch norm + relu, then conv + relu, one
    pool) and multi-head ``scaled_dot_product_attention`` with its
    projections, built alike in both packages, on the JAX startup's
    weights."""
    rs = np.random.RandomState(4)
    feed = {"img": rs.randn(2, 3, 8, 8).astype(np.float32),
            "q": rs.randn(2, 5, 8).astype(np.float32), "k": rs.randn(2, 6, 8).astype(np.float32),
            "v": rs.randn(2, 6, 8).astype(np.float32)}
    fetches = []
    for st, nt in ((jstatic, jnets), (static, nets)):
        img = st.data("img", [2, 3, 8, 8], "float32")
        q, k, v = (st.data(n, list(feed[n].shape), "float32") for n in ("q", "k", "v"))
        fetches.append([nt.img_conv_group(img, [4, 4], 2, conv_act="relu",
                                          conv_with_batchnorm=[True, False], pool_stride=2),
                        nt.scaled_dot_product_attention(q, k, v, num_heads=2)])
    jexe = jstatic.Executor()
    jexe.run_startup()
    _copy_scope()
    want = jexe.run(feed=feed, fetch_list=fetches[0])
    got = static.Executor("cpu").run(feed=feed, fetch_list=fetches[1])
    assert [g.shape for g in got] == [(2, 4, 4, 4), (2, 5, 8)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)
