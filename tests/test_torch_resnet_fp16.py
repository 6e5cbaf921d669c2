"""Port parity: ResNet under float16 autocast (``auto_cast(dtype="float16")``, a ``GradScaler``).

The JAX package's TPU conv kernels never took fp16 (``_SUBLANES``,
``paddle_tpu/ops/pallas/conv_bn_relu.py:54``): an fp16 fused conv goes to
its unfused reference (``_reference``: the registered ``conv2d``, then
``batch_norm``, then ``relu``) on every platform, while the max-pool
backward takes fp16 into its Pallas kernel. The port's fp16 instances of
rows 8-13 are held to that reference, row 16 to the kernel, here on the CPU
through their plain versions, on the same numpy inputs:

- the fused conv's fp16 gradients (dx, dw, dgamma, dbeta) in training and
  in eval against ``jax.vjp`` of ``conv_bn_relu._fused`` (which goes to
  ``_reference``): ``d_co`` rounded to fp16 once and dx and dw each one
  product with float32 sums rounded once. Before the repair the port kept
  ``d_co`` in float32 and rounded each patch's gradient to fp16 before
  folding, as the bf16 TPU kernels round: 29-64% of dx's entries differed;
- rows 8-13's plain versions in fp16 against the reference's pieces (the
  conv, the batch norm in training and in eval, its VJP);
- row 16's plain version in fp16 bit-equal to the JAX kernel in interpret
  mode, in NCHW and in the stem's channels-last layout;
- one O1 fp16 step of a bottleneck ResNet [1, 1, 1, 1] (10 classes, batch 2
  at 64 x 64, ``FLAGS_use_pallas_pool_bwd`` on in both packages): the loss
  and every gradient, the loss scaled and the gradients unscaled as the
  ``GradScaler`` does, against ``jax.value_and_grad`` over
  ``_swapped_model``; a control (the step in bf16, or in f32) fails the
  limits;
- a forced overflow: both packages find an inf, the port's Momentum step
  leaves every parameter and velocity as they were and the scale halves as
  the JAX ``GradScaler.update`` halves it;
- the kernel entries on ``meta`` fp16 tensors: each picks its fp16 symbol
  (``ptt_conv_mm_f16_*``, ``ptt_bn_*_f16``, ``ptt_max_pool2d_backward_f16``)
  and raises for want of a card, never with a dtype ``TypeError``.

The kernels themselves are held against these plain versions on the card
by ``chip_smoke.py`` (phase 12t).
"""
import contextlib
import sys
from collections import OrderedDict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.nn.functional as jF  # noqa: E402
from paddle_tpu import amp as jamp  # noqa: E402
from paddle_tpu import flags as jax_flags  # noqa: E402
from paddle_tpu.framework import autograd as jax_autograd  # noqa: E402
from paddle_tpu.framework import jit as jax_jit  # noqa: E402
from paddle_tpu.framework.tensor import Tensor as JaxTensor  # noqa: E402
from paddle_tpu.models import resnet as jax_resnet  # noqa: E402
from paddle_tpu.ops import kernels as jax_kernels  # noqa: E402
from paddle_tpu.ops.pallas import conv_bn_relu as _  # noqa: E402,F401
from paddle_tpu.ops.pallas import pool_backward as jpb  # noqa: E402

from paddle_tpu_torch import amp as pamp  # noqa: E402
from paddle_tpu_torch import convert, flags  # noqa: E402
from paddle_tpu_torch import optimizer as port_opt  # noqa: E402
from paddle_tpu_torch.models import resnet as port_resnet  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.ops import cuda as port_cuda  # noqa: E402
from paddle_tpu_torch.ops.cuda import conv_bn_relu as tcbr  # noqa: E402
from paddle_tpu_torch.ops.cuda import pool_backward as tpb  # noqa: E402

jcbr = sys.modules["paddle_tpu.ops.pallas.conv_bn_relu"]
torch.set_num_threads(1)

EPS = 1e-5


@pytest.fixture(autouse=True)
def _x64_off():
    """The JAX side with 64-bit types off, the JAX package's own setting."""
    with jax.enable_x64(False):
        yield


def _f32(a):
    """A JAX or torch array as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _ulp_of_max(a):
    """One fp16 ulp of the largest |entry| of ``a`` (11 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(float(np.abs(a).max()), 2.0 ** -14))) - 10)


def _ulps_of_entry(got, want):
    """The largest |got - want| in fp16 ulps of each entry of ``want``."""
    spacing = np.abs(np.spacing(want.astype(np.float16))).astype("f4")
    return float((np.abs(got - want) / spacing).max())


def _h(a):
    return torch.from_numpy(np.ascontiguousarray(a)).half()


def _jh(a):
    return jnp.asarray(a).astype(jnp.float16)


# -- Step 0: the fused conv's fp16 gradients against the JAX reference ------------------

GEOMS = {"3x3": (4, 8, 10, 16, 3, 1, 1), "3x3_s2": (2, 3, 17, 8, 3, 2, 1),
         "1x1": (2, 16, 8, 32, 1, 1, 0), "7x7_s2": (2, 3, 20, 8, 7, 2, 3)}

# Read on the CPU, the repaired port / the port before the repair: the share
# of dx's and dw's entries that differ from the JAX reference's is 0-0.023 /
# 0.29-0.64 (dx of the 3x3 case in training 0.023 / 0.62: the port's d_co is
# the TPU kernel's folded form, scale * dy - k3 * co - b0, which rounds to
# fp16 1 ulp off the reference's xhat form in a few entries); the worst
# entry is within 0.5 fp16 ulp of the tensor's largest entry (1.5 before).
# dgamma and dbeta: float32 sums in another order, 6e-5 of the largest.
GRAD_DIFFERING = 0.06
GRAD_ULPS_OF_MAX = 1.0
VEC_RTOL = 2e-4


def _operands(geom, seed=0):
    n, c, h, co, k, s, p = GEOMS[geom]
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c, h, h).astype("f4")
    w = (rng.randn(co, c, k, k) * 0.3).astype("f4")
    g, b = (1 + 0.1 * rng.randn(co)).astype("f4"), (0.1 * rng.randn(co)).astype("f4")
    m, v = (0.1 * rng.randn(co)).astype("f4"), (1 + 0.1 * rng.rand(co)).astype("f4")
    oh = (h + 2 * p - k) // s + 1
    dy = rng.randn(n, co, oh, oh).astype("f4")
    return x, w, g, b, m, v, dy


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("geom", list(GEOMS))
def test_fp16_fused_conv_gradients_match_the_jax_reference(geom, training):
    """The whole op on fp16 x and weight against ``jax.vjp`` of ``_fused``
    (``_reference`` in fp16): y within 1 fp16 ulp of each entry (the
    kernels' ``co * scale + shift`` against the reference's ``(co - mean) *
    rstd * gamma + beta``), the running statistics, dx and dw within
    ``GRAD_ULPS_OF_MAX`` of their largest entry with at most
    ``GRAD_DIFFERING`` of their entries differing, dgamma and dbeta within
    ``VEC_RTOL`` of their largest."""
    n, c, h, co, k, s, p = GEOMS[geom]
    x, w, g, b, m, v, dy = _operands(geom)
    kw = dict(stride=s, padding=p, training=training, momentum=0.9, eps=EPS,
              data_format="NCHW")
    jin = [_jh(x), _jh(w), jnp.asarray(g), jnp.asarray(b)]
    (jy, jm, jv), vjp = jax.vjp(lambda *a: jcbr._fused(*a, jnp.asarray(m), jnp.asarray(v), **kw),
                                *jin)
    want = vjp((_jh(dy), jnp.zeros_like(jm), jnp.zeros_like(jv)))
    assert jy.dtype == jnp.float16 and want[0].dtype == jnp.float16
    ts = [_h(x).requires_grad_(), _h(w).requires_grad_(), torch.from_numpy(g).requires_grad_(),
          torch.from_numpy(b).requires_grad_()]
    y, nm, nv = tcbr.conv_bn_relu(*ts, torch.from_numpy(m), torch.from_numpy(v), stride=s,
                                  padding=p, training=training, momentum=0.9, epsilon=EPS)
    y.backward(_h(dy))
    assert y.dtype == torch.float16
    assert _ulps_of_entry(_f32(y), _f32(jy)) <= 1.0
    # the batch statistics: float32 sums of the fp16 co in other orders
    np.testing.assert_allclose(nm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(nv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    for name, t, ref in zip(("dx", "dw"), ts, want):
        assert t.grad.dtype == torch.float16, name
        got, ref = _f32(t.grad), _f32(ref)
        share = float((got != ref).mean())
        ulps = float(np.abs(got - ref).max() / _ulp_of_max(ref))
        assert share <= GRAD_DIFFERING and ulps <= GRAD_ULPS_OF_MAX, (name, share, ulps)
    for name, t, ref in zip(("dgamma", "dbeta"), ts[2:], want[2:]):
        ref = np.asarray(ref)
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=0,
                                   atol=VEC_RTOL * np.abs(ref).max(), err_msg=name)


@pytest.mark.parametrize("seed", [0, 2])
def test_fp16_patch_gradients_fold_in_float32_and_round_once(seed):
    """The repair's arithmetic: an eval 3x3 conv's dx and dw against the
    float32 transposed conv and weight gradient of the fp16 ``d_co``, each
    rounded once to fp16 (``torch.nn.grad.conv2d_input`` and
    ``conv2d_weight`` in float32; d_co as the reference's affine VJP rounds
    it). Read on the CPU: 0-0.16% of the entries differ (float32 sums in
    other orders); rounding each patch's gradient to fp16 before the fold,
    the bf16 path's rounding, differs in 57-59%."""
    x, w, g, b, m, v, dy = _operands("3x3", seed=seed)
    xs, ws = _h(x).requires_grad_(), _h(w).requires_grad_()
    y, _, _ = tcbr.conv_bn_relu(xs, ws, torch.from_numpy(g), torch.from_numpy(b),
                                torch.from_numpy(m), torch.from_numpy(v), stride=1, padding=1,
                                training=False)
    y.backward(_h(dy))
    ch = [torch.from_numpy(a)[:, None, None] for a in (g, b, m, 1.0 / np.sqrt(v + EPS))]
    co = torch.nn.functional.conv2d(_h(x).float(), _h(w).float(), padding=1).half().float()
    pre = ((co - ch[2]) * ch[3] * ch[0] + ch[1]).half()
    gated = torch.where(pre > 0, _h(dy), torch.zeros((), dtype=torch.float16)).float()
    dco = (gated * ch[0] * ch[3]).half().float()
    dx = torch.nn.grad.conv2d_input(x.shape, _h(w).float(), dco, padding=1).half()
    dw = torch.nn.grad.conv2d_weight(_h(x).float(), w.shape, dco, padding=1).half()
    _, w2, _ = tcbr._as_matmul(_h(x), _h(w), 1, [(1, 1), (1, 1)], "NCHW")
    per_patch = (_rows(dco) @ w2.float().t()).half().float()
    folded = torch.nn.functional.fold(per_patch.reshape(x.shape[0], 100, -1).transpose(1, 2),
                                      (10, 10), 3, padding=1).half()
    assert float((xs.grad != dx).float().mean()) <= 0.01
    assert float((ws.grad != dw).float().mean()) <= 0.01
    assert float((folded != dx).float().mean()) > 0.3


# -- rows 8-13: the plain versions in fp16 against the reference's pieces -------------

# Limits on the pieces, each in fp16 ulps of the largest entry and a share
# of entries that may differ (see the test's readings).
CO_DIFFERING = 0.01
DCO_DIFFERING = 0.02


def _rows(t):
    """NCHW -> [N * H * W, C], the port's conv output rows."""
    return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])


def _piece_inputs(seed):
    x, w, g, b, m, v, dy = _operands("3x3", seed)
    x16, w16 = _jh(x), _jh(w)
    co = jax_kernels.conv2d(x16, w16, stride=1, padding=1, dilation=1, groups=1,
                            data_format="NCHW")
    return x, w, g, b, m, v, dy, co


@pytest.mark.parametrize("seed", [0, 1])
def test_fp16_plain_versions_match_the_reference_pieces(seed):
    """Rows 8-13 in fp16 on the JAX reference's own intermediates: the
    products (``mm_stats``, ``mm_affine_relu``) against its fp16 conv and
    its eval batch norm + relu; the statistics, the normalize + relu and
    the backward's sums and ``d_co`` against its training batch norm and
    that batch norm's VJP."""
    x, w, g, b, m, v, dy, jco = _piece_inputs(seed)
    p2, w2, _ = tcbr._as_matmul(_h(x), _h(w), 1, [(1, 1), (1, 1)], "NCHW", k_multiple=8)
    co_rows = _f32(_rows(torch.from_numpy(_f32(jco))))
    # row 9: co and its channel sums
    co, part = tcbr._mm_stats_plain(p2, w2)
    assert co.dtype == torch.float16 and part.dtype == torch.float32
    assert float((_f32(co) != co_rows).mean()) <= CO_DIFFERING
    assert float(np.abs(_f32(co) - co_rows).max()) <= _ulp_of_max(co_rows)
    np.testing.assert_allclose(part.numpy()[0], _f32(co).astype("f8").sum(0), rtol=1e-6)
    # row 8: the eval output against batch_norm(training=False) + relu
    jy_eval, _, _ = jax_kernels.batch_norm(jco, jnp.asarray(g), jnp.asarray(b), jnp.asarray(m),
                                           jnp.asarray(v), epsilon=EPS, training=False)
    rstd = 1.0 / np.sqrt(v + EPS)
    scale = torch.from_numpy(g * rstd)
    y8 = tcbr._mm_affine_relu_plain(p2, w2, scale, torch.from_numpy(b) - torch.from_numpy(m)
                                    * scale)
    assert y8.dtype == torch.float16
    want = _f32(_rows(torch.from_numpy(_f32(jax.nn.relu(jy_eval)))))
    assert float(np.abs(_f32(y8) - want).max()) <= _ulp_of_max(want)
    # rows 10-13 on the reference's co, against its training batch norm and VJP
    jg, jb = jnp.asarray(g), jnp.asarray(b)

    def bn_relu(c, gg, bb):
        y, mu, var = jax_kernels._bn_train_core(c, gg, bb, EPS, (0, 2, 3), (1, c.shape[1], 1, 1))
        return jax.nn.relu(y), mu, var

    (jy, mu, var), vjp = jax.vjp(bn_relu, jco, jg, jb)
    jdco, jdg, jdb = vjp((_jh(dy), jnp.zeros_like(mu), jnp.zeros_like(var)))
    cot = torch.from_numpy(co_rows).half()
    mean = torch.from_numpy(co_rows.astype("f8").mean(0).astype("f4"))
    var10 = tcbr._centered_sumsq_plain(cot, mean)[0] / cot.shape[0]
    np.testing.assert_allclose(var10.numpy(), np.asarray(var), rtol=1e-5)
    mean, var10 = torch.from_numpy(np.asarray(mu)), torch.from_numpy(np.asarray(var))
    rstd = torch.rsqrt(var10 + EPS)
    scale = torch.from_numpy(g) * rstd
    shift = torch.from_numpy(b) - mean * scale
    y11 = tcbr._bn_relu_plain(cot, scale, shift)
    assert y11.dtype == torch.float16
    want = _f32(_rows(torch.from_numpy(_f32(jy))))
    assert float(np.abs(_f32(y11) - want).max()) <= _ulp_of_max(want)
    dyr = torch.from_numpy(_f32(_rows(torch.from_numpy(dy)))).half()
    pdy, pdyc = tcbr._bn_bwd_partials_plain(cot, dyr, scale, shift)
    sum_dy, sum_dyc = pdy[0], pdyc[0]
    dgamma = (sum_dyc - mean * sum_dy) * rstd
    np.testing.assert_allclose(sum_dy.numpy(), np.asarray(jdb), rtol=0,
                               atol=VEC_RTOL * float(np.abs(jdb).max()))
    np.testing.assert_allclose(dgamma.numpy(), np.asarray(jdg), rtol=0,
                               atol=VEC_RTOL * float(np.abs(jdg).max()))
    rows = cot.shape[0]
    k3 = scale * (dgamma / rows) * rstd
    b0 = scale * (sum_dy / rows) - k3 * mean
    dco = tcbr._bn_bwd_dco_plain(cot, dyr, scale, shift, k3, b0)
    want = _f32(_rows(torch.from_numpy(_f32(jdco))))
    assert dco.dtype == torch.float16
    assert float((_f32(dco) != want).mean()) <= DCO_DIFFERING
    assert float(np.abs(_f32(dco) - want).max()) <= _ulp_of_max(want)


def test_fp16_bn_bwd_dco_rounds_once_and_overflows_to_inf():
    """Row 13's plain version in fp16 writes fp16: its float32 value rounded
    once to nearest even; a value past 65504 becomes inf, never clamped."""
    co = torch.tensor([[1.0, -2.0]], dtype=torch.float16)
    dy = torch.tensor([[30000.0, 1.0]], dtype=torch.float16)
    one, zero = torch.ones(2), torch.zeros(2)
    got = tcbr._bn_bwd_dco_plain(co, dy, torch.full((2,), 4.0), zero, zero, zero)
    assert got.dtype == torch.float16
    assert torch.isinf(got[0, 0]) and got[0, 1] == 0  # co[1] * 4 < 0: gated
    got = tcbr._bn_bwd_dco_plain(co, dy, one, zero, torch.full((2,), 1.0 / 3), zero)
    assert got[0, 0] == torch.tensor(30000.0 - 1.0 / 3, dtype=torch.float32).half()


# -- row 16: the pool backward's plain version in fp16 ----------------------------------

POOL_GEOMS = [
    ((2, 8, 16, 16), (3, 3), (2, 2), (1, 1)),  # the stem's pool, small
    ((2, 3, 8, 8), (2, 2), (2, 2), (0, 0)),
    ((1, 4, 12, 16), (3, 3), (1, 1), (1, 1)),
    ((1, 2, 8, 8), (3, 2), (2, 3), (1, 0)),
]


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("shape,ks,st,p", POOL_GEOMS)
def test_fp16_pool_plain_version_equals_the_jax_kernel_bit_for_bit(shape, ks, st, p, layout):
    """fp16 x (a relu output: zeros tie), its pooling and an fp16 dy: the
    plain version equals ``max_pool2d_backward(..., interpret=True)`` of the
    JAX package bit for bit (taps added in float32, rounded once), dx in the
    layout of x."""
    rng = np.random.RandomState(0)
    x = torch.relu(torch.from_numpy(rng.randn(*shape).astype("f4"))).half()
    y = torch.nn.functional.max_pool2d(x.float(), ks, st, p).half()
    dy = torch.from_numpy(rng.randn(*y.shape).astype("f4")).half()
    arrays = [_jh(_f32(t)) for t in (x, y, dy)]
    want = jpb.max_pool2d_backward(*arrays, kernel=ks, stride=st, padding=p, interpret=True)
    assert want.dtype == jnp.float16
    if layout == "nhwc":
        x, y, dy = (t.contiguous(memory_format=torch.channels_last) for t in (x, y, dy))
    got = tpb.max_pool2d_backward(x, y, dy, ks, st, p)
    assert got.dtype == torch.float16 and tpb.memory_layout(got) == layout
    np.testing.assert_array_equal(_f32(got), _f32(want))


# -- one O1 fp16 step of a tiny ResNet --------------------------------------------------

B, HW, CLASSES = 2, 64, 10
TRIPLES = 1 + 2 * 4  # the stem, conv1/bn1 and conv2/bn2 of each of the 4 blocks
SCALE = 1024.0
# One O1 fp16 step against the JAX package's, read on the CPU: the loss
# 1.18e-3 apart, the gradient's relative L2 error 0.097, its worst entry
# 0.66 of its layer's largest. That is the floor of any two fp16 roundings
# of this net: the JAX package's own fp16 step through its bf16-style
# kernels (``_fused(..., force=True)``) reads 3.3e-4, 0.095 and 0.66
# against its ``_reference`` step (at batch 4, or at 128 x 128, 0.07 and
# 0.39-0.75): at batch 2 x 64 x 64 layer4's batch norms see 8 values a
# channel and relu gates flip at fp16's rounding. The controls: the step in
# bf16 reads 5.6e-4, 0.35, 0.64; in f32 (no autocast) 3.5e-3, 0.126, 0.66.
# So the loss is held near the geometric mean of the sound reading and
# f32's, the relative L2 near that of the sound reading and bf16's: the
# control each fails. The worst entry tells none of them apart and is not
# held. These catch a gross fault (a missing cast, a wrong kernel, a
# dropped gradient); Step 0's rounding is held op by op above.
STEP_LIMITS = {"loss": 2.0e-3, "grad_rel_l2": 0.185}
# the control's step and the limit it must fail
STEP_CONTROLS = {"bfloat16": "grad_rel_l2", "float32": "loss"}


def _jax_model():
    return jax_resnet.ResNet(jax_resnet.BottleneckBlock, [1, 1, 1, 1], num_classes=CLASSES)


def _port_model(path):
    return convert.load_resnet(
        path, lambda **kw: port_resnet.ResNet(port_resnet.BottleneckBlock, [1, 1, 1, 1], **kw),
        num_classes=CLASSES)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    paddle.seed(0)
    jm = _jax_model()
    path = str(tmp_path_factory.mktemp("resnet_fp16") / "resnet.pdparams")
    paddle.save(jm.state_dict(), path)
    return jm, path


@pytest.fixture()
def pool_kernel(monkeypatch):
    """Both packages' pool-backward flag on; the JAX pool backward through
    its Pallas kernel in interpret mode (the fp16 fused conv takes
    ``_reference`` on every platform: left as it is); the calls counted."""
    calls = {"jax_pool": 0, "port_pool": 0, "jax_fused": 0}
    pool_bwd = jpb.max_pool2d_backward

    def jax_pool(*a, **k):
        calls["jax_pool"] += 1
        return pool_bwd(*a, **{**k, "interpret": True})

    fused = jcbr._fused

    def jax_fused(*a, **k):
        calls["jax_fused"] += 1
        return fused(*a, **k)

    supported = jpb.max_pool_backward_supported
    monkeypatch.setattr(jpb, "max_pool2d_backward", jax_pool)
    monkeypatch.setattr(jcbr, "_fused", jax_fused)
    monkeypatch.setattr(jpb, "on_tpu_platform", lambda: True)
    monkeypatch.setattr(jpb, "max_pool_backward_supported", lambda *a: supported(*a))
    monkeypatch.setattr(jax_flags._REGISTRY["use_pallas_pool_bwd"], "value", True)
    monkeypatch.setattr(flags._REGISTRY["use_pallas_pool_bwd"], "value", True)
    port_pool = tpb.max_pool2d_backward

    def counted_pool(*a, **k):
        calls["port_pool"] += 1
        return port_pool(*a, **k)

    monkeypatch.setattr(tpb, "max_pool2d_backward", counted_pool)
    return calls


def _batch(seed=5):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, 3, HW, HW).astype("f4"), rng.randint(0, CLASSES, (B,)).astype("int64")]


def _jax_scaled_grads(jm, batch, scale, dtype="float16"):
    """(loss, {name: gradient}) of one O1 step's ``loss * scale`` by
    ``jax.value_and_grad`` over ``_swapped_model`` (the running buffers as
    they are), the gradients multiplied by ``1 / scale`` as
    ``GradScaler.unscale_`` does."""
    params = OrderedDict((n, p._array) for n, p in jm.named_parameters())
    buffers = OrderedDict((n, b_._array) for n, b_ in jm.named_buffers())

    def loss_of(params):
        state = {"params": params, "frozen": OrderedDict(), "buffers": buffers}
        with jax_jit._swapped_model(jm, state), jax_autograd.no_grad():
            x, y = (JaxTensor._from_array(jnp.asarray(a)) for a in batch)
            with jamp.auto_cast(level="O1", dtype=dtype):
                loss = jF.cross_entropy(jm(x), y).mean()
        return loss._array * jnp.float32(scale)

    jm.train()
    scaled, grads = jax.value_and_grad(loss_of)(params)
    return float(scaled) / scale, {n: np.asarray((g * (1.0 / scale)).astype(jnp.float32))
                                   for n, g in grads.items()}


class _NoAmp:
    @staticmethod
    def auto_cast(**kw):
        return contextlib.nullcontext()


def _port_scaled_grads(tm, batch, scale, dtype="float16"):
    """(loss, {name: gradient}, found_inf) of one port step through a
    ``GradScaler``: ``scale(loss).backward()`` and ``unscale_``."""
    amp_mod = _NoAmp if dtype == "float32" else pamp
    scaler = pamp.GradScaler(init_loss_scaling=scale)
    opt = port_opt.SGD(learning_rate=0.0, parameters=tm.parameters())
    tm.train()
    x, y = (torch.from_numpy(a) for a in batch)
    with amp_mod.auto_cast(level="O1", dtype=dtype):
        loss = F.cross_entropy(tm(x), y).mean()
    scaler.scale(loss).backward()
    scaler.unscale_(opt)
    return (float(loss.detach()), {n: p.grad.float().numpy() for n, p in tm.named_parameters()},
            scaler._found_inf)


def _step_errors(loss, grads, want_loss, want):
    scale = {}
    for name, g in want.items():
        layer = name.rpartition(".")[0]
        scale[layer] = max(scale.get(layer, 0.0), float(np.abs(g).max()))
    num = sum(float(np.square(grads[n].astype("f8") - g).sum()) for n, g in want.items())
    den = sum(float(np.square(g.astype("f8")).sum()) for g in want.values())
    worst = max(float(np.abs(grads[n] - g).max()) / scale[n.rpartition(".")[0]]
                for n, g in want.items())
    return {"loss": abs(loss - want_loss), "grad_rel_l2": (num / den) ** 0.5, "worst": worst}


@pytest.mark.parametrize("control", list(STEP_CONTROLS))
def test_o1_fp16_step_loss_and_gradients_match_jax(saved, pool_kernel, monkeypatch, control):
    """The loss and every gradient of one O1 fp16 step under a
    ``GradScaler`` against the JAX package's (``jax.value_and_grad`` over
    ``_swapped_model`` with the same scale folded in; its fused convs
    through ``_reference``, its stem's pool backward through the Pallas
    kernel): within ``STEP_LIMITS``; the same step in bf16 (O1) fails the
    gradient's limit, in f32 (no autocast) the loss's. Each of the port's
    fused convs reaches the training core in fp16, the pool backward once;
    no inf is found."""
    jm, path = saved
    batch = _batch()
    want_loss, want = _jax_scaled_grads(jm, batch, SCALE)
    assert pool_kernel["jax_fused"] == TRIPLES and pool_kernel["jax_pool"] == 1
    assert all(np.isfinite(g).all() for g in want.values())
    core_dtypes = []
    real_core = tcbr._TrainCore.apply

    def spy(p2, *rest):
        core_dtypes.append(p2.dtype)
        return real_core(p2, *rest)

    monkeypatch.setattr(tcbr._TrainCore, "apply", spy)
    loss, grads, found = _port_scaled_grads(_port_model(path), batch, SCALE)
    assert core_dtypes == [torch.float16] * TRIPLES and pool_kernel["port_pool"] == 1
    assert set(grads) == set(want) and not found
    sound = _step_errors(loss, grads, want_loss, want)
    c_loss, c_grads, c_found = _port_scaled_grads(_port_model(path), batch, SCALE, control)
    assert not c_found
    bad = _step_errors(c_loss, c_grads, want_loss, want)
    assert all(sound[k] <= lim for k, lim in STEP_LIMITS.items()), (sound, STEP_LIMITS)
    must_fail = STEP_CONTROLS[control]
    assert bad[must_fail] > STEP_LIMITS[must_fail], (control, bad, STEP_LIMITS)


def test_forced_overflow_skips_the_step_and_halves_the_scale(saved, pool_kernel):
    """After a step taken at a scale fp16 holds, a step at a scale past its
    range: both packages' gradients hold an inf, both scalers find it, the
    port's ``minimize`` leaves every parameter and every Momentum velocity
    as they were, bit for bit, the running statistics advance (the forward
    ran), and the scale halves as the JAX ``GradScaler.update`` halves it."""
    jm, path = saved
    batch = _batch(6)
    big = 2.0 ** 40
    _, jgrads = _jax_scaled_grads(jm, batch, big)
    jfound = not all(np.isfinite(g).all() for g in jgrads.values())
    kw = dict(init_loss_scaling=SCALE, decr_every_n_nan_or_inf=1, incr_every_n_steps=2)
    jscaler = jamp.GradScaler(**kw)
    tm = _port_model(path).train()
    # a small lr: at 0.1 one step fits the batch and the second loss is 0
    opt = port_opt.Momentum(learning_rate=1e-3, momentum=0.9, parameters=tm.parameters())
    scaler = pamp.GradScaler(**kw)
    x, y = (torch.from_numpy(a) for a in batch)

    def step():
        with pamp.auto_cast(level="O1", dtype="float16"):
            loss = F.cross_entropy(tm(x), y).mean()
        scaler.minimize(opt, scaler.scale(loss))
        opt.clear_grad()

    step()
    jscaler._found_inf = False
    jscaler.update()
    assert not scaler._found_inf and opt._accumulators
    params = {n: p.detach().clone() for n, p in tm.named_parameters()}
    moments = {k: [t.clone() for t in v] for k, v in opt._accumulators.items()}
    stats = {n: b_.clone() for n, b_ in tm.named_buffers()}
    scaler.set_loss_scaling(big)
    jscaler.set_loss_scaling(big)
    step()
    jscaler._found_inf = jfound
    jscaler.update()
    assert jfound and scaler._found_inf
    assert scaler.get_loss_scaling() == jscaler.get_loss_scaling() == big / 2
    assert scaler.state_dict() == jscaler.state_dict()
    assert all(torch.equal(p.detach(), params[n]) for n, p in tm.named_parameters())
    assert all(torch.equal(a, b_) for k, v in opt._accumulators.items()
               for a, b_ in zip(v, moments[k]))
    moved = [n for n, b_ in tm.named_buffers() if b_.is_floating_point()
             and not torch.equal(b_, stats[n])]
    assert moved and all(torch.isfinite(b_).all() for b_ in tm.buffers())


# -- the kernel entries on meta fp16 tensors --------------------------------------------


class _NoCard(RuntimeError):
    pass


class _FakeLib:
    """A library whose entries record their symbol and raise for want of a
    card (the GEMM's tile rows answered)."""

    def __init__(self, picked):
        self.picked = picked

    def __getattr__(self, symbol):
        if symbol.endswith("tile_rows"):
            return lambda: 128

        def fn(*args):
            self.picked.append(symbol)
            raise _NoCard("no card to launch on")
        fn.argtypes = True
        return fn


def _meta_calls(m=256 * 40):
    meta = dict(device="meta", dtype=torch.float16)
    p2, w2 = torch.empty(m, 152, **meta), torch.empty(152, 64, **meta)
    # one tile of layer4's K = 4608: the planner splits K
    p2k, w2k = torch.empty(256, 4608, **meta), torch.empty(4608, 64, **meta)
    co = torch.empty(m, 64, **meta)
    v = torch.empty(64, device="meta")
    x = torch.empty(2, 64, 16, 16, **meta)
    y = torch.empty(2, 64, 8, 8, **meta)
    return {
        "mm_affine_relu": lambda: tcbr.mm_affine_relu(p2, w2, v, v),
        "mm_affine_relu_split": lambda: tcbr.mm_affine_relu(p2k, w2k, v, v),
        "mm_stats": lambda: tcbr.mm_stats(p2, w2),
        "centered_sumsq": lambda: tcbr.centered_sumsq(co, v),
        "bn_relu": lambda: tcbr.bn_relu(co, v, v),
        "bn_bwd_partials": lambda: tcbr.bn_bwd_partials(co, co, v, v),
        "bn_bwd_dco": lambda: tcbr.bn_bwd_dco(co, co, v, v, v, v),
        "max_pool2d_backward": lambda: tpb.max_pool2d_backward(x, y, y, (3, 3), (2, 2), (1, 1)),
    }


FP16_SYMBOLS = {"mm_affine_relu": "ptt_conv_mm_f16_affine_relu",
                "mm_affine_relu_split": "ptt_conv_mm_f16_affine_relu_split",
                "mm_stats": "ptt_conv_mm_f16_stats",
                "centered_sumsq": "ptt_bn_centered_sumsq_f16", "bn_relu": "ptt_bn_relu_f16",
                "bn_bwd_partials": "ptt_bn_bwd_partials_f16",
                "bn_bwd_dco": "ptt_bn_bwd_dco_f16",
                "max_pool2d_backward": "ptt_max_pool2d_backward_f16"}


@pytest.mark.parametrize("entry", list(FP16_SYMBOLS))
def test_fp16_entries_pick_the_fp16_symbols_on_meta_tensors(monkeypatch, entry):
    """On ``meta`` fp16 tensors each entry passes its dtype check and
    refuses the device (no plain version, no ``TypeError``); past the
    device check it binds its fp16 symbol and raises for want of a card
    there (split-K where the tiles leave the card empty)."""
    with pytest.raises(ValueError, match="CUDA"):
        _meta_calls()[entry]()
    picked = []
    monkeypatch.setattr(tcbr, "_on_kernel", lambda name, mats, vecs, n: True)
    monkeypatch.setattr(tpb, "_on_card", lambda x, tensors: None)
    for mod in (tcbr, tpb):
        monkeypatch.setattr(mod._build, "library", lambda name: _FakeLib(picked))
    monkeypatch.setattr(tcbr, "_sm_count", lambda index: 132)
    monkeypatch.setattr(tcbr, "_counters", lambda device, count: torch.empty(count,
                                                                             device="meta"))
    monkeypatch.setattr(tcbr, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: type(
        "S", (), {"cuda_stream": 0})())
    with pytest.raises(_NoCard):
        _meta_calls()[entry]()
    assert picked == [FP16_SYMBOLS[entry]]


def test_fp16_counts_apart_and_plain_versions_count_nothing():
    """The seven fp16 counts stand in ``KERNEL_COUNTERS`` beside the f32 and
    bf16 ones; the plain versions run on CPU fp16 tensors count none."""
    conv = ("mm_affine_relu", "mm_stats", "centered_sumsq", "bn_relu", "bn_bwd_partials",
            "bn_bwd_dco")
    for name in conv:
        assert port_cuda.KERNEL_COUNTERS[f"conv_bn_relu_{name}_fp16"] == (
            tcbr, f"FP16_{name.upper()}_LAUNCHES")
    assert port_cuda.KERNEL_COUNTERS["max_pool2d_backward_fp16"] == (tpb, "FP16_LAUNCHES")
    before = port_cuda.counts()
    x, w, g, b, m, v, dy = _operands("7x7_s2")
    tcbr.conv_bn_relu(_h(x).requires_grad_(), _h(w), torch.from_numpy(g), torch.from_numpy(b),
                      torch.from_numpy(m), torch.from_numpy(v), stride=2, padding=3,
                      training=True)[0].sum().backward()
    xp = torch.relu(_h(x))
    tpb.max_pool2d_backward(xp, *[torch.nn.functional.max_pool2d(xp.float(), 3, 2, 1).half()] * 2,
                            (3, 3), (2, 2), (1, 1))
    assert port_cuda.counts() == before
