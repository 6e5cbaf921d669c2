"""Port parity: automatic mixed precision (``paddle_tpu_torch.amp``).

The port's AMP against the JAX package's (``paddle_tpu.amp``), on the CPU:

- the two op lists, the scopes (O1, O2's cast-all, custom lists, nesting,
  ``enable=False``) cast as the JAX hook casts, op by op;
- ``GradScaler`` step for step against the JAX ``GradScaler`` over a run
  with injected infs, and ``decorate`` at O1 and O2;
- the dtype flow: (op type, input dtypes after the cast, output dtype) at
  every white- or black-listed op, every kernel op (``flash_attention``,
  ``fused_layernorm_residual``, ``fused_conv_bn_relu``) and the ops that
  carry their input's dtype (``layer_norm``, ``gelu``, ``lookup_table``,
  ``batch_norm``, ``pool2d``), in the order the forward dispatches them:
  the JAX side through a wrapper of its hook (``set_amp_hook``, restored
  after) and of ``apply_op`` for the outputs, the port's through
  ``set_amp_hook`` and wrappers of its op functions. Tiny BERT pretraining
  steps at O1 (flash and unfused attention) and O2, and a tiny ResNet
  forward and step at O1, through both packages' ``train_step``;
- the values of one tiny BERT step under ``auto_cast`` against the JAX
  package's, each limit set between the sound reading and the f32 answer
  and required to reject the f32 answer (``test_bert_step_values_match_jax``
  says why the JAX step runs op by op there, and why its FFN is relu).
"""
import contextlib
import math
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.ops as jax_ops  # noqa: E402
import paddle_tpu.optimizer as jax_opt  # noqa: E402
from paddle_tpu import amp as jamp  # noqa: E402
from paddle_tpu.framework import autograd as jax_autograd  # noqa: E402
from paddle_tpu.framework import jit as jax_jit  # noqa: E402
from paddle_tpu.framework.tensor import Tensor as JaxTensor  # noqa: E402
from paddle_tpu.models import BertForPretraining as JaxBertForPretraining  # noqa: E402
from paddle_tpu.models import BertPretrainingCriterion as JaxCriterion  # noqa: E402
from paddle_tpu.models import bert_tiny_config as jax_tiny_config  # noqa: E402
from paddle_tpu.models import resnet as jax_resnet  # noqa: E402
from paddle_tpu.nn import functional as jF  # noqa: E402
from paddle_tpu.nn import transformer as jax_tf  # noqa: E402
import paddle_tpu.ops.pallas.conv_bn_relu  # noqa: E402,F401

from paddle_tpu_torch import amp as pamp  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch import optimizer as port_opt  # noqa: E402
from paddle_tpu_torch.framework import autograd as port_autograd  # noqa: E402
from paddle_tpu_torch.framework.jit import train_step  # noqa: E402
from paddle_tpu_torch.models import BertForPretraining, BertPretrainingCriterion  # noqa: E402
from paddle_tpu_torch.models import bert_tiny_config, resnet as port_resnet  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.nn import transformer as port_tf  # noqa: E402
from paddle_tpu_torch.ops.cuda import conv_bn_relu as tcbr  # noqa: E402
from paddle_tpu_torch.ops.cuda import flash_attention as tfa  # noqa: E402
from paddle_tpu_torch.ops.cuda import layernorm_residual as tlnr  # noqa: E402

torch.set_num_threads(1)


def _dtype_name(dt):
    name = str(dt).removeprefix("torch.")
    if "int" in name:
        return "int"  # the JAX package runs int32, the port int64
    return name


# -- lists and scopes -------------------------------------------------------------


def test_lists_are_the_jax_packages():
    assert pamp.WHITE_LIST == jamp.WHITE_LIST
    assert pamp.BLACK_LIST == jamp.BLACK_LIST
    assert set(pamp.__all__) == set(jamp.__all__)
    assert pamp.amp_guard is pamp.auto_cast


_OPS = ("linear", "matmul", "conv2d", "softmax", "cross_entropy", "reduce_mean", "layer_norm",
        "gelu", "flash_attention", "lookup_table", "fused_layernorm_residual", "exp")
_SCOPES = {
    "none": None,
    "O1": dict(),
    "O2": dict(level="O2"),
    "O1-custom-white": dict(custom_white_list={"softmax", "gelu"}),
    "O1-custom-black": dict(custom_black_list={"linear", "gelu"}),
    "O2-custom-black": dict(level="O2", custom_black_list={"layer_norm"}),
    "O1-white-beats-black": dict(custom_white_list={"exp"}, custom_black_list={"exp"}),
    "disabled": dict(enable=False),
}


def _scope(mod, spec):
    return contextlib.nullcontext() if spec is None else mod.auto_cast(**spec)


@pytest.mark.parametrize("scope", list(_SCOPES))
def test_scope_casts_every_op_as_the_jax_hook(scope):
    """Inside each scope every op casts float32, bfloat16 and integer
    inputs to what the JAX hook casts them to."""
    inputs = {"float32": (torch.zeros(3), jnp.zeros(3, jnp.float32)),
              "bfloat16": (torch.zeros(3, dtype=torch.bfloat16), jnp.zeros(3, jnp.bfloat16)),
              "int": (torch.zeros(3, dtype=torch.int64), jnp.zeros(3, jnp.int32))}
    for op in _OPS:
        for name, (t, j) in inputs.items():
            with _scope(pamp, _SCOPES[scope]):
                (got,) = port_autograd.amp_cast(op, [t])
            with _scope(jamp, _SCOPES[scope]):
                (want,) = jamp._hook(op, [j])
            assert _dtype_name(got.dtype) == _dtype_name(want.dtype), (scope, op, name)


def test_nested_scopes_restore_the_outer_one():
    def state(mod):
        scope = mod._enabled()
        if scope is None:
            return None
        return (_dtype_name(scope[0]), "gelu" in scope[1], "linear" in scope[1],
                "softmax" in scope[2])

    seen = {}
    for name, mod in (("port", pamp), ("jax", jamp)):
        trail = [state(mod)]
        with mod.auto_cast():
            trail.append(state(mod))
            with mod.auto_cast(level="O2"):
                trail.append(state(mod))
                with mod.amp_guard(enable=False):
                    trail.append(state(mod))
                with mod.auto_cast(custom_black_list={"linear"}):
                    trail.append(state(mod))
                trail.append(state(mod))
            trail.append(state(mod))
        trail.append(state(mod))
        seen[name] = trail
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] is None and seen["port"][-1] is None
    assert seen["port"][1] == seen["port"][-2] == ("bfloat16", False, True, True)
    assert seen["port"][2] == seen["port"][3] == seen["port"][5] == ("bfloat16", True, True, True)


def test_amp_cast_passes_none_and_keeps_the_tensor_without_a_scope():
    t = torch.zeros(2)
    assert pamp._enabled() is None
    got = port_autograd.amp_cast("linear", [t, None])
    assert got[0] is t and got[1] is None
    with pamp.auto_cast():
        x, none = port_autograd.amp_cast("linear", [t, None])
    assert x.dtype == torch.bfloat16 and none is None


def test_cast_carries_the_gradient_in_the_parameter_dtype():
    """The cast is ``Tensor.to``: an f32 weight used by a white op gets an
    f32 gradient, the bf16 gradient upcast."""
    w = torch.randn(4, 3, requires_grad=True)
    x = torch.randn(2, 4)
    with pamp.auto_cast():
        y = F.linear(x, w)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert w.grad.dtype == torch.float32
    assert torch.equal(w.grad, w.grad.bfloat16().float())


def test_float16_scope_and_bad_dtype():
    with pamp.auto_cast(dtype="float16"):
        (x,) = port_autograd.amp_cast("matmul", [torch.zeros(2)])
    assert x.dtype == torch.float16
    with pytest.raises(ValueError):
        with pamp.auto_cast(dtype="int8"):
            pass


# -- GradScaler -------------------------------------------------------------------


class _PortParam:
    def __init__(self, grad):
        self.grad = grad


class _JaxParam:
    def __init__(self, grad):
        self.grad = grad


class _Opt:
    """What the scalers read of an optimizer: the parameter list and step."""

    def __init__(self, params):
        self._parameter_list = params
        self.steps = 0

    def step(self):
        self.steps += 1

    def clear_grad(self):
        for p in self._parameter_list:
            p.grad = None


_SCALER_KW = dict(init_loss_scaling=1024.0, incr_every_n_steps=2, decr_every_n_nan_or_inf=2)


def test_grad_scaler_matches_jax_step_for_step():
    """Eight steps, the fourth and fifth with an inf and the sixth with a
    nan in one gradient: the scale, the good and bad step counts, the
    skipped optimizer steps and the unscaled gradients (bit for bit: both
    multiply by ``1 / scale``) agree after every step."""
    rng = np.random.RandomState(0)
    port, jax_ = pamp.GradScaler(**_SCALER_KW), jamp.GradScaler(**_SCALER_KW)
    popt, jopt = _Opt([]), _Opt([])
    for i in range(8):
        grads = [rng.randn(5).astype("f4") * 1000, rng.randn(3, 2).astype("f4") * 3000]
        if i in (3, 4):
            grads[1][1, 0] = np.inf
        if i == 5:
            grads[0][2] = np.nan
        popt._parameter_list = [_PortParam(torch.from_numpy(g.copy())) for g in grads]
        popt._parameter_list.append(_PortParam(None))  # a parameter without a gradient
        jopt._parameter_list = [_JaxParam(JaxTensor._from_array(jnp.asarray(g))) for g in grads]
        port.step(popt)
        jax_.step(jopt)
        assert port.get_loss_scaling() == jax_.get_loss_scaling(), i
        assert port._found_inf == jax_._found_inf, i
        assert port.state_dict() == jax_.state_dict(), i
        assert popt.steps == jopt.steps, i
        for p, j in zip(popt._parameter_list, jopt._parameter_list):
            np.testing.assert_array_equal(p.grad.numpy(), np.asarray(j.grad._array))
    assert popt.steps == 5  # the three bad steps were skipped
    assert port.get_loss_scaling() != 1024.0


def test_grad_scaler_scale_minimize_and_state_dict_round_trip():
    port, jax_ = pamp.GradScaler(**_SCALER_KW), jamp.AmpScaler(**_SCALER_KW)
    loss = np.float32(0.37)
    got = port.scale(torch.tensor(loss))
    want = jax_.scale(JaxTensor._from_array(jnp.asarray(loss)))
    assert float(got) == float(np.asarray(want._array))
    w = torch.tensor([1.0, 2.0], requires_grad=True)
    opt = _Opt([w])
    port.minimize(opt, port.scale((w * w).sum()))
    assert opt.steps == 1 and w.grad is None  # stepped, then cleared
    state = port.state_dict()
    other = pamp.AmpScaler()
    other.load_state_dict(state)
    assert other.state_dict()["scale"] == state["scale"]
    assert (other._good_steps, other._bad_steps) == (port._good_steps, port._bad_steps)
    other.set_loss_scaling(8.0)
    assert other.get_loss_scaling() == 8.0 and other.is_enable()


def test_disabled_scaler_passes_through():
    scaler = pamp.GradScaler(enable=False)
    t = torch.tensor(3.0)
    assert scaler.scale(t) is t
    g = torch.tensor([np.inf])
    opt = _Opt([_PortParam(g)])
    scaler.step(opt)
    assert opt.steps == 1 and opt._parameter_list[0].grad is g and not scaler._found_inf


# -- decorate ---------------------------------------------------------------------


def _tiny_bert():
    cfg = bert_tiny_config()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    return BertForPretraining(cfg, generator=torch.Generator().manual_seed(0))


def test_decorate_o1_leaves_the_model_and_o2_casts_its_parameters():
    m = _tiny_bert()
    assert pamp.decorate(m, level="O1") is m
    assert {p.dtype for p in m.parameters()} == {torch.float32}
    opt = port_opt.AdamW(parameters=m.parameters())
    got = pamp.decorate(m, opt, level="O2")
    assert got[0] is m and got[1] is opt
    assert {p.dtype for p in m.parameters()} == {torch.bfloat16}
    # the MLM decoder weight is still the word embedding table
    assert m.cls.decoder_weight is m.bert.embeddings.word_embeddings.weight
    kept = _tiny_bert()
    pamp.decorate(kept, level="O2", master_weight=True)
    assert {p.dtype for p in kept.parameters()} == {torch.float32}
    with pytest.raises(ValueError):
        pamp.decorate(m, level="O3")


def test_decorate_o2_keeps_running_buffers_f32_as_the_jax_package():
    tm = port_resnet.resnet18(num_classes=4)
    jm = jax_resnet.resnet18(num_classes=4)
    pamp.decorate(tm, level="O2")
    jamp.decorate(jm, level="O2")
    assert ({n: _dtype_name(p.dtype) for n, p in tm.named_parameters()}
            == {n: _dtype_name(p._array.dtype) for n, p in jm.named_parameters()})
    assert ({n: _dtype_name(b.dtype) for n, b in tm.named_buffers()}
            == {n: _dtype_name(b._array.dtype) for n, b in jm.named_buffers()})


def test_train_step_keeps_bf16_products_summed_in_f32():
    m = torch.nn.Linear(2, 2)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    train_step(m, port_opt.Momentum(parameters=m.parameters()), lambda m, x: m(x).sum(),
               device="cpu")
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False


# -- dtype flow -------------------------------------------------------------------

_KERNEL_OPS = {"flash_attention", "fused_layernorm_residual", "fused_conv_bn_relu"}
_CARRY_OPS = {"layer_norm", "gelu", "lookup_table", "batch_norm", "pool2d"}
_RECORDED = jamp.WHITE_LIST | jamp.BLACK_LIST | _KERNEL_OPS | _CARRY_OPS
# the port's op functions, wrapped to read their first output's dtype
_PORT_OPS = [(F, n) for n in ("linear", "matmul", "mean", "gelu", "softmax", "layer_norm",
                              "embedding", "dropout", "cross_entropy",
                              "softmax_with_cross_entropy", "conv2d", "batch_norm",
                              "max_pool2d")] + [(tfa, "flash_attention"),
                                                (tlnr, "layernorm_residual"),
                                                (tcbr, "conv_bn_relu")]


def _dtypes(xs):
    return tuple(_dtype_name(x.dtype) for x in xs if x is not None)


def _first_dtype(out):
    return _dtype_name((out[0] if isinstance(out, (tuple, list)) else out).dtype)


def _recorded(rec):
    return [tuple(r) for r in rec if r[0] in _RECORDED]


@contextlib.contextmanager
def _jax_flow(monkeypatch):
    """Records [op, input dtypes after the cast, first output dtype] of
    every op the JAX package dispatches: its hook wrapped through
    ``set_amp_hook`` (restored after), ``apply_op`` wrapped for the
    output."""
    rec = []
    hook, apply_op = jax_autograd._amp_hook, jax_autograd.apply_op

    def recording_hook(op_type, arrays):
        out = hook(op_type, arrays)
        rec.append([op_type, _dtypes(out)])
        return out

    def recording_apply_op(op_type, *args, **kw):
        n = len(rec)
        out = apply_op(op_type, *args, **kw)
        rec[n].append(_first_dtype(out))
        return out

    monkeypatch.setattr(jax_autograd, "apply_op", recording_apply_op)
    monkeypatch.setattr(jax_ops, "apply_op", recording_apply_op)
    jax_autograd.set_amp_hook(recording_hook)
    try:
        yield rec
    finally:
        jax_autograd.set_amp_hook(hook)


@contextlib.contextmanager
def _port_flow(monkeypatch):
    """The same record of the port's ops: its hook wrapped through
    ``set_amp_hook``, its op functions for the output (models built inside
    the block, so that layers holding an op function hold the wrapper)."""
    rec = []
    hook = port_autograd._amp_hook

    def recording_hook(op_type, tensors):
        out = hook(op_type, tensors)
        rec.append([op_type, _dtypes(out)])
        return out

    def wrap(fn):
        def call(*args, **kw):
            n = len(rec)
            out = fn(*args, **kw)
            if len(rec) > n:  # dispatched (dropout at p = 0 is not, as in the JAX package)
                rec[n].append(_first_dtype(out))
            return out
        return call

    for mod, name in _PORT_OPS:
        monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    port_autograd.set_amp_hook(recording_hook)
    try:
        yield rec
    finally:
        port_autograd.set_amp_hook(hook)


B, L, P = 2, 16, 3


def _bert_batch(cfg, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, cfg.vocab_size, (B, L)).astype("int64")
    ids[1, 11:] = cfg.pad_token_id  # a padded row: the bias masks its tail
    types = (np.arange(L)[None, :] >= L // 2).astype("int64").repeat(B, 0)
    pos = np.stack([rng.choice(L - 6, P, replace=False) + i * L for i in range(B)]).ravel()
    mlm = rng.randint(0, cfg.vocab_size, (B * P,)).astype("int64")
    mlm[1] = -100  # an ignored label counts nowhere
    nsp = rng.randint(0, 2, (B, 1)).astype("int64")
    return [ids, types, pos.astype("int64"), mlm, nsp]


def _bert_config(cls, flash=True, act="gelu"):
    cfg = cls()
    cfg.use_flash_attention = flash
    cfg.hidden_act = act
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _bert_loss_fn(crit, amp_mod, level):
    """``loss_fn(model, *batch)`` for either package's train step: the
    forward and the loss under ``amp_mod.auto_cast(level=level)``."""
    def loss_fn(m, ids, types, pos, mlm, nsp):
        with amp_mod.auto_cast(level=level):
            pred, rel = m(ids, types, masked_positions=pos)
            return crit(pred, rel, mlm, nsp)
    return loss_fn


def _resnet_loss_fn(amp_mod, functional):
    def loss_fn(m, x, y):
        with amp_mod.auto_cast():
            return functional.cross_entropy(m(x), y)
    return loss_fn


def _jax_step_flow(monkeypatch, model, opt, loss_fn, batch):
    """The ops of one JAX ``train_step`` (run op by op, ``jit=False``): its
    first call also runs a probe forward, so the second is recorded."""
    step = jax_jit.train_step(model, opt, loss_fn, jit=False)
    step(*batch)
    with _jax_flow(monkeypatch) as rec:
        step(*batch)
    return _recorded(rec)


def _port_step_flow(monkeypatch, build, make_opt, loss_fn, batch):
    with _port_flow(monkeypatch) as rec:
        model = build()
        step = train_step(model, make_opt(model), loss_fn, jit=False, device="cpu")
        step(*[torch.from_numpy(a) for a in batch])
    return _recorded(rec)


@pytest.mark.parametrize("flash,level", [(True, "O1"), (False, "O1"), (True, "O2")])
def test_bert_step_dtype_flow_matches_jax(monkeypatch, flash, level):
    """Tiny BERT pretraining through both ``train_step``s under
    ``auto_cast``: every recorded op in the same order with the same input
    and output dtypes. With flash on (the threshold lowered in both) the
    flash and fused-LayerNorm ops carry the layer-0 mixed case (a bf16
    attention output on the f32 embedding output) at O1; flash off runs the
    unfused attention's two ``matmul``s and its ``softmax``; O2 decorates
    both models first."""
    if flash:
        monkeypatch.setattr(jax_tf, "FLASH_ATTENTION_MIN_SEQ", 1)
        monkeypatch.setattr(port_tf, "FLASH_ATTENTION_MIN_SEQ", 1)
    jcfg = _bert_config(jax_tiny_config, flash)
    batch = _bert_batch(jcfg)
    paddle.seed(0)
    jm = JaxBertForPretraining(jcfg)
    if level == "O2":
        jamp.decorate(jm, level="O2")
    jopt = jax_opt.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    want = _jax_step_flow(monkeypatch, jm, jopt,
                          _bert_loss_fn(JaxCriterion(jcfg.vocab_size), jamp, level), batch)

    def build():
        m = BertForPretraining(_bert_config(bert_tiny_config, flash),
                               generator=torch.Generator().manual_seed(0))
        return pamp.decorate(m, level="O2") if level == "O2" else m

    got = _port_step_flow(
        monkeypatch, build, lambda m: port_opt.AdamW(learning_rate=1e-3,
                                                     parameters=m.parameters()),
        _bert_loss_fn(BertPretrainingCriterion(jcfg.vocab_size), pamp, level), batch)
    assert got == want
    ops = [r[0] for r in got]
    assert ops.count("linear") == 2 * 6 + 3 and ops.count("cross_entropy") == 2
    assert ops.count("flash_attention") == (2 if flash else 0)
    assert ops.count("matmul") == (1 if flash else 5) and ops.count("softmax") == (0 if flash
                                                                                  else 2)
    if flash and level == "O1":
        mixed = [r for r in got if r[0] == "fused_layernorm_residual"]
        assert mixed[0] == ("fused_layernorm_residual",
                            ("bfloat16", "float32", "float32", "float32"), "bfloat16")
        assert mixed[1][1][:2] == ("bfloat16", "bfloat16")


RN_B, RN_HW, RN_CLASSES = 2, 32, 4


def _rn_batch():
    rng = np.random.RandomState(0)
    return [rng.randn(RN_B, 3, RN_HW, RN_HW).astype("f4"),
            rng.randint(0, RN_CLASSES, (RN_B,)).astype("int64")]


def test_resnet_forward_dtype_flow_matches_jax(monkeypatch):
    """A tiny ResNet-18's eval forward under O1: the fused conv + batch
    norm + relu takes bf16 x and weight with f32 gamma, beta and
    statistics; the unfused convs run bf16 and their batch norms carry
    bf16; the classifier's ``linear`` is bf16 and the loss f32."""
    x, y = _rn_batch()
    paddle.seed(0)
    jm = jax_resnet.resnet18(num_classes=RN_CLASSES)
    jm.eval()
    with _jax_flow(monkeypatch) as jrec:
        with jamp.auto_cast():
            jF.cross_entropy(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
    with _port_flow(monkeypatch) as prec:
        tm = port_resnet.resnet18(num_classes=RN_CLASSES)
        tm.eval()
        with torch.no_grad(), pamp.auto_cast():
            F.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y))
    got, want = _recorded(prec), _recorded(jrec)
    assert got == want
    assert got[0] == ("fused_conv_bn_relu", ("bfloat16", "bfloat16") + ("float32",) * 4,
                      "bfloat16")
    assert ("conv2d", ("bfloat16", "bfloat16"), "bfloat16") in got
    assert got[-1] == ("cross_entropy", ("float32", "int"), "float32")


def test_resnet_step_dtype_flow_matches_jax(monkeypatch):
    """The same ResNet-18 through both ``train_step``s (train mode: batch
    statistics) with Momentum, under O1."""
    batch = _rn_batch()
    paddle.seed(0)
    jm = jax_resnet.resnet18(num_classes=RN_CLASSES)
    jopt = jax_opt.Momentum(learning_rate=0.1, momentum=0.9, parameters=jm.parameters())
    want = _jax_step_flow(monkeypatch, jm, jopt, _resnet_loss_fn(jamp, jF), batch)
    got = _port_step_flow(
        monkeypatch, lambda: port_resnet.resnet18(num_classes=RN_CLASSES),
        lambda m: port_opt.Momentum(learning_rate=0.1, momentum=0.9, parameters=m.parameters()),
        _resnet_loss_fn(pamp, F), batch)
    assert got == want
    assert sum(r[0] == "fused_conv_bn_relu" for r in got) == 1 + 8


# -- values -----------------------------------------------------------------------

# One tiny-BERT step under O1, the port against the JAX package, each limit
# about the geometric mean of the sound reading (in brackets) and the f32
# answer's (the port without auto_cast, which must fail it), read on the CPU:
# the loss (bit-equal / 1.6e-4; 1 f32 ulp of the loss, 4.8e-7, stands for
# the sound reading), the gradient's relative L2 error over every parameter
# (4.6e-3 / 3.2e-2) and each gradient entry relative to the largest entry of
# its layer (3.7e-2 / 0.19: bf16 keeps 8 bits, and a gradient of the bias
# of a layer sums rows that round on either side of a bf16 step).
AMP_LOSS_ATOL = 1e-5
AMP_GRAD_REL_L2 = 1.2e-2
AMP_GRAD_ATOL_OF_LAYER_MAX = 8e-2


def _layer_relative_errors(got, want):
    layer_max = {}
    for name, g in want.items():
        layer = name.rsplit(".", 1)[0]
        layer_max[layer] = max(layer_max.get(layer, 0.0), float(np.abs(g).max()))
    return {n: float(np.abs(got[n] - g).max()) / max(layer_max[n.rsplit(".", 1)[0]], 1e-30)
            for n, g in want.items()}


def _rel_l2(got, want):
    num = sum(float(np.square(got[n].astype("f8") - g.astype("f8")).sum()) for n, g in want.items())
    den = sum(float(np.square(g.astype("f8")).sum()) for g in want.values())
    return math.sqrt(num / den)


def test_bert_step_values_match_jax(monkeypatch, tmp_path):
    """The loss and every gradient of one tiny-BERT pretraining step under
    O1 (flash on, the threshold lowered in both, dropout 0), the weights
    carried by ``paddle_tpu.save`` and ``convert``, against the JAX
    package's step: the loss its ``train_step`` returns and the gradients
    of that step's own construction (``jax.value_and_grad`` over
    ``_swapped_model``).

    The JAX step runs op by op (``jit=False``): jitted on the CPU, XLA
    fuses chains of bf16 ops and keeps f32 between them, which moves its
    answer as far from the op-by-op one as the f32 answer is, so no limit
    could tell the cast from its absence. The FFN activation is relu: the
    JAX package's bf16 gelu is ``jax.nn.gelu``'s chain of bf16 primitives,
    each rounding, where torch rounds its gelu once; that alone moves the
    gradients as far as the f32 answer (the gelu op is held to 1 bf16 ulp in
    ``test_gelu_bf16_is_the_jax_op_within_an_ulp``). With relu the two
    packages round at the same points and the loss agrees bit for bit."""
    monkeypatch.setattr(jax_tf, "FLASH_ATTENTION_MIN_SEQ", 1)
    monkeypatch.setattr(port_tf, "FLASH_ATTENTION_MIN_SEQ", 1)
    jcfg = _bert_config(jax_tiny_config, act="relu")
    batch = _bert_batch(jcfg)
    paddle.seed(0)
    jm = JaxBertForPretraining(jcfg)
    path = str(tmp_path / "bert.pdparams")
    paddle.save(jm.state_dict(), path)

    jloss_fn = _bert_loss_fn(JaxCriterion(jcfg.vocab_size), jamp, "O1")
    params = {n: p._array for n, p in jm.named_parameters()}

    def loss_of(params):
        state = {"params": params, "frozen": {}, "buffers": {}}
        with jax_jit._swapped_model(jm, state), jax_autograd.no_grad():
            loss = jloss_fn(jm, *[JaxTensor._from_array(jnp.asarray(a)) for a in batch])
        return loss._array

    want_loss, want = jax.value_and_grad(loss_of)(params)
    want = {n: np.asarray(g, dtype="f4") for n, g in want.items()}
    jopt = jax_opt.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    step_loss = jax_jit.train_step(jm, jopt, jloss_fn, jit=False)(*batch)["loss"]
    assert float(np.asarray(step_loss)) == float(want_loss)

    def port(amp_on):
        m = convert.load_bert_pretraining(path, _bert_config(bert_tiny_config, act="relu"))
        crit = BertPretrainingCriterion(jcfg.vocab_size)
        loss_fn = _bert_loss_fn(crit, pamp if amp_on else _NoAmp, "O1")
        loss = loss_fn(m, *[torch.from_numpy(a) for a in batch])
        loss.backward()
        return float(loss.detach()), {n: p.grad.numpy() for n, p in m.named_parameters()}

    def errors(answer):
        loss, grads = answer
        assert set(grads) == set(want)
        return (abs(loss - float(want_loss)), _rel_l2(grads, want),
                max(_layer_relative_errors(grads, want).values()))

    limits = (AMP_LOSS_ATOL, AMP_GRAD_REL_L2, AMP_GRAD_ATOL_OF_LAYER_MAX)
    sound, control = errors(port(True)), errors(port(False))
    assert all(e <= lim for e, lim in zip(sound, limits)), (sound, limits)
    assert all(e > lim for e, lim in zip(control, limits)), (control, limits)


class _NoAmp:
    """An ``amp`` module whose scope casts nothing: the f32 control."""

    auto_cast = staticmethod(lambda **kw: contextlib.nullcontext())


def _ulp(a):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126))) - 7)


def test_gelu_bf16_is_the_jax_op_within_an_ulp():
    """bf16 in, bf16 out, each entry within 1 bf16 ulp of the JAX op's
    (which rounds after each primitive of ``jax.nn.gelu``; the port's
    gelu rounds once), or of the input where the output is far smaller
    than it: for x below about -3 the output underflows by cancellation and
    the two differ by up to 252 ulps of the output, 1 of the input (read at
    x = -8.69: -0.0 against -1.4e-17, the exact value ~-1.5e-17)."""
    x = np.random.RandomState(0).randn(64, 96).astype("f4") * 3
    xb = torch.from_numpy(x).bfloat16()
    with pamp.auto_cast():
        got = F.gelu(xb)
    want = np.asarray(jax_ops.gelu(paddle.to_tensor(x).astype("bfloat16"))._array
                      .astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    bound = np.maximum(_ulp(want), _ulp(xb.float().numpy()))
    assert np.all(np.abs(got.float().numpy() - want) <= bound)


def test_layer_norm_carries_bf16_with_f32_statistics():
    """The ``layer_norm`` op on a bf16 input with f32 parameters (the MLM
    head under O1): bf16 out, equal to the JAX op's to 1 bf16 ulp of the
    largest output (both normalize in f32 and round once)."""
    rng = np.random.RandomState(1)
    x, w, b = rng.randn(8, 128).astype("f4"), rng.randn(128).astype("f4"), rng.randn(128).astype("f4")
    xb = torch.from_numpy(x).bfloat16()
    with pamp.auto_cast():
        got = F.layer_norm(xb, 128, torch.from_numpy(w), torch.from_numpy(b))
        want = jF.layer_norm(paddle.to_tensor(x).astype("bfloat16"), 128,
                             paddle.to_tensor(w), paddle.to_tensor(b))
    want = np.asarray(want._array.astype(jnp.float32))
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "float32"
    assert np.abs(got.float().numpy() - want).max() <= _ulp(np.abs(want).max())


# the package exports a function of the module's name
_jax_cbr = sys.modules["paddle_tpu.ops.pallas.conv_bn_relu"]


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("geom", [(2, 3, 17, 8, 3, 2, 1), (2, 16, 8, 32, 1, 1, 0),
                                  (2, 8, 9, 16, 3, 1, 1)])
def test_fused_conv_bf16_plain_versions_match_jax_reference(training, geom):
    """The fused conv + batch norm + relu on bf16 x and weight (f32 gamma,
    beta and statistics), as ``fused_conv_bn_relu`` hands it under O1:
    the port's plain versions against the JAX package's ``_reference`` in
    bf16 (its unfused sequence), forward and ``jax.vjp``. The output
    matches to 1 bf16 ulp of its largest entry (read: bit for bit), the
    running statistics to 1e-6, dx and dw to 4 ulps of their largest entry
    (read: 2; the port folds the patches' gradients back in bf16 where XLA
    sums them in f32), dgamma and dbeta to 1e-5 of theirs (f32 sums in
    another order)."""
    n, c, h, co, k, s, p = geom
    rng = np.random.RandomState(0)
    x = rng.randn(n, c, h, h).astype("f4")
    w = (rng.randn(co, c, k, k) * 0.3).astype("f4")
    g, b = (1 + 0.1 * rng.randn(co)).astype("f4"), (0.1 * rng.randn(co)).astype("f4")
    m, v = (0.1 * rng.randn(co)).astype("f4"), (1 + 0.1 * rng.rand(co)).astype("f4")
    oh = (h + 2 * p - k) // s + 1
    dy = rng.randn(n, co, oh, oh).astype("f4")
    kw = dict(stride=s, padding=p, training=training, momentum=0.9, eps=1e-5,
              data_format="NCHW")
    jin = [jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16),
           jnp.asarray(g), jnp.asarray(b)]
    jy, jm, jv = _jax_cbr._reference(*jin, jnp.asarray(m), jnp.asarray(v), **kw)
    _, vjp = jax.vjp(lambda *a: _jax_cbr._reference(*a, jnp.asarray(m), jnp.asarray(v), **kw)[0],
                     *jin)
    jgrads = vjp(jnp.asarray(dy).astype(jnp.bfloat16))
    ts = [torch.from_numpy(x).bfloat16().requires_grad_(),
          torch.from_numpy(w).bfloat16().requires_grad_(),
          torch.from_numpy(g).requires_grad_(), torch.from_numpy(b).requires_grad_()]
    y, nm, nv = tcbr.conv_bn_relu(*ts, torch.from_numpy(m), torch.from_numpy(v), stride=s,
                                  padding=p, training=training, momentum=0.9, epsilon=1e-5)
    y.backward(torch.from_numpy(dy).bfloat16())
    jy = np.asarray(jy.astype(jnp.float32))
    assert y.dtype == torch.bfloat16 and nm.dtype == nv.dtype == torch.float32
    assert np.abs(y.detach().float().numpy() - jy).max() <= _ulp(np.abs(jy).max())
    np.testing.assert_allclose(nm.numpy(), np.asarray(jm), atol=1e-6, rtol=0)
    np.testing.assert_allclose(nv.numpy(), np.asarray(jv), atol=1e-6, rtol=0)
    for t, jg in zip(ts, jgrads):
        jg = np.asarray(jg.astype(jnp.float32))
        assert t.grad.dtype == t.dtype
        top = np.abs(jg).max()
        bound = 4 * _ulp(top) if t.dtype == torch.bfloat16 else 1e-5 * top
        assert np.abs(t.grad.float().numpy() - jg).max() <= bound


def test_pinned_names_have_the_pinned_signatures():
    """The five ``paddle_tpu.amp`` names ``tools/api_spec.txt`` pins, with
    their signatures, resolve in the port."""
    import inspect
    import os

    spec = os.path.join(os.path.dirname(__file__), os.pardir, "tools", "api_spec.txt")
    pinned = {}
    with open(spec) as f:
        for line in f:
            if line.startswith("paddle_tpu.amp."):
                name, _, sig = line.strip().removeprefix("paddle_tpu.amp.").partition("(")
                pinned[name] = "(" + sig
    assert set(pinned) == {"auto_cast", "amp_guard", "GradScaler", "AmpScaler", "decorate"}
    for name, sig in pinned.items():
        assert str(inspect.signature(getattr(pamp, name))) == sig, name
