"""Port parity: the BERT pretraining step (``paddle_tpu_torch`` training slice).

A tiny ``BertForPretraining`` with flash attention on
(``FLASH_ATTENTION_MIN_SEQ`` lowered in both packages, so both take their
flash and fused-LayerNorm paths) and dropout 0. The JAX model's weights
cross through ``paddle_tpu.save`` and the port's reader
(``convert.load_bert_pretraining``); its optimizer state through
``convert.adamw_state_from_numpy``; the inputs are the same numpy arrays.
The JAX loss and gradients come from ``jax.value_and_grad`` over the JAX
model (its train step's own construction), jitted to keep the file fast.
"""
import copy
from collections import OrderedDict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.optimizer as jax_opt  # noqa: E402
from paddle_tpu.framework import autograd as jax_autograd  # noqa: E402
from paddle_tpu.framework import jit as jax_jit  # noqa: E402
from paddle_tpu.framework.tensor import Parameter as JaxParameter  # noqa: E402
from paddle_tpu.framework.tensor import Tensor as JaxTensor  # noqa: E402
from paddle_tpu.models import BertForPretraining as JaxBertForPretraining  # noqa: E402
from paddle_tpu.models import BertPretrainingCriterion as JaxCriterion  # noqa: E402
from paddle_tpu.models import bert_tiny_config as jax_tiny_config  # noqa: E402
from paddle_tpu.nn import transformer as jax_tf  # noqa: E402

import paddle_tpu_torch  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch import optimizer as port_opt  # noqa: E402
from paddle_tpu_torch.framework import random as port_random  # noqa: E402
from paddle_tpu_torch.framework.jit import train_step  # noqa: E402
from paddle_tpu_torch.models import (  # noqa: E402
    BertForPretraining,
    BertPretrainingCriterion,
    bert_tiny_config,
)
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.nn import transformer as port_tf  # noqa: E402
from paddle_tpu_torch.ops.cuda import flash_attention as tfa  # noqa: E402
from paddle_tpu_torch.ops.cuda import layernorm_residual as tlnr  # noqa: E402

torch.set_num_threads(1)

# f32 forward and backward through 2 layers in another summation order
LOSS_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_ATOL_OF_MAX = 2e-4  # of the largest gradient entry of the parameter's layer
B, L, P = 2, 16, 3


def _config(cls):
    cfg = cls()
    cfg.use_flash_attention = True
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _batch(cfg, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, cfg.vocab_size, (B, L)).astype("int64")
    ids[1, 11:] = cfg.pad_token_id  # a padded row: the flash bias masks its tail
    types = (np.arange(L)[None, :] >= L // 2).astype("int64").repeat(B, 0)
    pos = np.stack([rng.choice(L - 6, P, replace=False) + i * L for i in range(B)]).ravel()
    mlm = rng.randint(0, cfg.vocab_size, (B * P,)).astype("int64")
    mlm[1] = -100  # an ignored label counts nowhere
    nsp = rng.randint(0, 2, (B, 1)).astype("int64")
    return [ids, types, pos.astype("int64"), mlm, nsp]


@pytest.fixture
def _flash_everywhere(monkeypatch):
    monkeypatch.setattr(jax_tf, "FLASH_ATTENTION_MIN_SEQ", 1)
    monkeypatch.setattr(port_tf, "FLASH_ATTENTION_MIN_SEQ", 1)


@pytest.fixture
def saved(tmp_path, _flash_everywhere):
    paddle.seed(0)
    jm = JaxBertForPretraining(_config(jax_tiny_config))
    path = str(tmp_path / "bert_pretraining_tiny.pdparams")
    paddle.save(jm.state_dict(), path)
    return jm, path


def _loss_fn(crit):
    """``loss_fn(model, *batch)`` for either package's train step."""
    def loss_fn(m, ids, types, pos, mlm, nsp):
        pred, rel = m(ids, types, masked_positions=pos)
        return crit(pred, rel, mlm, nsp)
    return loss_fn


def _jax_loss_and_grads(jm, batch):
    """Loss and gradient by parameter name of the JAX model."""
    loss_fn = _loss_fn(JaxCriterion(jm.bert.config.vocab_size))
    params = OrderedDict((n, p._array) for n, p in jm.named_parameters())

    def loss_of(params):
        state = {"params": params, "frozen": OrderedDict(), "buffers": OrderedDict()}
        with jax_jit._swapped_model(jm, state), jax_autograd.no_grad():
            loss = loss_fn(jm, *[JaxTensor._from_array(jnp.asarray(a)) for a in batch])
        return loss._array

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(params)
    return float(loss), {n: np.asarray(g) for n, g in grads.items()}


def _port_model(path):
    return convert.load_bert_pretraining(path, _config(bert_tiny_config))


def test_state_dict_names_the_tied_weight_once_in_both_packages(saved):
    """The JAX state dict lists the MLM decoder weight only under the word
    embeddings (it is the same parameter); so does the port's, and the
    port's head reads that very tensor."""
    jm, path = saved
    tm = _port_model(path)
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert "cls.decoder_weight" not in jm.state_dict()
    assert tm.cls.decoder_weight is tm.bert.embeddings.word_embeddings.weight
    # parameter order decides the optimizer's accumulator indices
    assert [n for n, _ in tm.named_parameters()] == [n for n, _ in jm.named_parameters()]


def test_tie_survives_copies_and_conversions(saved):
    import copy

    _, path = saved
    tm = copy.deepcopy(_port_model(path)).double()
    assert tm.cls.decoder_weight is tm.bert.embeddings.word_embeddings.weight
    assert tm.cls.decoder_weight.dtype == torch.float64


def test_tied_weight_listed_twice_must_agree(saved):
    jm, path = saved
    state = {k: np.asarray(v) for k, v in paddle_tpu_torch.load(path, return_numpy=True).items()}
    tm = _port_model(path)
    twice = dict(state, **{"cls.decoder_weight": state["bert.embeddings.word_embeddings.weight"]})
    assert set(convert.bert_pretraining_state_from_numpy(twice, tm)) == set(state)
    twice["cls.decoder_weight"] = twice["cls.decoder_weight"] + 1.0
    with pytest.raises(ValueError, match="tied"):
        convert.bert_pretraining_state_from_numpy(twice, tm)


def test_loss_and_every_gradient_match_jax(saved):
    jm, path = saved
    batch = _batch(_config(bert_tiny_config))
    want_loss, want_grads = _jax_loss_and_grads(jm, batch)
    tm = _port_model(path).train()
    crit = BertPretrainingCriterion(tm.bert.config.vocab_size)
    loss = _loss_fn(crit)(tm, *map(torch.from_numpy, batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, **LOSS_TOL)
    # each gradient against the largest entry of its layer: some are zero up
    # to rounding (the key projection's bias; softmax ignores a row shift)
    scale = {}
    for name, g in want_grads.items():
        layer = name.rpartition(".")[0]
        scale[layer] = max(scale.get(layer, 0.0), float(np.abs(g).max()))
    for name, p in tm.named_parameters():
        assert p.grad is not None, name
        err = np.abs(p.grad.numpy() - want_grads[name]).max()
        assert err <= GRAD_ATOL_OF_MAX * scale[name.rpartition(".")[0]], (name, err)


def _three_adamw_losses(jm, path, jit):
    """The losses of three AdamW steps on one batch through the JAX and the
    port's ``train_step`` with the same ``jit``."""
    batch = _batch(_config(bert_tiny_config), seed=2)
    jstep = jax_jit.train_step(jm, jax_opt.AdamW(learning_rate=1e-3, parameters=jm.parameters()),
                               _loss_fn(JaxCriterion(jm.bert.config.vocab_size)), jit=jit)
    want = [float(np.asarray(jstep(*batch)["loss"])) for _ in range(3)]
    tm = _port_model(path)
    tstep = train_step(tm, port_opt.AdamW(learning_rate=1e-3, parameters=tm.parameters()),
                       _loss_fn(BertPretrainingCriterion(tm.bert.config.vocab_size)),
                       jit=jit, device="cpu")
    got = [float(tstep(*batch)["loss"]) for _ in range(3)]
    assert tstep.sync() is tstep
    assert got[2] < got[0]
    return got, want


def test_three_adamw_steps_match_jax_train_step(saved):
    """Each package's eager step (``jit=False``), the optimizer's scalars
    Python numbers in both."""
    jm, path = saved
    got, want = _three_adamw_losses(jm, path, jit=False)
    # Adam turns rounding-level gradient differences into lr-sized steps
    # on near-zero gradients, so three steps agree to ~1e-4, not to ulps
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


# the compiled steps' three losses (about 7.8): read 4.8e-7, 0, 0 apart with
# 64-bit types off in JAX, the package's own setting; with them on (this
# harness's) the JAX step's bias correction is float64, the parent's
# arithmetic, and they read 4.8e-7, 4.8e-6, 7.6e-6 apart
COMPILED_LOSS_ATOL = 2e-6


def test_three_adamw_steps_match_jax_train_step_compiled(saved, tmp_path):
    """The ``jit=True`` twin: the port's compiled step against the JAX
    compiled step, whose traced int32 step count and float32 lr make
    AdamW's bias correction and ``lr * coeff`` float32 computations, as the
    port's device scalars do. With the repaired scalars the three losses
    agree 100 times closer than the eager steps' limit; the JAX step with
    float64 bias corrections (64-bit types on) is the control beyond it."""
    jm, path = saved
    control = copy.deepcopy(jm)
    with jax.enable_x64(False):
        got, want = _three_adamw_losses(jm, path, jit=True)
    np.testing.assert_allclose(got, want, atol=COMPILED_LOSS_ATOL, rtol=0)
    _, want_f64 = _three_adamw_losses(control, path, jit=True)
    assert max(abs(a - b) for a, b in zip(got, want_f64)) > COMPILED_LOSS_ATOL


def _twin_params(seed=0, shapes=((5, 7), (7,), (3, 4, 2))):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(*s).astype("f4") for s in shapes]
    grads = [[rng.randn(*s).astype("f4") * 10.0 ** -k for s in shapes] for k in range(3)]
    jp = [JaxParameter.from_array(a, name=f"param_{i}") for i, a in enumerate(arrays)]
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in arrays]
    return jp, tp, grads


@pytest.mark.parametrize("kind", ["Adam", "AdamW", "AdamW_decay_fun"])
def test_optimizer_matches_jax_on_identical_gradients(kind):
    """The update itself, free of the gradients' rounding: the same
    gradients into both packages' optimizers give the same parameters to
    f32 rounding, step after step (the expression order is the JAX one)."""
    jp, tp, grads = _twin_params()
    kw = {}
    if kind == "AdamW_decay_fun":
        kw = dict(apply_decay_param_fun=lambda name: name != "param_1")
    jcls = getattr(jax_opt, kind.split("_")[0])
    tcls = getattr(port_opt, kind.split("_")[0])
    extra = dict(weight_decay=0.1) if kind != "Adam" else {}
    jo = jcls(learning_rate=0.01, parameters=jp, **extra, **kw)
    named = [(f"param_{i}", p) for i, p in enumerate(tp)]
    to = tcls(learning_rate=0.01, parameters=named, **extra, **kw)
    for step_grads in grads:
        for p, g in zip(jp, step_grads):
            p.grad = JaxTensor._from_array(jnp.asarray(g))
        for p, g in zip(tp, step_grads):
            p.grad = torch.from_numpy(g.copy())
        jo.step()
        to.step()
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(a._array), atol=1e-7,
                                       rtol=1e-7)
    state = to.state_dict()
    assert state["global_step"] == 3 and set(state) >= {"moment1_0", "moment2_2"}


def test_jax_adamw_state_continues_the_same_trajectory(saved, tmp_path):
    """Two JAX steps, then its weights and AdamW state carried into the
    port: the port's next steps give the JAX package's next losses."""
    jm, _ = saved
    batch = _batch(_config(bert_tiny_config), seed=3)
    jo = jax_opt.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    jstep = jax_jit.train_step(jm, jo, _loss_fn(JaxCriterion(jm.bert.config.vocab_size)))
    for _ in range(2):
        jstep(*batch)
    jstep.sync()
    path = str(tmp_path / "after_two.pdparams")
    paddle.save(jm.state_dict(), path)
    opt_state = jo.state_dict()
    want = [float(np.asarray(jstep(*batch)["loss"])) for _ in range(2)]

    tm = _port_model(path)
    to = port_opt.AdamW(learning_rate=1e-3, parameters=tm.parameters())
    to.set_state_dict(convert.adamw_state_from_numpy(opt_state, to))
    assert to._global_step == 2
    tstep = train_step(tm, to, _loss_fn(BertPretrainingCriterion(tm.bert.config.vocab_size)),
                       device="cpu")
    got = [float(tstep(*batch)["loss"]) for _ in range(2)]
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


def test_adamw_state_shape_mismatch_raises(saved):
    _, path = saved
    tm = _port_model(path)
    to = port_opt.AdamW(parameters=tm.parameters())
    n = len(list(tm.parameters()))
    state = {"global_step": 1}
    for name in ("moment1", "moment2"):
        state.update({f"{name}_{i}": np.zeros(tuple(p.shape), "f4")
                      for i, p in enumerate(tm.parameters())})
    state["moment1_0"] = np.zeros((3,), "f4")
    with pytest.raises(ValueError, match="moment1_0"):
        convert.adamw_state_from_numpy(state, to)
    del state["moment2_%d" % (n - 1)]
    state["moment1_0"] = np.zeros(tuple(next(tm.parameters()).shape), "f4")
    with pytest.raises(KeyError, match="moment2"):
        convert.adamw_state_from_numpy(state, to)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_jax_with_ignored_labels(reduction):
    rng = np.random.RandomState(4)
    logits = rng.randn(6, 11).astype("f4")
    labels = rng.randint(0, 11, (6,)).astype("int64")
    labels[[1, 4]] = -100
    want = paddle.nn.functional.cross_entropy(paddle.to_tensor(logits), paddle.to_tensor(labels),
                                              reduction=reduction).numpy()
    got = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                          reduction=reduction).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    per = F.softmax_with_cross_entropy(torch.from_numpy(logits),
                                       torch.from_numpy(labels[:, None]))
    want_per = paddle.nn.functional.softmax_with_cross_entropy(
        paddle.to_tensor(logits), paddle.to_tensor(labels[:, None])).numpy()
    np.testing.assert_allclose(per.numpy(), want_per, atol=1e-6, rtol=1e-6)


def test_dropout_draws_from_its_generator_not_the_global_one():
    x = torch.ones(64, 64)
    a = F.dropout(x, 0.5, generator=torch.Generator().manual_seed(5))
    torch.manual_seed(123)  # the global generator plays no part
    b = F.dropout(x, 0.5, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert set(torch.unique(a).tolist()) == {0.0, 2.0}
    port_random.seed(7)
    c = F.dropout(x, 0.5)
    port_random.seed(7)
    torch.manual_seed(321)
    assert torch.equal(F.dropout(x, 0.5), c)
    assert torch.equal(F.dropout(x, 0.5, training=False), x)


def test_train_step_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = torch.nn.Linear(2, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_step(model, port_opt.Adam(parameters=model.parameters()), lambda m, x: m(x).sum())


def test_training_launches_both_kernel_routes(monkeypatch, _flash_everywhere):
    """With the kernel entries standing in for the card (they run the plain
    versions and count), a training step goes through every forward and
    backward entry: 2 LayerNorm pairs and 1 attention a layer."""
    calls = {}

    def counting(name, fn):
        def f(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return f

    monkeypatch.setattr(tlnr, "layernorm_residual_fwd",
                        counting("ln_fwd", tlnr.layernorm_residual_fwd))
    monkeypatch.setattr(tlnr, "layernorm_residual_bwd",
                        counting("ln_bwd", tlnr.layernorm_residual_bwd))
    monkeypatch.setattr(tfa, "_use_kernel", lambda q: True)
    monkeypatch.setattr(tfa, "flash_attention_fwd", counting("fa_fwd", tfa._plain_fwd))
    plain_bwd = tfa._plain_bwd
    monkeypatch.setattr(tfa, "flash_attention_bwd_dq", counting(
        "fa_dq", lambda q, k, v, b, lse, delta, do, *a: plain_bwd(q, k, v, b, None, lse, do,
                                                                 *a)[0]))
    monkeypatch.setattr(tfa, "flash_attention_bwd_dkv", counting(
        "fa_dkv", lambda q, k, v, b, lse, delta, do, *a: plain_bwd(q, k, v, b, None, lse, do,
                                                                  *a)[1:]))
    cfg = bert_tiny_config()  # dropout 0.1 everywhere
    cfg.use_flash_attention = True
    tm = BertForPretraining(cfg, generator=torch.Generator().manual_seed(0))
    step = train_step(tm, port_opt.AdamW(parameters=tm.parameters()),
                      _loss_fn(BertPretrainingCriterion(cfg.vocab_size)), device="cpu")
    loss = float(step(*_batch(cfg))["loss"])
    layers = cfg.num_hidden_layers
    assert np.isfinite(loss)
    assert calls == {"ln_fwd": 2 * layers, "ln_bwd": 2 * layers, "fa_fwd": layers,
                     "fa_dq": layers, "fa_dkv": layers}
    assert all(p.grad is not None for p in tm.parameters())
