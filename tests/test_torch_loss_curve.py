"""Port parity: the loss curve of bench's CPU-smoke BERT against the JAX package's.

bench.py's CPU-smoke pretraining config (``bench.py:204-213``: vocabulary
8192, 4 layers, 256 wide, 8 heads, 1024 inner, 128 positions; batch 8 x
128 with 20 masked positions a row; AdamW at lr 1e-4; the loss of the f32
logits), at dropout 0, from the JAX package's seeded weights (carried by
``convert``), for 10 steps of each package's ``train_step`` on one batch.

The limits come from a control run by the test itself: the JAX package's
own f32 curve against its O1 (``auto_cast``, bf16) curve, the largest
relative gap over the 10 losses (1.04e-4 when written).

- f32 against f32: within :data:`F32_RTOL` (read 2.2e-7), which the
  control must exceed: the limit would catch a curve as far off as bf16
  is from f32.
- O1 against O1: within :data:`O1_OF_CONTROL` times the control (read
  1.6 times it). The port rounds every bf16 op's output to bf16, where
  XLA:CPU keeps a fusion's elementwise intermediates in f32, so its O1
  curve sits farther from the JAX O1 curve than that one from f32; the
  first loss, from identical weights, already differs by 6e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.optimizer as jax_opt  # noqa: E402
from paddle_tpu import amp as jax_amp  # noqa: E402
from paddle_tpu.framework import jit as jax_jit  # noqa: E402
from paddle_tpu.models import BertConfig as JaxBertConfig  # noqa: E402
from paddle_tpu.models import BertForPretraining as JaxBertForPretraining  # noqa: E402
from paddle_tpu.models import BertPretrainingCriterion as JaxCriterion  # noqa: E402

from paddle_tpu_torch import amp, convert  # noqa: E402
from paddle_tpu_torch import optimizer as port_opt  # noqa: E402
from paddle_tpu_torch.framework.jit import train_step  # noqa: E402
from paddle_tpu_torch.models import BertConfig, BertForPretraining, BertPretrainingCriterion  # noqa: E402

torch.set_num_threads(1)

STEPS = 10
BATCH, SEQ, N_PRED, VOCAB = 8, 128, 20, 8192
F32_RTOL = 5e-6  # about the geometric mean of the reading 2.2e-7 and the control 1.04e-4
O1_OF_CONTROL = 3.0


def _config(cls):
    cfg = cls(vocab_size=VOCAB, hidden_size=256, num_hidden_layers=4, num_attention_heads=8,
              intermediate_size=1024, max_position_embeddings=128, use_flash_attention=False)
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(1, VOCAB, (BATCH, SEQ)).astype("int64")
    types = rng.randint(0, 2, (BATCH, SEQ)).astype("int64")
    pos = np.stack([rng.choice(SEQ, N_PRED, replace=False) + i * SEQ for i in range(BATCH)])
    mlm = rng.randint(0, VOCAB, (BATCH * N_PRED,)).astype("int64")
    nsp = rng.randint(0, 2, (BATCH, 1)).astype("int64")
    return [ids, types, pos.ravel().astype("int64"), mlm, nsp]


def _loss_fn(crit, cast, scope):
    def loss_fn(m, ids, types, pos, mlm, nsp):
        if scope is None:
            pred, rel = m(ids, types, masked_positions=pos)
        else:
            with scope():
                pred, rel = m(ids, types, masked_positions=pos)
        return crit(cast(pred), cast(rel), mlm, nsp)
    return loss_fn


@pytest.fixture(scope="module")
def jax_curves():
    """(weights, {"f32": losses, "O1": losses}) of the JAX package, with
    its own setting of 64-bit types off."""
    curves, weights = {}, None
    with jax.enable_x64(False):
        for level in ("O1", "f32"):
            paddle.seed(0)
            jm = JaxBertForPretraining(_config(JaxBertConfig))
            if weights is None:
                weights = {n: np.asarray(p._array) for n, p in jm.named_parameters()}
            loss_fn = _loss_fn(JaxCriterion(VOCAB), lambda t: t.astype("float32"),
                               jax_amp.auto_cast if level == "O1" else None)
            step = jax_jit.train_step(jm, jax_opt.AdamW(learning_rate=1e-4,
                                                        parameters=jm.parameters()), loss_fn)
            batch = _batch()
            curves[level] = np.array([float(np.asarray(step(*batch)["loss"]))
                                      for _ in range(STEPS)])
    return weights, curves


def _port_curve(weights, level):
    tm = BertForPretraining(_config(BertConfig))
    tm.load_state_dict(convert.bert_pretraining_state_from_numpy(weights, tm))
    loss_fn = _loss_fn(BertPretrainingCriterion(VOCAB), lambda t: t.float(),
                       amp.auto_cast if level == "O1" else None)
    step = train_step(tm, port_opt.AdamW(learning_rate=1e-4, parameters=tm.parameters()),
                      loss_fn, jit=True, device="cpu")
    batch = _batch()
    return np.array([float(step(*batch)["loss"]) for _ in range(STEPS)])


def _gap(a, b):
    return float(np.abs((a - b) / b).max())


def test_f32_loss_curve_matches_jax(jax_curves):
    weights, curves = jax_curves
    control = _gap(curves["f32"], curves["O1"])
    got = _port_curve(weights, "f32")
    assert _gap(got, curves["f32"]) <= F32_RTOL, (got, curves["f32"])
    assert control > F32_RTOL, control
    assert got[-1] < got[0] - 1.0  # the curve falls


def test_o1_loss_curve_matches_jax(jax_curves):
    weights, curves = jax_curves
    control = _gap(curves["f32"], curves["O1"])
    got = _port_curve(weights, "O1")
    assert _gap(got, curves["O1"]) <= O1_OF_CONTROL * control, (got, curves["O1"], control)
    assert got[-1] < got[0] - 1.0
