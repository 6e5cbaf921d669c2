"""Port parity: BERT end to end (``paddle_tpu_torch.models.bert``).

A tiny BERT with flash attention on and ``FLASH_ATTENTION_MIN_SEQ``
lowered in both packages, so both take their flash and fused-LayerNorm
paths. The JAX model's weights cross through ``paddle_tpu.save`` and the
port's own reader (``paddle_tpu_torch.convert.load_bert``), never through
re-seeding; the inputs are the same numpy arrays.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.models import BertModel as JaxBert  # noqa: E402
from paddle_tpu.models import bert_tiny_config as jax_tiny_config  # noqa: E402
from paddle_tpu.nn import transformer as jax_tf  # noqa: E402

from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch.inference import Predictor  # noqa: E402
from paddle_tpu_torch.jit_api import InputSpec  # noqa: E402
from paddle_tpu_torch.models import BertModel, bert_tiny_config  # noqa: E402
from paddle_tpu_torch.nn import TransformerEncoderLayer  # noqa: E402
from paddle_tpu_torch.nn import transformer as port_tf  # noqa: E402

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def _flash_everywhere(monkeypatch):
    monkeypatch.setattr(jax_tf, "FLASH_ATTENTION_MIN_SEQ", 1)
    monkeypatch.setattr(port_tf, "FLASH_ATTENTION_MIN_SEQ", 1)


def _ids(cfg, b=3, l=16, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, cfg.vocab_size, (b, l)).astype("int64")
    ids[1:, l // 2:] = cfg.pad_token_id  # rows ending in padding
    ids[b - 1, 3:] = cfg.pad_token_id
    types = (np.arange(l)[None, :] >= l // 2).astype("int64").repeat(b, 0)
    return ids, types


@pytest.fixture
def _saved_tiny_bert(tmp_path, _flash_everywhere):
    cfg = jax_tiny_config()
    cfg.use_flash_attention = True
    paddle.seed(0)
    jm = JaxBert(cfg)
    jm.eval()
    path = str(tmp_path / "bert_tiny.pdparams")
    paddle.save(jm.state_dict(), path)
    return jm, path


def test_tiny_bert_matches_jax_through_saved_weights(_saved_tiny_bert):
    jm, path = _saved_tiny_bert
    cfg = bert_tiny_config()
    cfg.use_flash_attention = True
    tm = convert.load_bert(path, cfg).eval()
    ids, types = _ids(cfg)
    js, jp = jm(paddle.to_tensor(ids), paddle.to_tensor(types))
    with torch.inference_mode():
        ts, tp = tm(torch.from_numpy(ids), torch.from_numpy(types))
    np.testing.assert_allclose(ts.numpy(), js.numpy(), **TOL)
    np.testing.assert_allclose(tp.numpy(), jp.numpy(), **TOL)


def test_predictor_serves_the_jax_answer(_saved_tiny_bert):
    """The same weights behind the port's Predictor on the CPU."""
    jm, path = _saved_tiny_bert
    cfg = bert_tiny_config()
    cfg.use_flash_attention = True
    specs = [InputSpec([None, 16], "int64", "input_ids"),
             InputSpec([None, 16], "int64", "token_type_ids")]
    pred = Predictor(convert.load_bert(path, cfg), specs,
                     ["sequence_output", "pooled_output"], device="cpu")
    ids, types = _ids(cfg, b=2, seed=4)
    seq, pooled = pred.run([ids, types])
    js, jp = jm(paddle.to_tensor(ids), paddle.to_tensor(types))
    np.testing.assert_allclose(seq, js.numpy(), **TOL)
    np.testing.assert_allclose(pooled, jp.numpy(), **TOL)


@pytest.mark.parametrize("fused,normalize_before",
                         [(True, False), (False, False), (True, True)])
def test_encoder_layer_matches_jax(fused, normalize_before, _flash_everywhere):
    """One encoder layer, post-norm with the fused LayerNorm flag on and
    off and pre-norm, in both packages; weights moved by state dict."""
    from paddle_tpu.flags import set_flags as jax_set_flags
    from paddle_tpu_torch.flags import set_flags

    paddle.seed(5)
    jl = paddle.nn.TransformerEncoderLayer(64, 4, 128, dropout=0.0, activation="gelu",
                                           normalize_before=normalize_before,
                                           use_flash_attention=True)
    jl.eval()
    tl = TransformerEncoderLayer(64, 4, 128, dropout=0.0, activation="gelu",
                                 normalize_before=normalize_before,
                                 use_flash_attention=True).eval()
    tl.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jl.state_dict().items()})
    rng = np.random.RandomState(6)
    x = rng.randn(2, 9, 64).astype("f4")
    mask = np.zeros((2, 1, 1, 9), "f4")
    mask[1, ..., 6:] = -1e4
    try:
        jax_set_flags({"use_fused_layernorm": fused})
        set_flags({"use_fused_layernorm": fused})
        want = jl(paddle.to_tensor(x), paddle.to_tensor(mask)).numpy()
        with torch.inference_mode():
            got = tl(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    finally:
        jax_set_flags({"use_fused_layernorm": True})
        set_flags({"use_fused_layernorm": True})
    np.testing.assert_allclose(got, want, **TOL)


def test_flash_and_plain_attention_agree_in_the_port(monkeypatch):
    """MultiHeadAttention through the flash dispatch == the plain path."""
    from paddle_tpu_torch.nn import MultiHeadAttention

    monkeypatch.setattr(port_tf, "FLASH_ATTENTION_MIN_SEQ", 1)
    g = torch.Generator().manual_seed(0)
    flash = MultiHeadAttention(32, 4, use_flash_attention=True, generator=g).eval()
    plain = MultiHeadAttention(32, 4).eval()
    plain.load_state_dict(flash.state_dict())
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 16, 32).astype("f4"))
    bool_mask = torch.ones(2, 16, 16, dtype=torch.bool)
    bool_mask[0, :, 12:] = False
    with torch.inference_mode():
        for mask in (None, bool_mask):
            np.testing.assert_allclose(flash(x, attn_mask=mask).numpy(),
                                       plain(x, attn_mask=mask).numpy(), atol=1e-5, rtol=1e-5)


def test_seeded_init_is_reproducible():
    a = BertModel(bert_tiny_config(), generator=torch.Generator().manual_seed(3))
    b = BertModel(bert_tiny_config(), generator=torch.Generator().manual_seed(3))
    for (n, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), n
    w = a.encoder.layers[0].linear1.weight
    assert w.shape == (128, 512)  # Paddle's [in, out] layout
    assert float(w.detach().abs().max()) <= 2 * 0.02  # truncated at 2 sigma


def test_convert_rejects_foreign_state():
    cfg = bert_tiny_config()
    model = BertModel(cfg)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    state["encoder.layers.0.linear1.weight"] = state["encoder.layers.0.linear1.weight"].T
    with pytest.raises(ValueError, match="linear1"):
        convert.bert_state_from_numpy(state, model)
    del state["pooler.dense.bias"]
    with pytest.raises(KeyError, match="pooler.dense.bias"):
        convert.bert_state_from_numpy(state, model)
