"""Port parity: ERNIE (``paddle_tpu_torch.models.bert``'s ERNIE names).

ERNIE 1.0 is the BERT encoder with relu and an 18,000-token vocabulary; its
own part is the knowledge masking of its pretraining data. A tiny
``ErnieForPretraining`` with flash attention on (``FLASH_ATTENTION_MIN_SEQ``
lowered in both packages) built by the JAX package from a seed; its
weights cross through ``paddle_tpu.save`` and ``convert.load_ernie_pretraining``.
The span rule of ``knowledge_masking`` is held bit for bit against the JAX
function on the JAX function's own uniform draw, and its semantics as
``tests/test_models.py`` states them for the JAX package.
"""
import dataclasses
import inspect
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.models import ErnieForPretraining as JaxErnieForPretraining  # noqa: E402
from paddle_tpu.models import ErnieModel as JaxErnieModel  # noqa: E402
from paddle_tpu.models import ernie_base_config as jax_ernie_base_config  # noqa: E402
from paddle_tpu.models import knowledge_masking as jax_knowledge_masking  # noqa: E402
from paddle_tpu.models.bert import BertConfig as JaxBertConfig  # noqa: E402
from paddle_tpu.nn import transformer as jax_tf  # noqa: E402

import paddle_tpu_torch.models  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch.models import BertConfig, ErnieForPretraining, ErnieModel  # noqa: E402
from paddle_tpu_torch.models import bert as port_bert  # noqa: E402
from paddle_tpu_torch.models import ernie_base_config, knowledge_masking  # noqa: E402
from paddle_tpu_torch.nn import transformer as port_tf  # noqa: E402

torch.set_num_threads(1)

# f32 through 2 layers of the flash path in another summation order
TOL = dict(atol=1e-4, rtol=1e-4)
SPANS = np.array([[1, 1, 1, 0, 0, 2, 2, 0, 0, 3, 3, 3]] * 4)


def _tiny(cls):
    return cls(vocab_size=512, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
               intermediate_size=128, max_position_embeddings=64, hidden_act="relu",
               hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
               use_flash_attention=True)


@pytest.fixture(autouse=True)
def _x64_off():
    """The JAX side with 64-bit types off, the JAX package's own setting
    (this harness turns them on)."""
    with jax.enable_x64(False):
        yield


@pytest.fixture
def _flash_everywhere(monkeypatch):
    monkeypatch.setattr(jax_tf, "FLASH_ATTENTION_MIN_SEQ", 1)
    monkeypatch.setattr(port_tf, "FLASH_ATTENTION_MIN_SEQ", 1)


@pytest.fixture
def saved(tmp_path, _flash_everywhere):
    paddle.seed(0)
    jm = JaxErnieForPretraining(_tiny(JaxBertConfig))
    jm.eval()
    path = str(tmp_path / "ernie_tiny.pdparams")
    paddle.save(jm.state_dict(), path)
    return jm, path


def _ids(b=2, l=16, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 512, (b, l)).astype("int64")
    ids[1, 11:] = 0  # a padded row
    return ids


def test_ernie_base_config_is_the_jax_packages():
    """Every field the port's config has equals the JAX one's (the JAX
    config also names its sequence-parallel attention, not ported)."""
    got, want = dataclasses.asdict(ernie_base_config()), dataclasses.asdict(
        jax_ernie_base_config())
    assert set(want) - set(got) == {"sp_attention"}
    assert got == {k: want[k] for k in got}
    cfg = ernie_base_config()
    assert (cfg.hidden_act, cfg.vocab_size, cfg.hidden_size, cfg.num_hidden_layers) == (
        "relu", 18000, 768, 12)


@pytest.mark.parametrize("name,extended", [
    ("ErnieModel", True), ("ErnieForPretraining", True), ("ernie_base_config", False),
    ("knowledge_masking", False)])
def test_pinned_signatures(name, extended):
    """Each name has ``tools/api_spec.txt``'s signature, the models with
    ``generator`` and ``device`` before ``**kwargs``."""
    spec = os.path.join(os.path.dirname(__file__), os.pardir, "tools", "api_spec.txt")
    with open(spec) as f:
        line = next(ln for ln in f if ln.startswith(f"paddle_tpu.models.{name}("))
    want = line.strip().removeprefix(f"paddle_tpu.models.{name}")
    if extended:
        want = want.replace(", **kwargs)", ", generator=None, device=None, **kwargs)")
    assert str(inspect.signature(getattr(paddle_tpu_torch.models, name))) == want


def test_default_models_are_ernie_base():
    m = ErnieModel(device="meta")
    assert m.config.vocab_size == 18000 and m.config.hidden_act == "relu"
    assert m.embeddings.word_embeddings.weight.shape == (18000, 768)
    p = ErnieForPretraining(device="meta")
    assert p.cls.decoder_bias.shape == (18000,)


def test_tiny_ernie_pretraining_matches_jax_through_saved_weights(saved):
    jm, path = saved
    tm = convert.load_ernie_pretraining(path, _tiny(BertConfig)).eval()
    assert isinstance(tm, ErnieForPretraining)
    ids = _ids()
    pos = np.array([1, 4, 7, 16 + 2, 16 + 9], "int64")
    w_pred, w_rel = jm(paddle.to_tensor(ids), masked_positions=paddle.to_tensor(pos))
    with torch.no_grad():
        pred, rel = tm(torch.from_numpy(ids), masked_positions=torch.from_numpy(pos))
    assert pred.shape == (5, 512)
    np.testing.assert_allclose(pred.numpy(), np.asarray(w_pred.numpy()), **TOL)
    np.testing.assert_allclose(rel.numpy(), np.asarray(w_rel.numpy()), **TOL)


def test_tiny_ernie_model_matches_jax(tmp_path, _flash_everywhere):
    paddle.seed(1)
    jm = JaxErnieModel(_tiny(JaxBertConfig))
    jm.eval()
    path = str(tmp_path / "ernie_model.pdparams")
    paddle.save(jm.state_dict(), path)
    tm = convert.load_bert(path, _tiny(BertConfig))
    twin = ErnieModel(_tiny(BertConfig))
    twin.load_state_dict(tm.state_dict())
    twin.eval()
    ids = _ids(seed=3)
    w_seq, w_pooled = jm(paddle.to_tensor(ids))
    with torch.no_grad():
        seq, pooled = twin(torch.from_numpy(ids))
    np.testing.assert_allclose(seq.numpy(), np.asarray(w_seq.numpy()), **TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(w_pooled.numpy()), **TOL)


def _random_spans(rng, b, l):
    """Span ids as an entity tagger makes them: runs of one id > 0, single
    tokens 0, ids reused across a row and runs of equal ids side by side."""
    spans = np.zeros((b, l), "int64")
    for r in range(b):
        j = 0
        while j < l:
            n = rng.randint(1, 5)
            spans[r, j:j + n] = rng.randint(0, 4)
            j += n
    return spans


@pytest.mark.parametrize("seed", range(4))
def test_span_rule_is_bit_equal_to_the_jax_scan_on_its_draw(seed):
    """The port's span rule on the JAX function's own uniform draw gives
    the JAX mask bit for bit, on spans with one-token spans, reused ids and
    several spans of one id side by side."""
    rng = np.random.RandomState(seed)
    spans = SPANS if seed == 0 else _random_spans(rng, 6, 40)
    ids = rng.randint(5, 512, spans.shape)
    key = jax.random.PRNGKey(seed)
    for p in (0.15, 0.5):
        _, w_mask = jax_knowledge_masking(jnp.asarray(ids), jnp.asarray(spans), mask_id=3,
                                          key=key, mask_prob=p)
        draw = np.asarray(jax.random.uniform(key, ids.shape))
        got = port_bert._span_mask(torch.from_numpy(spans), torch.from_numpy(draw), p)
        np.testing.assert_array_equal(got.numpy(), np.asarray(w_mask))


def test_span_rule_at_the_threshold():
    """A head's draw equal to ``mask_prob`` rounded to f32 is not masked,
    the f32 value just below it is: both packages compare the f32 draw
    with ``mask_prob`` in f32 (a weak float in JAX)."""
    p = 0.15
    at = np.float32(p)
    draw = np.array([[at, 0.9, np.nextafter(at, np.float32(0)), 0.9]], "f4")
    got = port_bert._span_mask(torch.tensor([[1, 1, 2, 2]]), torch.from_numpy(draw), p)
    assert got.tolist() == [[False, False, True, True]]
    assert np.asarray(jnp.asarray(draw) < p).tolist() == [[False, False, True, False]]


def test_knowledge_masking_span_semantics():
    """``tests/test_models.py``'s ERNIE test, on the port: members of a span
    share the decision, some spans are masked at p = 0.5, masked ids are
    the mask id and the rest are kept; the draw comes from ``key``."""
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(5, 512, (4, 12)))
    spans = torch.from_numpy(SPANS)
    masked, mask = knowledge_masking(ids, spans, mask_id=3,
                                     key=torch.Generator().manual_seed(1), mask_prob=0.5)
    mask = mask.numpy()
    for row in mask:
        assert row[0] == row[1] == row[2]
        assert row[5] == row[6]
        assert row[9] == row[10] == row[11]
    assert mask.any() and not mask.all()
    assert (masked.numpy()[mask] == 3).all()
    np.testing.assert_array_equal(masked.numpy()[~mask], ids.numpy()[~mask])
    again, mask2 = knowledge_masking(ids, spans, 3, torch.Generator().manual_seed(1), 0.5)
    assert torch.equal(again, masked) and (mask2.numpy() == mask).all()
    assert masked.dtype == ids.dtype


def test_ernie_with_flash_raises_on_meta_tensors(_flash_everywhere):
    """Off the CPU the flash and LayerNorm kernels must run: on ``meta``
    tensors the forward raises instead of running the plain versions."""
    tm = ErnieForPretraining(_tiny(BertConfig)).to("meta")
    ids = torch.zeros(2, 16, dtype=torch.int64, device="meta")
    with pytest.raises((ValueError, RuntimeError), match="CUDA"):
        tm(ids)
