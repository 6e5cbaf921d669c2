"""``MultiHeadAttention``'s ``kdim``/``vdim`` and ``need_weights`` in the port
against the JAX package's (``paddle_tpu/nn/transformer.py:238-337``).

A cross-attention whose keys and values have their own widths, built by the
JAX package from a seed and carried into the port by
``convert.attention_state_from_numpy``; the same numpy inputs. Outputs and
weights agree within 1e-5, with no cache and with the concat cache, and
with dropout 0 and 0.1 in eval mode. In training mode with dropout 0.1 the
returned weights are the ones after dropout: the output is their product
with the values. ``need_weights`` never takes the flash kernel."""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.nn import transformer as jax_tf
from paddle_tpu_torch import convert
from paddle_tpu_torch.nn import transformer as port_tf

torch.set_num_threads(1)

E, H, KDIM, VDIM, B, LQ, LK = 16, 4, 12, 20, 2, 5, 7
ATOL = 1e-5


def _pair(kdim, vdim, dropout=0.0, need_weights=True):
    jpaddle.seed(0)
    jm = jax_tf.MultiHeadAttention(E, H, dropout=dropout, kdim=kdim, vdim=vdim,
                                   need_weights=need_weights)
    tm = port_tf.MultiHeadAttention(E, H, dropout=dropout, kdim=kdim, vdim=vdim,
                                    need_weights=need_weights, device="cpu")
    np_state = {n: np.asarray(p.numpy()) for n, p in jm.state_dict().items()}
    tm.load_state_dict(convert.attention_state_from_numpy(np_state, tm))
    jm.eval()
    tm.eval()
    return jm, tm


def _inputs(kdim, vdim, seed=1):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, LQ, E).astype(np.float32)
    k = rng.randn(B, LK, kdim or E).astype(np.float32)
    v = rng.randn(B, LK, vdim or E).astype(np.float32)
    mask = np.where(rng.rand(B, LQ, LK) < 0.2, -1e9, 0.0).astype(np.float32)
    return q, k, v, mask


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.numpy())


def test_projections_take_the_key_and_value_widths():
    _, tm = _pair(KDIM, VDIM)
    assert tuple(tm.k_proj.weight.shape) == (KDIM, E)
    assert tuple(tm.v_proj.weight.shape) == (VDIM, E)
    assert tuple(tm.q_proj.weight.shape) == tuple(tm.out_proj.weight.shape) == (E, E)


def test_a_wrong_width_refuses_to_load():
    jpaddle.seed(0)
    jm = jax_tf.MultiHeadAttention(E, H, kdim=KDIM, vdim=VDIM)
    tm = port_tf.MultiHeadAttention(E, H, kdim=VDIM, vdim=VDIM, device="cpu")
    np_state = {n: np.asarray(p.numpy()) for n, p in jm.state_dict().items()}
    with pytest.raises(ValueError, match="k_proj"):
        convert.attention_state_from_numpy(np_state, tm)


@pytest.mark.parametrize("kdim,vdim", [(KDIM, VDIM), (None, VDIM), (KDIM, None)])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("need_weights", [False, True])
def test_output_and_weights_equal_the_jax_layers(kdim, vdim, dropout, need_weights):
    jm, tm = _pair(kdim, vdim, dropout, need_weights)
    q, k, v, mask = _inputs(kdim, vdim)
    want = jm(jpaddle.to_tensor(q), jpaddle.to_tensor(k), jpaddle.to_tensor(v),
              jpaddle.to_tensor(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                 torch.from_numpy(mask))
    if not need_weights:
        want, got = (want,), (got,)
    assert len(got) == len(want) == 1 + need_weights
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=ATOL, rtol=0)
    if need_weights:
        assert tuple(got[1].shape) == (B, H, LQ, LK)


def test_with_a_cache_new_cache_comes_last():
    jm, tm = _pair(KDIM, VDIM)
    q, k, v, _ = _inputs(KDIM, VDIM)
    rng = np.random.RandomState(3)
    pk = rng.randn(B, H, 3, E // H).astype(np.float32)
    pv = rng.randn(B, H, 3, E // H).astype(np.float32)
    want = jm(jpaddle.to_tensor(q), jpaddle.to_tensor(k), jpaddle.to_tensor(v), None,
              (jpaddle.to_tensor(pk), jpaddle.to_tensor(pv)))
    with torch.no_grad():
        got = tm(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), None,
                 (torch.from_numpy(pk), torch.from_numpy(pv)))
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), atol=ATOL, rtol=0)
    assert tuple(got[1].shape) == (B, H, LQ, 3 + LK)
    for g, w in zip(got[2], want[2]):
        np.testing.assert_allclose(_np(g), _np(w), atol=ATOL, rtol=0)


def test_training_weights_are_after_dropout():
    _, tm = _pair(KDIM, VDIM, dropout=0.1)
    tm.train()
    q, k, v, _ = _inputs(KDIM, VDIM)
    torch.manual_seed(5)
    with torch.no_grad():
        out, weights = tm(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
        vh = tm._shape(tm.v_proj(torch.from_numpy(v)))
        again = tm.out_proj((weights @ vh).transpose(1, 2).reshape(B, LQ, E))
    w = weights.numpy()
    assert (w == 0).any()  # dropped entries
    sums = w.sum(-1)
    assert not np.allclose(sums, 1.0, atol=1e-4)  # kept ones scaled by 1 / 0.9
    np.testing.assert_allclose(out.numpy(), again.numpy(), atol=1e-6, rtol=0)


def test_need_weights_never_takes_the_flash_kernel(monkeypatch):
    _, tm = _pair(KDIM, VDIM)
    tm.use_flash_attention = True
    monkeypatch.setattr(port_tf, "FLASH_ATTENTION_MIN_SEQ", 1)

    def refuse(*a, **k):
        raise AssertionError("the flash kernel was called under need_weights")

    monkeypatch.setattr(port_tf.flash_attention, "flash_attention", refuse)
    q, k, v, _ = _inputs(KDIM, VDIM)
    with torch.no_grad():
        out, weights = tm(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert tuple(weights.shape) == (B, H, LQ, LK)
    tm.need_weights = False
    with pytest.raises(AssertionError, match="flash kernel was called"):
        tm(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))


def test_ring_and_ulysses_still_raise():
    for kw in ({"use_ring_attention": True}, {"use_ulysses_attention": True}):
        with pytest.raises(NotImplementedError, match="not ported"):
            port_tf.MultiHeadAttention(E, H, device="cpu", **kw)
