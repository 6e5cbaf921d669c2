"""Port parity: flash attention (``paddle_tpu_torch.ops.cuda.flash_attention``).

On the CPU the port's wrapper runs its plain version; it is held against
the JAX package's ``flash_attention`` (its plain path off-TPU) with the
same numpy inputs. The CUDA kernel is held against the plain version on
the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu.ops.pallas.flash_attention import flash_attention as jax_flash  # noqa: E402
from paddle_tpu_torch.ops.cuda import flash_attention as tfa  # noqa: E402

torch.set_num_threads(1)

ATOL = 2e-5  # f32 sums in another order than XLA's


def _qkv(b, h, l, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, l, d).astype("f4") for _ in range(3)]


def _bias(kind, b, h, l, seed):
    rng = np.random.RandomState(seed + 100)
    if kind == "none":
        return None
    if kind == "pad":  # BERT's additive key mask, [B, 1, 1, L]
        lens = rng.randint(l // 2, l + 1, size=b)
        keep = np.arange(l)[None, :] < lens[:, None]
        return ((1.0 - keep) * -1e4).astype("f4")[:, None, None, :]
    return rng.randn(b, h, l, l).astype("f4")  # a full [B, H, L, L] bias


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("l", [16, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_kind", ["pad", "full"])
def test_plain_matches_jax_flash_attention(bias_kind, causal, l, d):
    b, h = 2, 3
    q, k, v = _qkv(b, h, l, d, seed=l + d)
    bias = _bias(bias_kind, b, h, l, seed=l)
    out = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              bias=None if bias is None else torch.from_numpy(bias),
                              causal=causal)
    ref = jax_flash(q, k, v, bias=bias, causal=causal)
    assert out.shape == (b, h, l, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_plain_matches_jax_without_bias_and_with_explicit_scale():
    q, k, v = _qkv(2, 2, 16, 32, seed=5)
    out = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), scale=0.3)
    ref = jax_flash(q, k, v, scale=0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_cpu_dropout_is_not_ported_yet():
    """Attention dropout comes with the training path: the CPU refuses it
    too rather than drawing a mask the card could not reproduce."""
    q, k, v = map(torch.from_numpy, _qkv(2, 2, 64, 32, seed=7))
    with pytest.raises(NotImplementedError, match="dropout"):
        tfa.flash_attention(q, k, v, dropout_rate=0.5)


@pytest.mark.parametrize("shape", [(0, 2, 16, 32), (1, 2, 0, 32)])
def test_kernel_entry_counts_no_launch_without_query_rows(shape):
    q = torch.empty(shape, device="meta")
    kv = torch.empty(shape[0], shape[1], 16, shape[3], device="meta")
    before = tfa.LAUNCHES
    out, lse = tfa.flash_attention_fwd(q, kv, kv)
    assert tfa.LAUNCHES == before
    assert out.shape == shape and lse.shape == (shape[0] * shape[1], shape[2])


def test_kernel_entry_refuses_cpu_tensors():
    """``flash_attention_fwd`` is the kernel's entry: it never runs the
    plain version."""
    q, k, v = map(torch.from_numpy, _qkv(1, 1, 16, 32, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(q, k, v)


def test_non_cpu_tensor_never_takes_the_plain_version():
    q = torch.empty(1, 2, 16, 32, device="meta")
    with pytest.raises(NotImplementedError, match="dropout"):
        tfa.flash_attention(q, q, q, dropout_rate=0.1)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q, q)


def test_mismatched_shapes_raise():
    q = torch.zeros(1, 2, 16, 32)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, torch.zeros(1, 2, 16, 64), torch.zeros(1, 2, 16, 64))
