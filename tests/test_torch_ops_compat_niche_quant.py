"""Port parity: the compat, niche and fake-quantization op families, the op front's names, and the registry.

Each op type of ``ops/compat.py``, ``ops/niche.py`` and the ten
fake-quantization ops of ``ops/quantize_kernels.py`` is a case of
``tests/_torch_tail_cases.py``, run through the JAX package's registry
kernel and the port's on the same seeded numpy inputs and attributes
(integers exactly, floats to ``RTOL``/``ATOL`` unless a case names its
own tolerance; ``pyramid_hash``'s FNV-1a hashes bit for bit) and on
``meta`` tensors. The random ops (``shuffle_batch``, a drawn
``sample_logits``) hold their invariants: the packages' streams differ.
Gradients of ``linear_chain_crf``, ``nce`` and the straight-through
quant-dequant ops are held against ``jax.grad``.

The op front: every public function of ``paddle_tpu/ops/__init__.py`` is
in the port with the same parameters and defaults. The registry: the
port holds every JAX op type, and beside them only the six its own op
front names (ops the JAX front computes in ``jnp`` directly). The JAX
suites ``tests/test_compat_ops.py``, ``tests/test_niche_ops.py`` and
``tests/test_quantization.py`` name ops that all run in the port.
"""
import inspect
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu.nn  # noqa: E402,F401
import paddle_tpu.ops as jops  # noqa: E402
import paddle_tpu.static  # noqa: E402,F401
from paddle_tpu.ops import registry as jregistry  # noqa: E402

import paddle_tpu_torch.nn  # noqa: E402,F401
import paddle_tpu_torch.ops as pops  # noqa: E402
import paddle_tpu_torch.static  # noqa: E402,F401
from paddle_tpu_torch.ops import registry as pregistry  # noqa: E402

import _torch_tail_cases as tc  # noqa: E402
from test_torch_ops_sequence_detection import (_port_array, check, check_meta,  # noqa: E402
                                               grads, params, run_jax)

torch.set_num_threads(1)

CASES = tc.COMPAT + tc.NICHE + tc.QUANT

# the op types the port's front registers that the JAX front computes in jnp
PORT_ONLY = {"diag_embed", "diagflat", "fold", "multiplex", "poisson", "put_along_axis"}


@params([c for c in tc.COMPAT if c.kind not in ("random", "resize")])
def test_compat_ops_match_jax(case):
    check(case)


@params([c for c in tc.COMPAT if c.kind == "resize"])
def test_one_and_three_axis_interp_match_jax_image_resize(case):
    """The JAX ``interpolate`` kernel resizes two axes only (its
    ``trilinear_interp`` and ``linear_interp`` raise); the port's follows
    ``jax.image.resize``'s linear method on every spatial axis."""
    x = case.inputs[0]
    out = [case.attrs.get(k) for k in ("out_d", "out_h", "out_w") if case.attrs.get(k)]
    if not out:
        out = [int(n * case.attrs["scale"]) for n in x.shape[2:]]
    with jax.enable_x64(False):
        want = np.asarray(jax.image.resize(jnp.asarray(x), x.shape[:2] + tuple(out), "linear"))
    got = pregistry.kernel(case.op)(torch.from_numpy(x), **case.attrs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):  # a 4-D unpack of the 3-D or 5-D input
        run_jax(case)


@params(tc.NICHE + tc.QUANT)
def test_niche_and_fake_quant_ops_match_jax(case):
    check(case)


@params(CASES)
def test_compat_niche_and_quant_ops_on_meta(case):
    check_meta(case)


def test_every_op_of_the_three_files_has_a_case():
    files = {"compat", "niche"}
    jax_ops = jregistry.all_ops()
    theirs = {n for n, d in jax_ops.items()
              if inspect.getmodule(d.fn).__name__.rsplit(".", 1)[-1] in files}
    fake = {n for n, d in jax_ops.items()
            if inspect.getmodule(d.fn).__name__.endswith("quantize_kernels")
            and n.startswith(("fake_", "moving_"))}
    assert len(fake) == 10
    # ``spectral_norm`` of compat.py was ported with the layers that use it
    assert {c.op for c in CASES} == (theirs | fake) - {"spectral_norm"}
    assert len({c.op for c in CASES}) == 84


def test_pyramid_hash_fnv1a_is_the_jax_hash_bit_for_bit():
    from paddle_tpu.ops.niche import _fnv1a as jfnv
    from paddle_tpu_torch.ops.niche import _fnv1a as pfnv

    toks = np.random.RandomState(0).randint(-2 ** 31, 2 ** 31 - 1, (64, 3)).astype(np.int32)
    for seed in (0, 7, 2 ** 31 + 5):
        with jax.enable_x64(False):
            want = np.asarray(jfnv(jnp.asarray(toks), seed)).astype(np.int64)
        np.testing.assert_array_equal(pfnv(torch.from_numpy(toks), seed).numpy(), want)


def test_shuffle_batch_permutes_the_rows():
    x = torch.from_numpy(np.random.RandomState(1).randn(9, 3).astype(np.float32))
    out, perm = pregistry.kernel("shuffle_batch")(x, generator=torch.Generator().manual_seed(3))
    assert perm.dtype == torch.int64 and sorted(perm.tolist()) == list(range(9))
    assert torch.equal(out, x[perm])


def test_drawn_sample_logits_keeps_the_true_labels_first():
    c = next(c for c in tc.COMPAT if c.id == "sample_logits-drawn")
    logits, labels = (_port_array(a) for a in c.inputs)
    samples, probs, sampled, slabels = pregistry.kernel("sample_logits")(
        logits, labels, num_samples=5, generator=torch.Generator().manual_seed(0))
    assert samples.shape == (3, 7) and torch.equal(samples[:, :2], labels)
    assert bool(((samples >= 0) & (samples < 12)).all())
    np.testing.assert_allclose(probs.numpy(), 1.0 / 12)
    picked = torch.gather(logits, 1, samples) - np.log(1.0 / 12)
    hit = (samples[:, None, 2:] == labels[:, :, None]).any(1)
    np.testing.assert_allclose(sampled[:, :2].numpy(), picked[:, :2].numpy(), rtol=1e-6)
    np.testing.assert_allclose(sampled[:, 2:][~hit].numpy(), picked[:, 2:][~hit].numpy(),
                               rtol=1e-6)
    assert bool((sampled[:, 2:][hit] < -1e19).all())
    assert torch.equal(slabels, torch.arange(2).expand(3, 2))


# -- gradients against jax.grad --------------------------------------------------------------


def test_linear_chain_crf_gradient_matches_jax():
    c = next(c for c in tc.COMPAT if c.op == "linear_chain_crf")
    want, got = grads("linear_chain_crf", c.inputs, {}, [0, 1], out_index=3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_nce_gradient_matches_jax():
    c = next(c for c in tc.COMPAT if c.op == "nce")
    want, got = grads("nce", c.inputs, c.attrs, [0, 1, 2])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("op,extra", [
    ("fake_quantize_dequantize_abs_max", 0),
    ("fake_channel_wise_quantize_dequantize_abs_max", 0),
    ("fake_quantize_dequantize_moving_average_abs_max", 3),
])
def test_straight_through_gradient_matches_jax(op, extra):
    """Inside the clip range quant-dequant passes the gradient unchanged
    (``tests/test_quantization.py::test_ste_gradient_is_identity``): the
    gradient of ``sum(out * out)`` is ``2 * out``."""
    x = np.linspace(-1, 1, 8).astype(np.float32).reshape(2, 4)
    inputs = [x] + [np.array([v], np.float32) for v in (1.0, 2.0, 3.0)][:extra]
    want, got = grads(op, inputs, {}, [0], out_index=0)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = pregistry.kernel(op)(xt, *[_port_array(a) for a in inputs[1:]])[0]
    (out * out).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), 2 * out.detach().numpy(), rtol=1e-6)


# -- the op front and the registry ------------------------------------------------------------


def _public(mod):
    return {n: v for n, v in vars(mod).items()
            if not n.startswith("_") and inspect.isfunction(v) and v.__module__ == mod.__name__}


def test_op_front_has_every_jax_function_with_its_parameters():
    jfront, pfront = _public(jops), _public(pops)
    assert set(jfront) <= set(pfront), sorted(set(jfront) - set(pfront))
    for name, fn in jfront.items():
        want = [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()]
        got = [(p.name, p.kind, p.default)
               for p in inspect.signature(pfront[name]).parameters.values()]
        assert [g[:2] for g in got] == [w[:2] for w in want], name


def test_the_registries_are_equal_but_the_port_fronts_own():
    """Every JAX op type is a port op type; beside them the port registers
    only the six op types of its front."""
    # the registries are the process's: leave out ops a test registered (``_test_*``)
    jax_ops = {n for n in jregistry.all_ops() if not n.startswith("_")}
    port_ops = {n for n in pregistry.all_ops() if not n.startswith("_")}
    assert jax_ops <= port_ops
    assert port_ops - jax_ops == PORT_ONLY
    assert len(jax_ops) == 427 and len(port_ops) == 433


@pytest.mark.parametrize("suite,count", [("test_compat_ops.py", 33), ("test_niche_ops.py", 5),
                                         ("test_quantization.py", 10)])
def test_the_jax_suites_ops_all_run_in_the_port(suite, count):
    """The op types of the three files that each JAX suite names (the
    compat aliases by their reference names) are registered in the port
    and are cases here."""
    files = {"compat", "niche", "quantize_kernels"}
    theirs = {n for n, d in jregistry.all_ops().items()
              if inspect.getmodule(d.fn).__name__.rsplit(".", 1)[-1] in files}
    with open(os.path.join(os.path.dirname(__file__), suite)) as f:
        src = f.read()
    named = {o for o in theirs if re.search(r"[\"']%s[\"']" % re.escape(o), src)}
    assert len(named) == count, sorted(named)
    assert named <= set(pregistry.all_ops())
    assert named - {c.op for c in CASES} <= {"spectral_norm", "quant_dequant_static",
                                             "quantize_static", "dequantize_static",
                                             "matmul_int8", "mul_int8"}
