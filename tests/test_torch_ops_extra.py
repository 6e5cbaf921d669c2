"""Port parity: the op files ``math_extra``, ``nn_extra``, ``linalg_kernels``, ``metrics_kernels`` and ``optimizer_kernels``, and the rest of ``kernels``.

Each op type these files register in the JAX package and the port had not
is a case of its file's test: the port's registry kernel and the JAX
package's, the same numpy inputs from a seed, the same attributes (the
JAX test suites' ``tests/test_ops_tail.py`` and ``tests/test_ops_extended.py``
exercise these kernels on the JAX side). Integer and bool outputs are held
exactly; floats to ``RTOL``/``ATOL`` (the same f32 arithmetic in another
order; XLA fuses multiply-adds), except where a case names its own
tolerance. ``dpsgd_update`` runs at ``sigma = 0``: the noise streams of
the packages differ. The registry counts of both packages are checked
after importing ``static`` and ``nn``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu.nn  # noqa: E402,F401
import paddle_tpu.static  # noqa: E402,F401
from paddle_tpu.ops import registry as jregistry  # noqa: E402

import paddle_tpu_torch.nn  # noqa: E402,F401
import paddle_tpu_torch.static  # noqa: E402,F401
from paddle_tpu_torch.ops import registry as pregistry  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6

_rng = np.random.RandomState(0)


def f32(*shape, lo=None, hi=None):
    if lo is not None:
        return _rng.uniform(lo, hi, shape).astype(np.float32)
    return _rng.randn(*shape).astype(np.float32)


def i64(*shape, lo=0, hi=10):
    return _rng.randint(lo, hi, shape).astype(np.int64)


def _spd(n):
    a = f32(n, n)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


class Case:
    """One op call: ``inputs`` (numpy arrays, or None), ``attrs`` for both
    packages, ``jax_attrs``/``port_attrs`` for one, ``tol`` = (rtol, atol)."""

    def __init__(self, op, inputs, attrs=None, jax_attrs=None, port_attrs=None, tol=None,
                 label=""):
        self.op, self.inputs, self.attrs = op, inputs, attrs or {}
        self.jax_attrs, self.port_attrs = jax_attrs or {}, port_attrs or {}
        self.tol = tol or (RTOL, ATOL)
        self.id = op + (f"-{label}" if label else "")


def _arrays(attrs, to):
    """Array attributes (numpy) as the package's arrays."""
    return {k: to(v) if isinstance(v, (np.ndarray, np.generic)) else v for k, v in attrs.items()}


def _run_jax(c):
    with jax.enable_x64(False):
        out = jregistry.kernel(c.op)(*[None if a is None else jnp.asarray(a) for a in c.inputs],
                                     **_arrays(c.attrs, jnp.asarray), **c.jax_attrs)
        return [np.asarray(o) for o in (out if isinstance(out, (tuple, list)) else [out])]


def _port_array(a):
    return torch.from_numpy(np.array(a))


def _run_port(c):
    out = pregistry.kernel(c.op)(*[None if a is None else _port_array(a) for a in c.inputs],
                                 **_arrays(c.attrs, _port_array), **c.port_attrs)
    return [o.detach().numpy() if isinstance(o, torch.Tensor) else np.asarray(o)
            for o in (out if isinstance(out, (tuple, list)) else [out])]


def _check(c):
    want, got = _run_jax(c), _run_port(c)
    assert len(got) == len(want), c.id
    for g, w in zip(got, want):
        assert g.shape == w.shape, (c.id, g.shape, w.shape)
        if w.dtype.kind in "biu":
            assert g.dtype.kind == w.dtype.kind, (c.id, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=c.id)
        else:
            np.testing.assert_allclose(g, w, rtol=c.tol[0], atol=c.tol[1], err_msg=c.id)


def _params(cases):
    return pytest.mark.parametrize("case", cases, ids=[c.id for c in cases])


# -- math_extra.py ------------------------------------------------------------------

_runs = np.array([1, 1, 2, 2, 2, 3, 1, 1, 5], np.int64)
_grid = f32(2, 4, 5, 2, lo=-1.2, hi=1.2)
MATH_EXTRA = [
    Case("bincount", [i64(20, hi=7)], {"length": 9}, label="length"),
    Case("bincount", [i64(20, hi=7)], {"weights": f32(20), "length": 5},
         label="weights_dropped"),
    Case("bincount", [i64(20, hi=7)], {"minlength": 10}, label="eager"),
    Case("unique_consecutive", [_runs]),
    Case("logit", [f32(6, lo=0.01, hi=0.99)]),
    Case("logit", [f32(6, lo=0.0, hi=1.0)], {"eps": 0.05}, label="eps"),
    Case("logaddexp", [f32(5), f32(5)]),
    Case("heaviside", [np.float32([-1, 0, 2, 0]), np.float32([0.5, 0.25, 3, 7])]),
    Case("gcd", [i64(6, lo=1, hi=40), i64(6, lo=1, hi=40)]),
    Case("lcm", [i64(6, lo=1, hi=40), i64(6, lo=1, hi=40)]),
    Case("nextafter", [f32(5), f32(5)]),
    Case("ldexp", [f32(5), np.int32([0, 1, -2, 3, 4])]),
    Case("copysign", [f32(5), f32(5)]),
    Case("hypot", [f32(5), f32(5)]),
    Case("rad2deg", [f32(5)]),
    Case("deg2rad", [f32(5) * 90]),
    Case("conj", [f32(2, 3)]),
    Case("i0", [f32(5, lo=-4, hi=4)]),
    Case("sinc", [f32(5)]),
    Case("signbit", [np.float32([-1.5, 0.0, -0.0, 2.0])]),
    Case("label_smooth", [np.eye(4, dtype=np.float32)[[0, 2, 3]]], {"epsilon": 0.1}),
    Case("label_smooth", [np.eye(4, dtype=np.float32)[[1, 1]]],
         {"epsilon": 0.2, "prior_dist": np.float32([0.1, 0.2, 0.3, 0.4])}, label="prior"),
    Case("glu", [f32(3, 8)], {"axis": -1}),
    Case("glu", [f32(4, 2, 3)], {"axis": 0}, label="axis0"),
    Case("rot90", [f32(2, 3, 4)], {"k": 1, "axes": (0, 1)}),
    Case("rot90", [f32(2, 3, 4)], {"k": -3, "axes": (1, 2)}, label="k-3"),
    Case("expand_as", [f32(1, 3), f32(4, 3)]),
    Case("pad3d", [f32(1, 2, 3, 4, 5)], {"paddings": [1, 2, 0, 1, 2, 0], "value": 0.5},
         label="constant"),
    Case("pad3d", [f32(1, 2, 3, 4, 5)], {"paddings": [1, 2, 1, 1, 2, 0], "mode": "reflect"},
         label="reflect"),
    Case("pad3d", [f32(1, 2, 3, 4, 5)], {"paddings": [2, 1, 0, 3, 1, 1], "mode": "replicate"},
         label="replicate"),
    Case("pad3d", [f32(1, 2, 3, 4, 5)], {"paddings": [1, 2, 2, 1, 0, 1], "mode": "circular"},
         label="circular"),
    Case("pad3d", [f32(1, 3, 4, 5, 2)], {"paddings": [1, 0, 1, 2, 0, 1], "mode": "reflect",
                                         "data_format": "NDHWC"}, label="ndhwc"),
    Case("grid_sample", [f32(2, 3, 5, 6), _grid], label="bilinear"),
    Case("grid_sample", [f32(2, 3, 5, 6), _grid], {"align_corners": False},
         label="bilinear_unaligned"),
    Case("grid_sample", [f32(2, 3, 5, 6), _grid], {"padding_mode": "border"},
         label="bilinear_border"),
    Case("grid_sample", [f32(2, 3, 5, 6), _grid], {"mode": "nearest"}, label="nearest"),
    Case("affine_grid", [f32(2, 2, 3)], {"out_shape": [2, 3, 4, 5]}),
    Case("affine_grid", [f32(2, 2, 3)], {"out_shape": [2, 3, 4, 5], "align_corners": False},
         label="unaligned"),
]


@_params(MATH_EXTRA)
def test_math_extra_ops_match_jax(case):
    _check(case)


# -- nn_extra.py ------------------------------------------------------------------------

_rois = np.float32([[0.5, 0.5, 4.2, 3.7], [1.0, 0.0, 5.5, 5.5], [2.2, 1.4, 3.1, 4.9]])
_bidx = np.int32([0, 1, 1])
_off_hw = (5, 6)  # deformable conv: 3x3 taps, stride 1, padding 1 on a 5 x 6 input
NN_EXTRA = [
    Case("conv3d", [f32(2, 4, 5, 6, 5), f32(6, 4, 3, 3, 3)], {"padding": 1}),
    Case("conv3d", [f32(2, 4, 5, 6, 5), f32(6, 2, 3, 2, 3)],
         {"stride": 2, "padding": "SAME", "groups": 2}, label="same_groups"),
    Case("conv3d", [f32(1, 2, 6, 5, 5), f32(3, 2, 2, 3, 2)],
         {"padding": "VALID", "dilation": [1, 2, 1]}, label="valid_dilated"),
    Case("conv3d_transpose", [f32(2, 4, 3, 4, 3), f32(4, 3, 3, 3, 3)],
         {"stride": 2, "padding": 1, "output_padding": 1}),
    Case("conv3d_transpose", [f32(1, 4, 3, 3, 3), f32(4, 2, 2, 3, 2)],
         {"stride": [1, 2, 1], "groups": 2}, label="groups"),
    Case("pool3d", [f32(2, 3, 5, 6, 5)], {"kernel_size": 2, "stride": 2}, label="max"),
    Case("pool3d", [f32(2, 3, 5, 6, 5)], {"kernel_size": 3, "stride": 2, "padding": 1,
                                          "ceil_mode": True}, label="max_ceil"),
    Case("pool3d", [f32(2, 3, 5, 6, 5)], {"kernel_size": 3, "stride": 2, "padding": 1,
                                          "pooling_type": "avg"}, label="avg_exclusive"),
    Case("pool3d", [f32(2, 3, 5, 6, 5)], {"kernel_size": [2, 3, 2], "padding": 1,
                                          "pooling_type": "avg", "exclusive": False},
         label="avg_inclusive"),
    Case("data_norm", [f32(4, 3), np.float32([10, 12, 14]), f32(3) * 5,
                       f32(3, lo=20, hi=30)]),
    Case("deformable_conv", [f32(2, 4, *_off_hw), f32(2, 2 * 2 * 9, *_off_hw),
                             f32(2, 2 * 9, *_off_hw, lo=0, hi=1), f32(6, 4, 3, 3)],
         {"padding": 1, "deformable_groups": 2}, label="v2"),
    Case("deformable_conv", [f32(1, 4, *_off_hw), f32(1, 2 * 9, *_off_hw), None,
                             f32(4, 2, 3, 3)], {"padding": 1, "groups": 2}, label="v1_groups"),
    Case("roi_pool", [f32(2, 3, 6, 7), _rois],
         {"batch_indices": _bidx, "pooled_height": 2, "pooled_width": 3}),
    Case("psroi_pool", [f32(2, 12, 6, 7), _rois],
         {"batch_indices": _bidx, "output_channels": 3, "pooled_height": 2,
          "pooled_width": 2}),
    Case("prroi_pool", [f32(2, 3, 6, 7), _rois],
         {"batch_indices": _bidx, "pooled_height": 2, "pooled_width": 2,
          "spatial_scale": 0.8}),
]


@_params(NN_EXTRA)
def test_nn_extra_ops_match_jax(case):
    _check(case)


# -- linalg_kernels.py ----------------------------------------------------------------

_l = np.linalg.cholesky(_spd(4)).astype(np.float32)
_qr_x = f32(5, 3)
LINALG = [
    Case("cholesky_solve", [f32(4, 2), _l], tol=(1e-4, 1e-5), label="lower"),
    Case("cholesky_solve", [f32(4, 2), np.ascontiguousarray(_l.T)], {"upper": True},
         tol=(1e-4, 1e-5), label="upper"),
    Case("corrcoef", [f32(3, 6)]),
    Case("corrcoef", [f32(6, 3)], {"rowvar": False}, label="cols"),
    Case("cov", [f32(3, 6)]),
    Case("cov", [f32(6, 3)], {"rowvar": False, "ddof": False}, label="cols_biased"),
    Case("eigvalsh", [_spd(5)], tol=(1e-4, 1e-4)),
    Case("householder_product", [_qr_x, np.float32([1.2, 0.7, 1.5])]),
    Case("lu", [f32(4, 4)], tol=(1e-4, 1e-5)),
    Case("matrix_norm", [f32(3, 4, 5)], label="fro"),
    Case("matrix_norm", [f32(3, 4)], {"p": "nuc"}, tol=(1e-4, 1e-5), label="nuc"),
    Case("matrix_norm", [f32(2, 4, 3)], {"p": 2, "axis": (1, 2)}, tol=(1e-4, 1e-5),
         label="spectral"),
    Case("matrix_norm", [f32(4, 3)], {"p": 1, "keepdim": True}, label="one_keepdim"),
    Case("multi_dot", [f32(3, 4), f32(4, 6), f32(6, 2)]),
]


@_params(LINALG)
def test_linalg_kernels_match_jax(case):
    _check(case)


# -- metrics_kernels.py -----------------------------------------------------------------

_p1 = f32(40, lo=0, hi=1)
_probs = np.stack([1 - _p1, _p1], 1)
METRICS = [
    Case("auc", [_probs, i64(40, hi=2)], {"num_thresholds": 200}),
    Case("auc", [_p1, i64(40, hi=2)], {"num_thresholds": 50,
                                       "stat_pos": np.float32(_rng.randint(0, 3, 51)),
                                       "stat_neg": np.float32(_rng.randint(0, 3, 51))},
         label="streaming"),
    Case("precision_recall", [f32(30, 4), i64(30, hi=4)], {"num_classes": 4}),
    Case("precision_recall", [i64(30, hi=5), i64(30, hi=5)], {"num_classes": 6},
         label="ids_empty_class"),
]


@_params(METRICS)
def test_metrics_kernels_match_jax(case):
    _check(case)


# -- optimizer_kernels.py -------------------------------------------------------------------

_P, _G = f32(5, 3), f32(5, 3)
_LR, _STEP = np.float32(0.05), np.int32(3)
OPTIMIZERS = [
    Case("adamax_update", [_P, _G, f32(5, 3), f32(5, 3, lo=0, hi=1), _LR, _STEP]),
    Case("adagrad_update", [_P, _G, f32(5, 3, lo=0, hi=1), _LR]),
    Case("adadelta_update", [_P, _G, f32(5, 3, lo=0, hi=1), f32(5, 3, lo=0, hi=1), _LR]),
    Case("rmsprop_update", [_P, _G, f32(5, 3, lo=0, hi=1), f32(5, 3), _LR],
         {"momentum": 0.9}),
    Case("ftrl_update", [_P, _G, f32(5, 3, lo=0.1, hi=1), f32(5, 3), _LR],
         {"l1": 0.01, "l2": 0.02}),
    Case("ftrl_update", [_P, _G, f32(5, 3, lo=0.1, hi=1), f32(5, 3), _LR],
         {"l1": 0.01, "lr_power": -0.7}, label="lr_power"),
    Case("lamb_update", [_P, _G, f32(5, 3), f32(5, 3, lo=0, hi=1), _LR, _STEP]),
    Case("lars_momentum_update", [_P, _G, f32(5, 3), _LR]),
    Case("proximal_gd_update", [_P, _G, _LR], {"l1": 0.1, "l2": 0.2}),
    Case("proximal_gd_update", [_P, _G, _LR], {"l2": 0.2}, label="l2_only"),
    Case("proximal_adagrad_update", [_P, _G, f32(5, 3, lo=0.1, hi=1), _LR], {"l1": 0.1}),
    Case("dpsgd_update", [_P, _G * 20, _LR], {"clip": 1.0, "sigma": 0.0},
         jax_attrs={"key": jax.random.PRNGKey(0)}),
]


@_params(OPTIMIZERS)
def test_optimizer_kernels_match_jax(case):
    _check(case)


# -- the rest of kernels.py -----------------------------------------------------------------

KERNELS_REST = [
    Case("getitem", [f32(4, 5)], {"idx": (slice(1, 3), 2)}),
    Case("mean_all", [f32(3, 4)]),
    Case("hinge_loss", [f32(6, 1), np.float32(_rng.randint(0, 2, (6, 1)))]),
    Case("depthwise_conv2d", [f32(2, 3, 6, 6), f32(3, 1, 3, 3)], {"padding": 1}),
    Case("check_finite_and_unscale", [f32(3), np.float32([1.0, np.inf])],
         {"scale": np.float32(4.0)}, label="found_inf"),
    Case("update_loss_scaling", [np.float32(1024.0), np.int32(1999), np.bool_(False)],
         label="grows"),
    Case("update_loss_scaling", [np.float32(1.5), np.int32(10), np.bool_(True)],
         label="shrinks"),
]


@_params(KERNELS_REST)
def test_the_rest_of_kernels_matches_jax(case):
    _check(case)


def test_the_ported_files_register_every_op_of_theirs():
    """Every op type of the five files and of ``kernels.py`` that the JAX
    package registers is registered in the port, and has a case here."""
    import inspect

    files = {"math_extra", "nn_extra", "linalg_kernels", "metrics_kernels",
             "optimizer_kernels", "kernels"}
    jax_ops = jregistry.all_ops()
    theirs = {n for n, d in jax_ops.items()
              if inspect.getmodule(d.fn).__name__.rsplit(".", 1)[-1] in files}
    assert theirs <= set(pregistry.all_ops())
    cased = {c.op for c in MATH_EXTRA + NN_EXTRA + LINALG + METRICS + OPTIMIZERS + KERNELS_REST}
    assert len(cased) == 58 and cased <= theirs
    # the registries are the process's: leave out ops a test registered (``_test_*``)
    ported = {n for n in pregistry.all_ops() if not n.startswith("_")}
    assert len(ported) == 433
    assert len([n for n in jax_ops if not n.startswith("_")]) == 427
    # the reverse: beside every JAX op type the port registers only the six
    # its own op front names (the JAX front computes them in jnp)
    assert ported - set(jax_ops) == {"diag_embed", "diagflat", "fold", "multiplex", "poisson",
                                     "put_along_axis"}


@pytest.mark.parametrize("suite,count", [("test_ops_tail.py", 12), ("test_ops_extended.py", 44)])
def test_the_jax_suites_ops_of_these_files_all_run_in_the_port(suite, count):
    """The ops of the five files that the JAX suite names are all
    registered in the port, and those this file's cases cover are the ones
    the port did not have before."""
    import inspect
    import os
    import re

    files = {"math_extra", "nn_extra", "linalg_kernels", "metrics_kernels", "optimizer_kernels"}
    ops = {n for n, d in jregistry.all_ops().items()
           if inspect.getmodule(d.fn).__name__.rsplit(".", 1)[-1] in files}
    with open(os.path.join(os.path.dirname(__file__), suite)) as f:
        src = f.read()
    named = {o for o in ops if re.search(r"\b%s\b" % re.escape(o), src)}
    assert len(named) == count and named <= set(pregistry.all_ops())
    cased = {c.op for c in MATH_EXTRA + NN_EXTRA + LINALG + METRICS + OPTIMIZERS}
    new = named & cased
    assert len(new) == {"test_ops_tail.py": 8, "test_ops_extended.py": 18}[suite], sorted(new)
