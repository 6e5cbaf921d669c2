"""The ``tensor`` and ``linalg`` namespaces and the top level against the JAX
package's (``tests/test_tensor_namespace.py``'s counterpart).

Each name of ``paddle_tpu.tensor`` and ``paddle_tpu.linalg`` is one case:
the same inputs, made from a numpy seed, go through the JAX function and
the port's, and the results agree within RTOL/ATOL in float32, exactly
for integer and bool results. A random function's draws differ between
the packages by design (numpy makes the tests' inputs): its case checks
the shape, the dtype's kind and the law's support instead. Factorizations
whose factors are fixed only up to signs (``svd``, ``eigh``) compare what
the signs leave fixed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402
import paddle_tpu.linalg as jlinalg  # noqa: E402
import paddle_tpu.tensor as jtensor  # noqa: E402

import paddle_tpu_torch as paddle  # noqa: E402
import paddle_tpu_torch.linalg as linalg  # noqa: E402
import paddle_tpu_torch.tensor as tensor  # noqa: E402
from paddle_tpu_torch.framework import place as _place  # noqa: E402

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6  # float32 results


@pytest.fixture(autouse=True)
def _on_the_cpu():
    prev = _place._expected_place
    paddle.set_device("cpu")
    yield
    _place._expected_place = prev


def f32(*shape, lo=-2.0, hi=2.0, seed=0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(np.float32)


def i64(*shape, lo=0, hi=5, seed=0):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(np.int64)


def pos(*shape, seed=0):
    return f32(*shape, lo=0.5, hi=2.0, seed=seed)


def spd(n=4, seed=0):
    a = f32(n, n, seed=seed)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


BOOL = np.array([[True, False, True], [False, False, True]])

# name -> (args, kwargs); numpy arrays (and lists of them) become tensors
CASES = {
    "abs": ([f32(3, 4)], {}),
    "acos": ([f32(3, 4, lo=-0.9, hi=0.9)], {}),
    "add": ([f32(3, 4), f32(3, 4, seed=1)], {}),
    "addmm": ([f32(3, 5), f32(3, 4, seed=1), f32(4, 5, seed=2)], {"beta": 0.5, "alpha": 2.0}),
    "allclose": ([f32(3, 4), f32(3, 4) + 1e-7], {}),
    "amax": ([f32(3, 4)], {"axis": 1}),
    "amin": ([f32(3, 4)], {"axis": 0, "keepdim": True}),
    "angle": ([f32(3, 4)], {}),
    "arange": ([1, 11, 3], {}),
    "argmax": ([f32(3, 4)], {"axis": 1}),
    "argmin": ([f32(3, 4)], {"axis": 0}),
    "argsort": ([f32(3, 4)], {"axis": -1, "descending": True}),
    "as_complex": ([f32(3, 2)], {}),
    "as_real": ([np.array([1 + 2j, 3 - 1j], np.complex64)], {}),
    "asin": ([f32(3, 4, lo=-0.9, hi=0.9)], {}),
    "assign": ([f32(3, 4)], {}),
    "atan": ([f32(3, 4)], {}),
    "atan2": ([f32(3, 4), f32(3, 4, seed=1)], {}),
    "bmm": ([f32(2, 3, 4), f32(2, 4, 5, seed=1)], {}),
    "broadcast_to": ([f32(1, 4)], {"shape": [3, 4]}),
    "cast": ([f32(3, 4)], {"dtype": "int32"}),
    "ceil": ([f32(3, 4)], {}),
    "channel_shuffle": ([f32(2, 6, 3, 3)], {"groups": 3}),
    "cholesky": ([spd()], {}),
    "chunk": ([f32(6, 4)], {"chunks": 3}),
    "clip": ([f32(3, 4)], {"min": -0.5, "max": 0.7}),
    "clone": ([f32(3, 4)], {}),
    "concat": ([[f32(2, 4), f32(3, 4, seed=1)]], {"axis": 0}),
    "cos": ([f32(3, 4)], {}),
    "cosh": ([f32(3, 4)], {}),
    "cross": ([f32(4, 3), f32(4, 3, seed=1)], {"axis": -1}),
    "cumprod": ([f32(3, 4)], {"dim": 1}),
    "cumsum": ([f32(3, 4)], {"axis": 0}),
    "det": ([spd()], {}),
    "diag": ([f32(4)], {"offset": 1}),
    "diagflat": ([f32(3)], {"offset": -1}),
    "diff": ([f32(3, 5)], {"n": 2, "axis": -1}),
    "digamma": ([pos(3, 4)], {}),
    "dist": ([f32(3, 4), f32(3, 4, seed=1)], {"p": 3}),
    "divide": ([f32(3, 4), pos(3, 4, seed=1)], {}),
    "dot": ([f32(5), f32(5, seed=1)], {}),
    "eig": ([spd()], {}),
    "eigh": ([spd()], {}),
    "empty": ([[2, 3]], {"dtype": "float32"}),
    "empty_like": ([f32(2, 3)], {}),
    "equal": ([i64(3, 4), i64(3, 4, seed=1)], {}),
    "equal_all": ([i64(3, 4), i64(3, 4)], {}),
    "erf": ([f32(3, 4)], {}),
    "exp": ([f32(3, 4)], {}),
    "expand": ([f32(1, 4)], {"shape": [3, -1]}),
    "expand_as": ([f32(1, 4), f32(3, 4, seed=1)], {}),
    "expm1": ([f32(3, 4)], {}),
    "eye": ([3, 4], {"dtype": "float32"}),
    "flatten": ([f32(2, 3, 4)], {"start_axis": 1, "stop_axis": 2}),
    "flip": ([f32(3, 4)], {"axis": [0, 1]}),
    "floor": ([f32(3, 4)], {}),
    "floor_divide": ([i64(3, 4, lo=-9, hi=9), i64(3, 4, lo=1, hi=4, seed=1)], {}),
    "floor_mod": ([i64(3, 4, lo=-9, hi=9), i64(3, 4, lo=1, hi=4, seed=1)], {}),
    "frac": ([f32(3, 4)], {}),
    "full": ([[2, 3], 1.5], {}),
    "full_like": ([f32(2, 3), 7.0], {}),
    "gather": ([f32(5, 3), i64(4, hi=5)], {"axis": 0}),
    "gather_nd": ([f32(3, 4, 2), i64(5, 2, hi=3)], {}),
    "greater_equal": ([f32(3, 4), f32(3, 4, seed=1)], {}),
    "greater_than": ([f32(3, 4), f32(3, 4, seed=1)], {}),
    "histogram": ([f32(50)], {"bins": 7, "min": -1, "max": 1}),
    "imag": ([np.array([1 + 2j, 3 - 1j], np.complex64)], {}),
    "increment": ([f32(3)], {"value": 2.0}),
    "index_sample": ([f32(3, 5), i64(3, 2, hi=5)], {}),
    "index_select": ([f32(5, 3), i64(4, hi=3)], {"axis": 1}),
    "inner": ([f32(3, 4), f32(2, 4, seed=1)], {}),
    "inverse": ([spd()], {}),
    "is_complex": ([f32(3)], {}),
    "is_empty": ([f32(0, 3)], {}),
    "is_integer": ([i64(3)], {}),
    "isclose": ([f32(3, 4), f32(3, 4) + 1e-3], {"rtol": 1e-4}),
    "isfinite": ([np.array([1.0, np.inf, np.nan], np.float32)], {}),
    "isinf": ([np.array([1.0, np.inf, np.nan], np.float32)], {}),
    "isnan": ([np.array([1.0, np.inf, np.nan], np.float32)], {}),
    "kron": ([f32(2, 3), f32(2, 2, seed=1)], {}),
    "kthvalue": ([f32(3, 5)], {"k": 2, "axis": -1}),
    "lerp": ([f32(3, 4), f32(3, 4, seed=1), f32(3, 4, lo=0, hi=1, seed=2)], {}),
    "less_equal": ([f32(3, 4), f32(3, 4, seed=1)], {}),
    "less_than": ([f32(3, 4), f32(3, 4, seed=1)], {}),
    "lgamma": ([pos(3, 4)], {}),
    "linspace": ([0.0, 1.0, 5], {}),
    "log": ([pos(3, 4)], {}),
    "log10": ([pos(3, 4)], {}),
    "log1p": ([pos(3, 4)], {}),
    "log2": ([pos(3, 4)], {}),
    "logical_and": ([BOOL, ~BOOL[::-1]], {}),
    "logical_not": ([BOOL], {}),
    "logical_or": ([BOOL, ~BOOL[::-1]], {}),
    "logical_xor": ([BOOL, ~BOOL[::-1]], {}),
    "logsumexp": ([f32(3, 4)], {"axis": 1}),
    "lstsq": ([f32(6, 3), f32(6, 2, seed=1)], {}),
    "masked_select": ([f32(2, 3), BOOL], {}),
    "matmul": ([f32(3, 4), f32(5, 4, seed=1)], {"transpose_y": True}),
    "matrix_power": ([f32(3, 3)], {"n": 3}),
    "matrix_rank": ([np.array([[1, 2], [2, 4], [0, 1]], np.float32)], {}),
    "max": ([f32(3, 4)], {"axis": 1, "keepdim": True}),
    "maximum": ([f32(3, 4), f32(3, 4, seed=1)], {}),
    "mean": ([f32(3, 4)], {"axis": [0, 1]}),
    "median": ([f32(3, 4)], {"axis": 1}),
    "meshgrid": ([f32(3), f32(2, seed=1)], {}),
    "min": ([f32(3, 4)], {}),
    "minimum": ([f32(3, 4), f32(3, 4, seed=1)], {}),
    "mod": ([i64(3, 4, lo=-9, hi=9), i64(3, 4, lo=1, hi=4, seed=1)], {}),
    "mode": ([np.array([[1, 2, 2, 3], [4, 4, 1, 1]], np.float32)], {"axis": -1}),
    "multiplex": ([[f32(3, 2), f32(3, 2, seed=1)], np.array([[1], [0], [1]], np.int32)], {}),
    "multiply": ([f32(3, 4), f32(3, 4, seed=1)], {}),
    "mv": ([f32(3, 4), f32(4, seed=1)], {}),
    "nanmean": ([np.array([[1.0, np.nan], [3.0, 4.0]], np.float32)], {"axis": 1}),
    "nanmedian": ([np.array([[1.0, np.nan, 2.0], [3.0, 4.0, 8.0]], np.float32)], {"axis": 1}),
    "nansum": ([np.array([[1.0, np.nan], [3.0, 4.0]], np.float32)], {}),
    "nonzero": ([np.array([[0, 1], [2, 0]], np.int64)], {}),
    "norm": ([f32(3, 4)], {"p": 2, "axis": 1}),
    "not_equal": ([i64(3, 4), i64(3, 4, seed=1)], {}),
    "numel": ([f32(3, 4)], {}),
    "ones": ([[2, 3]], {"dtype": "int32"}),
    "ones_like": ([f32(2, 3)], {}),
    "outer": ([f32(3), f32(4, seed=1)], {}),
    "pinv": ([f32(4, 3)], {}),
    "pixel_shuffle": ([f32(1, 8, 2, 3)], {"upscale_factor": 2}),
    "pixel_unshuffle": ([f32(1, 2, 4, 6)], {"downscale_factor": 2}),
    "pow": ([pos(3, 4), f32(3, 4, seed=1)], {}),
    "prod": ([f32(3, 4)], {"axis": 0}),
    "put_along_axis": ([f32(3, 4), i64(3, 1, hi=4), f32(3, 1, seed=1)], {"axis": 1}),
    "qr": ([f32(4, 3)], {}),
    "quantile": ([f32(3, 5)], {"q": 0.3, "axis": 1}),
    "rank": ([f32(3, 4)], {}),
    "real": ([np.array([1 + 2j, 3 - 1j], np.complex64)], {}),
    "reciprocal": ([pos(3, 4)], {}),
    "remainder": ([i64(3, 4, lo=-9, hi=9), i64(3, 4, lo=1, hi=4, seed=1)], {}),
    "repeat_interleave": ([f32(2, 3)], {"repeats": 2, "axis": 1}),
    "reshape": ([f32(3, 4)], {"shape": [2, -1]}),
    "reverse": ([f32(3, 4)], {"axis": 1}),
    "roll": ([f32(3, 4)], {"shifts": 1, "axis": 1}),
    "round": ([f32(3, 4) * 3], {}),
    "rsqrt": ([pos(3, 4)], {}),
    "scale": ([f32(3, 4)], {"scale": 2.0, "bias": 0.5, "bias_after_scale": False}),
    "scatter": ([f32(5, 3), np.array([1, 3], np.int64), f32(2, 3, seed=1)], {}),
    "scatter_nd": ([np.array([[1], [3]], np.int64), f32(2, 3), [5, 3]], {}),
    "scatter_nd_add": ([f32(5, 3), np.array([[1], [1]], np.int64), f32(2, 3, seed=1)], {}),
    "searchsorted": ([np.array([1.0, 2.0, 4.0, 8.0], np.float32), f32(5, lo=0, hi=9)],
                     {"right": True}),
    "shape": ([f32(3, 4)], {}),
    "shard_index": ([i64(6, 1, hi=20)], {"index_num": 20, "nshards": 2, "shard_id": 1}),
    "sign": ([f32(3, 4)], {}),
    "sin": ([f32(3, 4)], {}),
    "sinh": ([f32(3, 4)], {}),
    "slice": ([f32(4, 5)], {"axes": [0, 1], "starts": [1, -3], "ends": [3, 10]}),
    "slogdet": ([spd()], {}),
    "solve": ([spd(), f32(4, 2, seed=1)], {}),
    "sort": ([f32(3, 4)], {"axis": 0, "descending": True}),
    "split": ([f32(6, 4)], {"num_or_sections": [2, -1], "axis": 0}),
    "sqrt": ([pos(3, 4)], {}),
    "square": ([f32(3, 4)], {}),
    "squeeze": ([f32(3, 1, 4)], {"axis": 1}),
    "stack": ([[f32(3), f32(3, seed=1)]], {"axis": 1}),
    "stanh": ([f32(3, 4)], {}),
    "std": ([f32(3, 4)], {"axis": 1}),
    "strided_slice": ([f32(6, 5)], {"axes": [0, 1], "starts": [5, 0], "ends": [0, 5],
                                    "strides": [-2, 2]}),
    "subtract": ([f32(3, 4), f32(3, 4, seed=1)], {}),
    "sum": ([f32(3, 4)], {"axis": 1, "keepdim": True}),
    "svd": ([f32(4, 3)], {}),
    "t": ([f32(3, 4)], {}),
    "take_along_axis": ([f32(3, 4), i64(3, 2, hi=4)], {"axis": 1}),
    "tanh": ([f32(3, 4)], {}),
    "tile": ([f32(2, 3)], {"repeat_times": [2, 1]}),
    "to_tensor": ([[[1.0, 2.0], [3.0, 4.0]]], {}),
    "topk": ([f32(3, 5)], {"k": 2}),
    "trace": ([f32(4, 4)], {"offset": 1}),
    "transpose": ([f32(2, 3, 4)], {"perm": [2, 0, 1]}),
    "triangular_solve": ([np.triu(spd()), f32(4, 2, seed=1)], {"upper": True}),
    "tril": ([f32(4, 4)], {"diagonal": -1}),
    "triu": ([f32(4, 4)], {"diagonal": 1}),
    "trunc": ([f32(3, 4) * 3], {}),
    "unbind": ([f32(3, 4)], {"axis": 1}),
    "unique": ([i64(10, hi=4)], {"return_index": True, "return_inverse": True,
                                 "return_counts": True}),
    "unsqueeze": ([f32(3, 4)], {"axis": [0, 2]}),
    "unstack": ([f32(3, 4)], {"axis": 0}),
    "var": ([f32(3, 4)], {"axis": 0, "unbiased": False}),
    "where": ([BOOL, f32(2, 3), f32(2, 3, seed=1)], {}),
    "zeros": ([[2, 3]], {}),
    "zeros_like": ([f32(2, 3)], {}),
}

# draws: (args, kwargs, check(values) on the port's and the JAX package's draws)
RANDOM = {
    "bernoulli": ([f32(4, 5, lo=0, hi=1)], {}, lambda v: set(np.unique(v)) <= {0.0, 1.0}),
    "multinomial": ([np.full((3, 6), 1 / 6, np.float32)], {"num_samples": 4},
                    lambda v: v.min() >= 0 and v.max() < 6 and all(len(set(r)) == 4 for r in v)),
    "normal": ([], {"mean": 1.0, "std": 2.0, "shape": [4, 5]}, lambda v: np.isfinite(v).all()),
    "uniform": ([[4, 5]], {"min": -3.0, "max": -1.0},
                lambda v: v.min() >= -3.0 and v.max() < -1.0),
    "randn": ([[4, 5]], {}, lambda v: np.isfinite(v).all()),
    "rand": ([[4, 5]], {}, lambda v: v.min() >= 0.0 and v.max() < 1.0),
    "randint": ([2, 9], {"shape": [4, 5]}, lambda v: v.min() >= 2 and v.max() < 9),
    "randperm": ([7], {}, lambda v: sorted(v.tolist()) == list(range(7))),
    "poisson": ([f32(4, 5, lo=1, hi=3)], {}, lambda v: v.min() >= 0 and (v == np.round(v)).all()),
    "standard_normal": ([[4, 5]], {}, lambda v: np.isfinite(v).all()),
}


# the JAX package's poisson names ``jax`` without importing it
# (paddle_tpu/ops/__init__.py:1359): the port's draws are checked alone
JAX_FAULTS = {"poisson"}


def _args(pkg, args):
    def conv(a):
        if isinstance(a, np.ndarray):
            return pkg.to_tensor(a)
        if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
            return [pkg.to_tensor(x) for x in a]
        return a
    return [conv(a) for a in args]


def _np(v):
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return (v.resolve_conj() if v.is_complex() else v).numpy()
    return np.asarray(v)


def assert_same(got, want, name):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), name
        for g, w in zip(got, want):
            assert_same(g, w, name)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, f"{name}: shape {g.shape} vs {w.shape}"
    if w.dtype.kind in "biu" or g.dtype.kind in "biu":
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64), err_msg=name)
    else:
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)


def _call(ns, name, args, kwargs):
    return getattr(ns, name)(*args, **kwargs)


def test_every_tensor_name_has_a_case():
    names = {n for n in dir(jtensor) if not n.startswith("_") and callable(getattr(jtensor, n))
             and not isinstance(getattr(jtensor, n), type(np))}
    assert names == set(CASES) | set(RANDOM), sorted(names ^ (set(CASES) | set(RANDOM)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_tensor_name_matches_jax(name):
    args, kwargs = CASES[name]
    want = _call(jtensor, name, _args(jp, args), kwargs)
    got = _call(tensor, name, _args(paddle, args), kwargs)
    if name == "svd":
        (u, s, vh), (ju, js, jvh) = got, want
        assert_same(s, js, name)
        np.testing.assert_allclose(_np(u) * _np(s)[None] @ _np(vh), _np(ju) * _np(js)[None]
                                   @ _np(jvh), rtol=RTOL, atol=1e-5)
        return
    if name == "eigh":
        assert_same(got[0], want[0], name)
        np.testing.assert_allclose(np.abs(_np(got[1])), np.abs(_np(want[1])), rtol=1e-4,
                                   atol=1e-5)
        return
    if name == "eig":
        np.testing.assert_allclose(np.sort_complex(_np(got[0])), np.sort_complex(_np(want[0])),
                                   rtol=1e-4)
        return
    if name in ("lstsq", "qr"):
        want, got = want[:2] if name == "qr" else want[:1], got[:2] if name == "qr" else got[:1]
        if name == "qr":
            got = [np.abs(_np(g)) for g in got]
            want = [np.abs(_np(w)) for w in want]
    assert_same(got, want, name)


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_name_draws_from_the_same_law(name):
    args, kwargs, check = RANDOM[name]
    got = _np(_call(tensor, name, _args(paddle, args), kwargs))
    assert check(got)
    if name in JAX_FAULTS:
        assert got.shape == tuple(args[0].shape) and got.dtype == args[0].dtype
        return
    want = _np(_call(jtensor, name, _args(jp, args), kwargs))
    assert got.shape == want.shape and got.dtype.kind == want.dtype.kind
    assert check(want)


@pytest.mark.parametrize("name", sorted(n for n in dir(jlinalg) if not n.startswith("_")))
def test_linalg_name_is_the_tensor_names(name):
    """``linalg`` re-exports ``tensor.linalg`` in both packages: each name is
    the one the tensor cases hold against the JAX package."""
    assert getattr(linalg, name) is getattr(tensor, name)
    assert name in CASES


def test_submodules_exist():
    for mod in ("attribute", "creation", "linalg", "logic", "manipulation", "math", "random",
                "search", "stat"):
        assert hasattr(tensor, mod), mod


def test_category_membership():
    assert tensor.creation.to_tensor is paddle.to_tensor
    assert tensor.math.add is paddle.add
    assert tensor.linalg.matmul is paddle.matmul
    assert tensor.manipulation.reshape is paddle.reshape
    assert tensor.search.argmax is paddle.argmax
    assert tensor.stat.mean is paddle.mean


def test_flat_namespace_reexports():
    x = paddle.to_tensor(np.array([[1.0, 2.0], [3.0, 4.0]], np.float32))
    np.testing.assert_allclose(tensor.matmul(x, x).numpy(), [[7, 10], [15, 22]])


def test_linalg_namespace():
    x = paddle.to_tensor(np.eye(3, dtype=np.float32) * 2)
    assert float(linalg.det(x).numpy()) == 8.0
    np.testing.assert_allclose(linalg.inverse(x).numpy(), np.eye(3) / 2)


def test_new_tail_ops():
    x = paddle.to_tensor(np.array([1.0, 2.0, 3.0], np.float32))
    assert int(paddle.rank(x).numpy()) == 1
    np.testing.assert_allclose(paddle.increment(x, 2.0).numpy(), [3, 4, 5])
    assert tuple(paddle.outer(x, x).shape) == (3, 3)
    d = paddle.dist(x, paddle.to_tensor(np.zeros(3, np.float32)))
    np.testing.assert_allclose(float(d.numpy()), np.sqrt(14), rtol=1e-6)
    np.testing.assert_allclose(paddle.stanh(x, 0.67, 1.7159).numpy(),
                               1.7159 * np.tanh(0.67 * np.array([1, 2, 3])), rtol=1e-5)


def test_top_level_is_the_tensor_namespace():
    """Every top-level function the JAX package shares with its tensor
    namespace is the port's tensor function too."""
    shared = [n for n in dir(jtensor) if not n.startswith("_") and hasattr(jp, n)
              and getattr(jp, n) is getattr(jtensor, n)]
    assert len(shared) >= 140
    assert all(getattr(paddle, n) is getattr(tensor, n) for n in shared)


def test_data_dependent_ops_refuse_a_static_program():
    from paddle_tpu_torch import static
    from paddle_tpu_torch.errors import UnimplementedError

    static.enable_static()
    try:
        with static.program_guard(static.Program()):
            x = static.data("x", [4], "float32")
            for fn in (tensor.nonzero, tensor.unique, tensor.masked_select):
                with pytest.raises(UnimplementedError, match="data-dependent"):
                    fn(x, x) if fn is tensor.masked_select else fn(x)
    finally:
        static.disable_static()
