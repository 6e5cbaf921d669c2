"""Port parity: compiled serving (``Predictor``, ``ProgramPredictor`` and the static executor replaying a graph per signature; ``ReplicaPool`` warmup and ``CompileWatch``; ``/statz`` ``compiles``), and the card's AdamW bias correction.

CUDA graphs run only on the card (``chip_smoke.py``). Here the capture path
runs on the CPU through a stand-in graph: a capture runs its body once, as
a real capture records it once, and each replay runs the same body again
on the entry's static inputs and writes the result into the entry's
outputs in place, as a real replay rewrites them. So a replay's answer can
be checked: it is the answer to whatever the static inputs held while it
ran. The stand-in sleeps inside a replay, which widens the window in which
an unlocked replay would let another thread's input in.

The executor's capture path is held against the JAX ``Predictor`` on the
same saved directories, f32 and int8, with the tolerances of
``tests/test_torch_static_int8.py``.
"""
import contextlib
import gc
import json
import sys
import threading
import time
from urllib.request import Request, urlopen

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu.static as jstatic  # noqa: E402
from paddle_tpu import ops as jops  # noqa: E402
from paddle_tpu import slim as jslim  # noqa: E402
from paddle_tpu.inference import Config as JConfig  # noqa: E402
from paddle_tpu.inference import create_predictor as jcreate_predictor  # noqa: E402

from paddle_tpu_torch import optimizer as port_opt  # noqa: E402
from paddle_tpu_torch import static  # noqa: E402
from paddle_tpu_torch.errors import PreconditionNotMetError  # noqa: E402
from paddle_tpu_torch.framework import jit as port_jit  # noqa: E402
from paddle_tpu_torch.inference import Config, Predictor, create_predictor  # noqa: E402
from paddle_tpu_torch.jit_api import InputSpec  # noqa: E402
from paddle_tpu_torch.ops import cuda as port_kernels  # noqa: E402
from paddle_tpu_torch.runtime import compiled  # noqa: E402
from paddle_tpu_torch.serving import InferenceServer  # noqa: E402
from paddle_tpu_torch.static import executor as port_executor  # noqa: E402

torch.set_num_threads(1)

WIDTH, HIDDEN, CLASSES = 8, 16, 4
BUCKETS = (1, 2, 4)


# -- the stand-in graph -------------------------------------------------------------


class _ReplayingGraph:
    """``torch.cuda.CUDAGraph``'s surface; ``replay`` runs ``body``."""

    made = []

    def __init__(self):
        self.replays = 0
        self.body = None
        _ReplayingGraph.made.append(self)

    def register_generator_state(self, gen):
        pass

    def replay(self):
        self.replays += 1
        time.sleep(1e-4)
        self.body()


def _write(dst, src):
    """``src`` written into ``dst`` in place (tensors alone or in a tuple,
    list or dict), as a replay rewrites a graph's outputs."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _write(dst[k], src[k])
    else:
        for d, s in zip(dst, src):
            _write(d, s)


@pytest.fixture
def graphs(monkeypatch):
    """The capture path on the CPU: CUDA graphs replaced by
    :class:`_ReplayingGraph`, the eager first run on the caller's stream.
    Yields the graphs made."""
    _ReplayingGraph.made = []
    capture = compiled.GraphStore.capture

    def capturing(self, sig, fn, inputs, generators=()):
        entry = capture(self, sig, fn, inputs, generators)
        entry.graph.body = lambda: _write(entry.outputs, fn(*entry.inputs))
        return entry

    @contextlib.contextmanager
    def graph(g, **kw):
        yield g

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _ReplayingGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(compiled.GraphStore, "capture", capturing)
    for mod in (port_jit, port_executor):
        monkeypatch.setattr(mod, "_captures", lambda device: True)
        monkeypatch.setattr(mod, "_first_run", lambda device, fn: fn())
    yield _ReplayingGraph.made


# -- a module predictor -------------------------------------------------------------


class _TwoOutputs(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.fc1 = torch.nn.Linear(WIDTH, HIDDEN)
        self.fc2 = torch.nn.Linear(HIDDEN, CLASSES)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g))

    def forward(self, x):
        y = self.fc2(torch.relu(self.fc1(x)))
        return y, y.sum(-1)


def _predictor():
    return Predictor(_TwoOutputs(), [InputSpec([None, WIDTH], "float32", "x")], ["y", "s"],
                     device="cpu")


def _rows(rows, seed):
    return np.random.RandomState(seed).randn(rows, WIDTH).astype(np.float32)


def _eager(pred, a):
    with torch.no_grad():
        return [o.numpy() for o in pred.module(torch.from_numpy(a))]


def _equal(got, want):
    return len(got) == len(want) and all(np.array_equal(g, w) for g, w in zip(got, want))


def test_one_capture_per_bucket_for_a_predictor_and_its_clones(graphs):
    pred = _predictor()
    replicas = [pred] + [pred.clone() for _ in range(3)]
    assert all(r.store is pred.store for r in replicas)
    for i, r in enumerate(replicas):
        for bucket in BUCKETS:
            a = _rows(bucket, 10 * i + bucket)
            assert _equal(r.run([a]), _eager(pred, a))
    store = pred.store
    assert (store.misses, store.hits, len(store), len(graphs)) == (3, 9, 3, 3)
    assert sorted(g.replays for g in graphs) == [3, 3, 3]


def test_a_replay_answers_for_its_own_input(graphs):
    pred = _predictor()
    a, b = _rows(4, 1), _rows(4, 2)
    first = pred.run([a])  # the eager first run, then the capture
    again = pred.run([b])  # a replay
    assert _equal(first, _eager(pred, a)) and _equal(again, _eager(pred, b))
    assert not np.array_equal(again[0], first[0])
    assert graphs[0].replays == 1 and pred.store.misses == 1


def test_two_threads_replaying_one_entry_each_get_their_own_answer(graphs):
    """The entry's lock makes copy-in, replay and copy-out one unit: each
    of 2 x 20 concurrent runs of one bucket equals its input's answer
    replayed alone."""
    pred = _predictor()
    pred.run([np.zeros((4, WIDTH), np.float32)])
    inputs = [[_rows(4, 100 * t + i) for i in range(20)] for t in range(2)]
    solo = [[pred.run([a]) for a in per] for per in inputs]
    got = [[None] * 20 for _ in range(2)]
    clones = [pred.clone(), pred.clone()]

    def work(t):
        for i, a in enumerate(inputs[t]):
            got[t][i] = clones[t].run([a])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert all(_equal(got[t][i], solo[t][i]) for t in range(2) for i in range(20))
    assert len(graphs) == 1 and graphs[0].replays == 80 and pred.store.misses == 1


def test_threads_that_miss_one_signature_capture_it_once(graphs):
    pred = _predictor()
    a = _rows(2, 5)
    outs = [None] * 4

    def work(i):
        outs[i] = pred.clone().run([a])

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    assert not any(th.is_alive() for th in threads)
    assert all(_equal(o, _eager(pred, a)) for o in outs)
    assert (pred.store.misses, pred.store.hits, len(graphs)) == (1, 3, 1)


def test_tf32_keys_a_new_entry(graphs):
    pred = _predictor()
    a = _rows(2, 3)
    pred.run([a])
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        pred.run([a])
        pred.run([a])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    pred.run([a])
    assert (pred.store.misses, pred.store.hits, len(graphs)) == (2, 2, 2)
    assert {sig[1] for sig in pred.store.entries()} == {(False, False), (True, False)}


def test_a_failed_capture_raises_and_runs_nothing_eagerly(graphs, monkeypatch):
    @contextlib.contextmanager
    def refusing(g, **kw):
        raise RuntimeError("operation not permitted when stream is capturing")
        yield  # pragma: no cover

    monkeypatch.setattr(torch.cuda, "graph", refusing)
    pred = _predictor()
    with pytest.raises(compiled.CaptureError, match="not run eagerly"):
        pred.run([_rows(2, 1)])
    with pytest.raises(compiled.CaptureError, match="failed before"):
        pred.run([_rows(2, 2)])
    assert len(pred.store) == 0


def test_a_capture_books_only_its_own_threads_launches(graphs):
    """Another thread counts launches while a capture records (a replica
    replaying another bucket): the capture takes back and books only what
    its own thread counted."""
    port_kernels.reset_launch_counts()
    store = compiled.GraphStore("eval_step")
    inside, done = threading.Event(), threading.Event()
    entries = []

    def body(x):
        port_kernels.add_counts({"int8_matmul": 2, "int8_matmul.SPLITS": 1})
        inside.set()
        done.wait(10)
        return x * 2

    worker = threading.Thread(target=lambda: entries.append(
        store.capture("s", body, [torch.ones(2)])))
    worker.start()
    assert inside.wait(10)
    port_kernels.add_counts({"int8_matmul": 5})  # the other thread's launches
    done.set()
    worker.join(10)
    assert not worker.is_alive()
    (entry,) = entries
    assert entry.counts == {"int8_matmul": 2, "int8_matmul.SPLITS": 1}
    assert port_kernels.counts()["int8_matmul"] == 5
    assert port_kernels.counts()["int8_matmul.SPLITS"] == 0
    port_kernels.reset_launch_counts()


# -- the static executor ------------------------------------------------------------


@pytest.fixture
def port_static():
    static.enable_static()
    static.reset_default_programs()
    yield
    static.disable_static()
    static.reset_default_programs()


def _fc_program():
    """x [None, 8] -> fc 16 relu -> fc 4 in the port, its weights drawn
    into a scope of its own: (program, fetch name, scope, weight names)."""
    program = static.Program()
    with static.program_guard(program, static.Program()):
        x = static.data("x", [None, WIDTH], "float32")
        y = static.nn.fc(static.nn.fc(x, HIDDEN, activation="relu"), CLASSES)
        scope = static.Scope()
        static.Executor("cpu").run_startup(static.default_startup_program(), scope=scope)
    return program, y.name, scope


def _fc_answer(scope, a):
    """The program's answer in numpy from the scope's weights."""
    w1, b1, w2, b2 = (scope.numpy(n) for n in sorted(scope.var_names(),
                                                     key=lambda n: int(n.split("_")[-1])))
    return np.maximum(a @ w1 + b1, 0) @ w2 + b2


def test_executor_captures_once_per_signature_and_replays(graphs, port_static):
    program, y, scope = _fc_program()
    exe = static.Executor("cpu")
    outs = [exe.run(program, feed={"x": _rows(4, i)}, fetch_list=[y], scope=scope)[0]
            for i in range(3)]
    for i, o in enumerate(outs):
        np.testing.assert_allclose(o, _fc_answer(scope, _rows(4, i)), rtol=1e-5, atol=1e-5)
    dev = exe.run(program, feed={"x": _rows(4, 9)}, fetch_list=[y], scope=scope,
                  return_numpy=False)[0]
    entry = next(iter(exe.store.entries().values()))
    assert isinstance(dev, torch.Tensor) and dev is not entry.outputs[0]
    assert torch.equal(dev, entry.outputs[0])
    assert (exe.store.misses, exe.store.hits, len(graphs)) == (1, 3, 1)
    assert entry.cache_key.startswith("executor#")
    exe.run(program, feed={"x": _rows(2, 0)}, fetch_list=[y], scope=scope)
    exe.run(program, feed={"x": _rows(2, 0).astype(np.float64)}, fetch_list=[y], scope=scope)
    assert exe.store.misses == 2  # a new shape; the block's cast makes float64 the same feed


def test_a_new_program_with_the_old_programs_id_does_not_replay_its_graph(graphs, port_static):
    """Programs run and freed; a new one made at a freed one's address
    (its ``id``) reads the same weights (``param_0..3`` of that program's
    scope) at the same version, through gelu in place of relu: a graph
    keyed by ``id`` would replay the relu answer."""
    exe = static.Executor("cpu")
    a = _rows(4, 1)
    freed = {}
    for _ in range(20):  # several, so that one address surely comes back
        program, y, scope = _fc_program()
        exe.run(program, feed={"x": a}, fetch_list=[y], scope=scope)
        freed[id(program)] = (program._identity_token, program._version, scope)
        del program
    for g in graphs:
        g.body = None  # the stand-in's body held its program; a real graph does not
    gc.collect()
    made = []
    while len(made) < 5000 and (not made or id(made[-1]) not in freed):
        made.append(static.Program())
    other = made[-1]
    old_token, old_version, scope = freed[id(other)]
    assert other._identity_token != old_token
    with static.program_guard(other, static.Program()):
        x = static.data("x", [None, WIDTH], "float32")
        z = static.nn.fc(static.nn.fc(x, HIDDEN, activation="gelu"), CLASSES)
    assert z.name == y and other._version == old_version  # all but the token alike
    got = exe.run(other, feed={"x": a}, fetch_list=[z], scope=scope)[0]
    want = static.Executor("cpu").run(other, feed={"x": a}, fetch_list=[z], scope=scope)[0]
    assert exe.store.misses == 21 and np.array_equal(got, want)
    assert not np.allclose(got, _fc_answer(scope, a))


def test_scope_set_of_a_read_weight_recaptures(graphs, port_static):
    program, y, scope = _fc_program()
    exe = static.Executor("cpu")
    a = _rows(4, 2)
    before = exe.run(program, feed={"x": a}, fetch_list=[y], scope=scope)[0]
    exe.run(program, feed={"x": a}, fetch_list=[y], scope=scope)
    name = program.global_block().ops[0].inputs["X"][1]
    scope.set(name, scope.numpy(name) * 2)
    after = exe.run(program, feed={"x": a}, fetch_list=[y], scope=scope)[0]
    again = exe.run(program, feed={"x": a}, fetch_list=[y], scope=scope)[0]
    np.testing.assert_allclose(after, _fc_answer(scope, a), rtol=1e-5, atol=1e-5)
    assert not np.allclose(after, before) and np.array_equal(again, after)
    assert (exe.store.misses, exe.store.hits) == (2, 2)
    scope.set("a_new_name", np.zeros(1, np.float32))  # a new name replaces nothing
    exe.run(program, feed={"x": a}, fetch_list=[y], scope=scope)
    assert exe.store.misses == 2


def test_cpu_runs_interpret_and_capture_nothing(port_static):
    program, y, scope = _fc_program()
    exe = static.Executor("cpu")
    a = _rows(3, 4)
    np.testing.assert_allclose(exe.run(program, feed={"x": a}, fetch_list=[y], scope=scope)[0],
                               _fc_answer(scope, a), rtol=1e-5, atol=1e-5)
    assert (exe.store.misses, exe.store.hits, len(exe.store)) == (0, 0, 0)


# -- the executor's capture path against the JAX Predictor ---------------------------


@pytest.fixture
def jax_static():
    jstatic.enable_static()
    jstatic.reset_default_programs()
    jstatic.global_scope().clear()
    yield
    jstatic.disable_static()
    jstatic.reset_default_programs()
    jstatic.global_scope().clear()


def _jax_net():
    x = jstatic.data("x", [None, 32], "float32")
    h = x
    for _ in range(2):
        a = jstatic.nn.fc(h, 64, activation="gelu")
        a = jstatic.nn.fc(a, 32)
        h = jstatic.nn.layer_norm(jops.add(h, a))
    return jstatic.nn.fc(h, 2)


def _jax_answers(path, arrays):
    pred = jcreate_predictor(JConfig(path))
    outs = []
    for a in arrays:
        pred.get_input_handle("x").copy_from_cpu(a)
        pred.run()
        outs.append(np.array(pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()))
    return outs


def _flip_step(program):
    """The largest ``scale_x * scale_y / 127`` over the int8 products: what
    one activation's rounding flip can move an output by
    (``tests/test_torch_static_int8.py``)."""
    return max(op.attrs["scale_x"] * op.attrs["scale_y"] / 127.0
               for op in program.global_block().ops if op.type.endswith("_int8"))


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_captured_executor_serves_a_saved_directory_as_the_jax_predictor(graphs, jax_static,
                                                                         tmp_path, kind):
    y = _jax_net()
    exe = jstatic.Executor()
    exe.run_startup()
    path = str(tmp_path / kind)
    rng = np.random.RandomState(3)
    if kind == "f32":
        jstatic.save_inference_model(path, ["x"], [y], exe)
    else:
        calib = [{"x": rng.randn(16, 32).astype(np.float32)} for _ in range(4)]
        ptq = jslim.PostTrainingQuantization(exe, jstatic.default_main_program(), calib)
        ptq.quantize()
        ptq.save_int8_model(path, ["x"], [y])
    jstatic.disable_static()
    tests = [rng.randn(5, 32).astype(np.float32) for _ in range(3)]
    want = _jax_answers(path, tests)
    pred = create_predictor(Config(path), device="cpu")
    replicas = [pred, pred.clone(), pred.clone()]
    for r, a, w in zip(replicas, tests, want):
        got = r.run([a])[0]
        assert got.shape == w.shape and got.dtype == np.float32
        err = np.abs(got - w)
        if kind == "f32":  # f32 sums in another order, gelu and rsqrt by others
            assert err.max() <= 2e-6 * np.abs(w).max()
        else:
            assert np.median(err) <= 1e-6 * np.abs(w).max()
            assert err.max() <= _flip_step(pred._program)
    assert (pred.store.misses, pred.store.hits, len(graphs)) == (1, 2, 1)
    assert graphs[0].replays == 2


# -- warmup, CompileWatch, /statz -------------------------------------------------------


def _post(url, a):
    body = json.dumps({"inputs": a.tolist()}).encode()
    with urlopen(Request(url + "/predict", data=body,
                         headers={"Content-Type": "application/json"}), timeout=60) as r:
        return r.status, json.loads(r.read())


def _statz(url):
    with urlopen(url + "/statz", timeout=60) as r:
        return json.loads(r.read())


def test_warmup_captures_every_bucket_and_extra_compiles_counts_after(graphs):
    pred = _predictor()
    srv = InferenceServer(pred, port=0, replicas=3, buckets=BUCKETS, batch_timeout_ms=1.0)
    with pytest.raises(PreconditionNotMetError, match="before warmup"):
        srv.pool.extra_compiles()
    srv.start()
    try:
        assert pred.store.misses == len(BUCKETS) and srv.pool.extra_compiles() == 0
        for rows in (1, 3, 2, 4, 1):
            a = _rows(rows, rows)
            status, body = _post(srv.url, a)
            assert status == 200 and body["rows"] == rows
            np.testing.assert_allclose(np.asarray(body["outputs"]["y"], np.float32),
                                       _eager(pred, a)[0], rtol=1e-6, atol=1e-6)
        assert srv.pool.extra_compiles() == 0 and pred.store.misses == len(BUCKETS)
        assert _statz(srv.url)["compiles"] == {"buckets": len(BUCKETS), "unexpected": 0}
        pred.run([_rows(3, 0)])  # off the ladder: a capture
        assert srv.pool.extra_compiles() == 1
        _post(srv.url, _rows(2, 1))  # the worker that runs it notes the capture
        assert _statz(srv.url)["compiles"] == {"buckets": len(BUCKETS), "unexpected": 1}
        assert srv.pool.extra_compiles() == 1 and srv.pool.unexpected_compiles() == 1
    finally:
        srv.stop(drain=True)
    assert srv.pool.alive == 0


def test_statz_carries_compiles_for_a_program_predictor(graphs, port_static, tmp_path):
    program, y, scope = _fc_program()
    exe = static.Executor("cpu")
    path = str(tmp_path / "fc")
    static.save_inference_model(path, ["x"], [y], exe, main_program=program, scope=scope)
    static.disable_static()
    pred = create_predictor(Config(path), device="cpu")
    ref = create_predictor(Config(path), device="cpu")
    srv = InferenceServer(pred, port=0, replicas=2, buckets=BUCKETS, batch_timeout_ms=1.0)
    srv.start()
    try:
        a = _rows(3, 7)
        status, body = _post(srv.url, a)
        assert status == 200
        np.testing.assert_allclose(np.asarray(body["outputs"][y], np.float32),
                                   ref.run([a])[0], rtol=1e-6, atol=1e-6)
        stats = _statz(srv.url)
        assert stats["compiles"] == {"buckets": len(BUCKETS), "unexpected": 0}
        assert pred.store.misses == len(pred.store) == len(BUCKETS)
    finally:
        srv.stop(drain=True)


def test_compile_watch_counts_a_capture_once_across_workers():
    count = [0]
    watch = compiled.CompileWatch(lambda: count[0])
    assert not watch.armed
    with pytest.raises(PreconditionNotMetError):
        watch.extra()
    count[0] = 3
    watch.arm()
    assert watch.armed and watch.extra() == 0
    watch.note(replica=0, bucket=1)
    count[0] = 5
    threads = [threading.Thread(target=watch.note, kwargs={"replica": i, "bucket": 2})
               for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(10)
    assert watch.extra() == 2 and watch.noted == 2


# -- the card's AdamW bias correction -----------------------------------------------

# t at which glibc's powf, which XLA's CPU pow reaches, misrounds 0.999**t
# by an ulp: there the correctly rounded power parts from the JAX value
POWF_MISROUNDS = {0.999: [2958, 3606]}


@pytest.mark.parametrize("beta", [0.9, 0.98, 0.99, 0.999])
def test_repaired_bias_correction_is_the_jax_traced_value(beta):
    """The card's formula (``optimizer._bias_correction``: the power in
    float64, rounded once to float32) against the JAX compiled step's
    ``1 - beta**t`` (64-bit types off, the package's setting) for t =
    1..100,000: equal but at the pinned t, where it is 1 ulp off."""
    t = np.arange(1, 100001, dtype=np.int32)
    with jax.enable_x64(False):
        want = np.asarray(jax.jit(lambda t: 1 - jnp.float32(beta)**t)(jnp.asarray(t)))
        scalar = [np.asarray(jax.jit(lambda t: 1 - beta**t)(jnp.int32(i))) for i in (1, 2958)]
    assert want.dtype == np.float32 and [s.item() for s in scalar] == [want[0], want[2957]]
    got = port_opt._bias_correction(beta, torch.from_numpy(t)).numpy()
    assert got.dtype == np.float32
    differ = (np.nonzero(got != want)[0] + 1).tolist()
    assert differ == POWF_MISROUNDS.get(beta, [])
    for i in differ:
        assert abs(float(got[i - 1]) - float(want[i - 1])) == np.spacing(np.float32(want[i - 1]))
    # a 0-dim t, as the optimizer's, gives the same values
    for i in [1, 100, 2958, 100000]:
        assert port_opt._bias_correction(beta, torch.tensor(i, dtype=torch.int32)).item() == \
            got[i - 1]
