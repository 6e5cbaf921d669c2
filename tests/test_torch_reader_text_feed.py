"""``reader``, ``text`` and ``io``'s file feed against the JAX package's.

Counterparts of the reader part of ``tests/test_reader_nets_datasets.py``,
of ``tests/test_text_datasets.py`` and of ``tests/test_dataset_feed.py``:
the ten ``reader`` decorators give the JAX decorators' streams; the nine
text datasets synthesize the JAX package's bytes; ``InMemoryDataset`` and
``QueueDataset`` parse MultiSlot files into the JAX package's batches, with
the port's native parser (``_native/datafeed.cpp``) and without it; and
``Executor.train_from_dataset`` trains a small CTR program, built alike in
both packages from the JAX startup's weights, to the JAX losses batch for
batch (rel 1e-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu.io as jio  # noqa: E402
import paddle_tpu.reader as jreader  # noqa: E402
import paddle_tpu.static as jstatic  # noqa: E402
import paddle_tpu.text as jtext  # noqa: E402
from paddle_tpu import ops as jops  # noqa: E402

from paddle_tpu_torch import _native, convert, io, ops, reader, static, text  # noqa: E402
from paddle_tpu_torch.io import feed  # noqa: E402

torch.set_num_threads(1)


def _creator(seq):
    def r():
        return iter(seq)
    return r


# -- reader decorators -----------------------------------------------------------


def test_reader_names_are_the_jax_packages():
    assert sorted(reader.__all__) == sorted(jreader.__all__)


def test_cache_map_chain_compose_firstn_buffered():
    calls = {"n": 0}

    def src():
        calls["n"] += 1
        yield from range(5)

    c = reader.cache(src)
    assert list(c()) == list(range(5)) == list(c()) and calls["n"] == 1
    d = {"h": 0, "i": 1}
    assert (list(reader.map_readers(lambda x: d[x], _creator(["h", "i"]))())
            == list(jreader.map_readers(lambda x: d[x], _creator(["h", "i"]))()))
    parts = [_creator([[0, 0]]), _creator([[10, 10]]), _creator([[20, 20]])]
    assert list(reader.chain(*parts)()) == list(jreader.chain(*parts)())
    comp = (_creator([(1, 2), (3, 4)]), _creator([5, 6]))
    assert list(reader.compose(*comp)()) == list(jreader.compose(*comp)())
    with pytest.raises(reader.ComposeNotAligned):
        list(reader.compose(_creator([1, 2, 3]), _creator([1]))())
    assert (list(reader.compose(_creator([1, 2, 3]), _creator([1]), check_alignment=False)())
            == [(1, 1)])
    assert list(reader.firstn(_creator(list(range(100))), 7)()) == list(range(7))
    assert list(reader.buffered(_creator(list(range(50))), size=8)()) == list(range(50))


def test_shuffle_equals_jax_under_one_seed():
    import random

    src = _creator(list(range(40)))
    random.seed(5)
    np.random.seed(5)
    got = list(reader.shuffle(src, buf_size=7)())
    random.seed(5)
    np.random.seed(5)
    assert got == list(jreader.shuffle(src, buf_size=7)())
    assert sorted(got) == list(range(40))


def test_xmap_and_multiprocess_readers():
    src = _creator(list(range(30)))
    un = reader.xmap_readers(lambda x: x * 2, src, process_num=4, buffer_size=8)
    assert sorted(un()) == [2 * i for i in range(30)]
    o = reader.xmap_readers(lambda x: x * 2, src, process_num=4, buffer_size=8, order=True)
    assert list(o()) == list(jreader.xmap_readers(lambda x: x * 2, src, process_num=4,
                                                  buffer_size=8, order=True)())
    r = reader.multiprocess_reader([_creator([1, 2, 3]), _creator([10, 20])])
    assert sorted(r()) == [1, 2, 3, 10, 20]


def test_errors_propagate():
    def flaky():
        yield 1
        raise IOError("disk gone")

    it = reader.buffered(flaky, size=4)()
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="source failed"):
        list(it)
    for order in (False, True):
        r = reader.xmap_readers(lambda s: 1 // s, _creator([1, 1, 0, 1]), process_num=2,
                                buffer_size=4, order=order)
        with pytest.raises(RuntimeError, match="worker failed"):
            list(r())


# -- text datasets ---------------------------------------------------------------------

TEXT_CASES = [
    ("Imdb", dict(mode="train")), ("Imdb", dict(mode="test", cutoff=50, seed=3)),
    ("Imikolov", dict(mode="train", window_size=5)),
    ("Imikolov", dict(mode="test", data_type="SEQ")),
    ("WMT14", dict(mode="train", dict_size=50)), ("WMT14", dict(mode="test", dict_size=50)),
    ("WMT16", dict(mode="train")), ("Conll05st", dict(mode="train")),
    ("Movielens", dict(mode="train")), ("Movielens", dict(mode="test")),
    ("UCIHousing", dict(mode="train")), ("UCIHousing", dict(mode="test")),
    ("Sentiment", dict(mode="train")), ("Sentiment", dict(mode="test", seed=8)),
    ("MQ2007", dict(format="pairwise")), ("MQ2007", dict(format="pointwise")),
    ("MQ2007", dict(format="listwise")),
]


def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,kwargs", TEXT_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(TEXT_CASES)])
def test_text_dataset_bit_equal_to_jax(name, kwargs, monkeypatch, tmp_path):
    from paddle_tpu.text import datasets as jds_mod

    from paddle_tpu_torch.text import datasets as ds_mod

    monkeypatch.setattr(ds_mod, "DATA_HOME", str(tmp_path))
    monkeypatch.setattr(jds_mod, "DATA_HOME", str(tmp_path))
    assert sorted(text.__all__) == sorted(jtext.__all__)
    with pytest.warns(RuntimeWarning):
        ds = getattr(text, name)(**kwargs)
    with pytest.warns(RuntimeWarning):
        jds = getattr(jtext, name)(**kwargs)
    assert ds.synthetic and jds.synthetic and len(ds) == len(jds) > 0
    assert isinstance(ds, io.Dataset)
    for i in sorted({0, 1, len(ds) // 2, len(ds) - 1}):
        _same(ds[i], jds[i])


# -- the MultiSlot file feed ---------------------------------------------------------------


def _write_ctr_files(tmp_path, n_files=2, lines_per_file=8, seed=0):
    """dist_ctr-style MultiSlot files: label (1 int), ids (1-3 sparse ints),
    dense (2 floats)."""
    rng = np.random.RandomState(seed)
    paths = []
    for fi in range(n_files):
        p = tmp_path / f"part-{fi:03d}.txt"
        with open(p, "w") as f:
            for _ in range(lines_per_file):
                label = int(rng.randint(0, 2))
                n_ids = int(rng.randint(1, 4))
                ids = rng.randint(1, 50, n_ids).tolist()
                dense = rng.rand(2).round(3).tolist()
                f.write(f"1 {label} {n_ids} " + " ".join(map(str, ids))
                        + " 2 " + " ".join(map(str, dense)) + "\n")
        paths.append(str(p))
    return paths


@pytest.fixture
def both_static():
    for st in (jstatic, static):
        st.enable_static()
        st.reset_default_programs()
        st.global_scope().clear()
    yield
    for st in (jstatic, static):
        st.disable_static()
        st.reset_default_programs()
        st.global_scope().clear()


def _ctr_vars(st):
    return (st.data("click", [-1, 1], "int64"), st.data("slot_ids", [-1, 3], "int64"),
            st.data("dense_f", [-1, 2], "float32"))


def _dataset(pkg, kind, paths, use_vars, batch=4, thread=2):
    ds = pkg.DatasetFactory().create_dataset(kind)
    ds.set_batch_size(batch)
    ds.set_thread(thread)
    ds.set_filelist(paths)
    ds.set_use_var(use_vars)
    if kind == "InMemoryDataset":
        ds.load_into_memory()
    return ds


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("kind", ["InMemoryDataset", "QueueDataset"])
def test_datasets_parse_as_jax(kind, native, both_static, tmp_path, monkeypatch):
    if native and not _native.datafeed_available():
        pytest.skip("no g++ to build the native parser")
    if not native:
        monkeypatch.setattr(_native, "datafeed_available", lambda: False)
    paths = _write_ctr_files(tmp_path)
    got = list(_dataset(io, kind, paths, list(_ctr_vars(static)), thread=1)._iter_batches())
    want = list(_dataset(jio, kind, paths, list(_ctr_vars(jstatic)), thread=1)._iter_batches())
    assert len(got) == len(want) == 4
    _same(got, want)
    lb, ib, db = got[0]
    assert lb.shape == (4, 1) and ib.shape == (4, 3) and db.shape == (4, 2)


def test_inmemory_multiworker_order_and_shuffles(both_static, tmp_path):
    paths = _write_ctr_files(tmp_path, n_files=3, lines_per_file=6)
    ds = _dataset(io, "InMemoryDataset", paths, list(_ctr_vars(static)), batch=3, thread=3)
    jds = _dataset(jio, "InMemoryDataset", paths, list(_ctr_vars(jstatic)), batch=3, thread=3)
    assert ds.get_memory_data_size() == jds.get_memory_data_size() == 18
    _same(list(ds._iter_batches()), list(jds._iter_batches()))
    for d in (ds, jds):
        d.set_shuffle_seed(7)
        d.local_shuffle()
    _same(list(ds._iter_batches()), list(jds._iter_batches()))
    ds.global_shuffle()
    jds.global_shuffle()
    _same(list(ds._iter_batches()), list(jds._iter_batches()))
    q = _dataset(io, "QueueDataset", paths, list(_ctr_vars(static)))
    with pytest.raises(NotImplementedError):
        q.local_shuffle()
    with pytest.raises(NotImplementedError):
        q.global_shuffle()


def test_malformed_file_raises(both_static, tmp_path):
    p = tmp_path / "bad.txt"
    p.write_text("1 0 2 17\n")  # the ids slot claims 2 values and has 1
    ds = io.InMemoryDataset()
    ds.set_filelist([str(p)])
    ds.set_use_var(list(_ctr_vars(static)))
    with pytest.raises((ValueError, RuntimeError)):
        ds.load_into_memory()


def _ctr_program(st, op_mod):
    label, ids, dense = _ctr_vars(st)
    emb = st.nn.embedding(ids, size=[50, 4])
    feat = op_mod.concat([op_mod.sum(emb, axis=1), dense], axis=1)
    fc = st.nn.fc(feat, size=2)
    loss = op_mod.mean(op_mod.softmax_with_cross_entropy(fc, label))
    st.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return [label, ids, dense], loss


def test_train_from_dataset_gives_the_jax_losses(both_static, tmp_path, capsys):
    paths = _write_ctr_files(tmp_path, n_files=2, lines_per_file=32, seed=3)
    jvars, jloss = _ctr_program(jstatic, jops)
    tvars, tloss = _ctr_program(static, ops)
    jexe, exe = jstatic.Executor(), static.Executor("cpu")
    jexe.run_startup()
    jscope = jstatic.global_scope()
    convert.scope_from_numpy({n: np.asarray(jscope.get(n)) for n in jscope.var_names()},
                             scope=static.global_scope(), device="cpu")
    record = {"jax": [], "port": []}
    for key, ex in (("jax", jexe), ("port", exe)):
        run = ex.run

        def recording(*a, _run=run, _key=key, **kw):
            out = _run(*a, **kw)
            if out:
                record[_key].append(float(np.asarray(out[0])))
            return out

        ex.run = recording
    for epoch in range(3):
        jds = _dataset(jio, "InMemoryDataset", paths, jvars, batch=8, thread=1)
        ds = _dataset(io, "InMemoryDataset", paths, tvars, batch=8, thread=1)
        assert jexe.train_from_dataset(jstatic.default_main_program(), jds,
                                       fetch_list=[jloss], print_period=4) == 8
        assert exe.train_from_dataset(static.default_main_program(), ds,
                                      fetch_list=[tloss], print_period=4) == 8
    assert len(record["port"]) == len(record["jax"]) == 24
    np.testing.assert_allclose(record["port"], record["jax"], rtol=1e-5)
    assert record["port"][-1] != record["port"][0]
    assert "[train_from_dataset] batch 4" in capsys.readouterr().out
    ds = _dataset(io, "QueueDataset", paths, tvars, batch=8, thread=2)
    assert exe.infer_from_dataset(static.default_main_program(), ds) == 8


def test_device_batches_land_on_the_executors_device(both_static, tmp_path):
    paths = _write_ctr_files(tmp_path)
    ds = _dataset(io, "QueueDataset", paths, list(_ctr_vars(static)))
    batches = list(ds._iter_device_batches(device="cpu"))
    assert len(batches) == 4
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for b in batches for t in b)
    assert feed.DatasetBase is io.DatasetBase
