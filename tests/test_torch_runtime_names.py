"""The JAX package's runtime names in the port (``paddle_tpu_torch.runtime``):
``CompiledStore`` is the port's store of graphs behind the JAX constructor,
``CompiledEntry`` a captured step behind the JAX one, and ``any_deleted``
answers as the JAX function does for a live and a released buffer. The
pinned signatures are held by ``tests/test_torch_api_signatures.py``."""
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu import runtime as jax_runtime
from paddle_tpu_torch import runtime
from paddle_tpu_torch.flags import flag
from paddle_tpu_torch.profiler import counters
from paddle_tpu_torch.runtime.compiled import CapturedStep, GraphStore


def test_any_deleted_answers_as_the_jax_function():
    a, t = jnp.ones(3), torch.ones(3)
    assert runtime.any_deleted([t, "not a tensor"]) is jax_runtime.any_deleted([a]) is False
    a.delete()
    t.untyped_storage().resize_(0)  # the storage released, the 3 elements kept
    assert runtime.any_deleted([t]) is jax_runtime.any_deleted([a]) is True
    # an empty tensor owns no bytes and has released nothing
    assert runtime.any_deleted([torch.empty(0), torch.empty(3, device="meta")]) is False


def test_cache_capacity_is_the_flag():
    assert runtime.cache_capacity() == max(1, int(flag("compiled_cache_capacity")))


def test_compiled_store_is_the_graph_store_with_the_jax_arguments():
    assert issubclass(runtime.CompiledStore, GraphStore)
    store = runtime.CompiledStore("probe_rt", cost_label="probe_cost", capacity=1,
                                  hit_counter="probe_rt::hit", miss_counter="probe_rt::miss")
    assert store.cost_label == "probe_cost" and store.capacity == 1
    before = counters().get("probe_rt::miss", 0)
    assert store.lookup(("a",)) is None
    assert counters()["probe_rt::miss"] == before + 1 and store.misses == 1
    for sig in (("a",), ("b",)):
        store._insert(runtime.CompiledEntry(sig, store.key_of(sig), None, {"m": 1}))
    assert list(store.entries()) == [("b",)] and store.evictions == 1  # capacity 1
    entry = store.lookup(("b",))
    assert counters()["probe_rt::hit"] >= 1 and store.hits == 1
    assert isinstance(entry, CapturedStep)
    assert (entry.meta, entry.refresh_gen, entry.cache_key) == ({"m": 1}, 0,
                                                                store.key_of(("b",)))
    # the port's own stores keep the flag's bound and the graph counters
    plain = GraphStore("probe_plain")
    assert plain._capacity() == runtime.cache_capacity()
    assert (plain.hit_counter, plain.miss_counter) == ("graph::cache_hit", "graph::cache_miss")


def test_run_eager_books_its_record_under_the_cost_label():
    from paddle_tpu_torch.monitor import cost_model

    store = runtime.CompiledStore("probe_eager", cost_label="probe_eager_cost")
    out = store.run_eager(("s",), lambda: torch.ones(2) * 2)
    assert torch.equal(out, torch.full((2,), 2.0))
    assert cost_model.latest_record("probe_eager_cost") is not None


@pytest.mark.parametrize("name", ["CompiledStore", "CompiledEntry", "CompileWatch",
                                  "any_deleted", "cache_capacity"])
def test_every_jax_runtime_name_is_exported(name):
    assert name in runtime.__all__ and name in jax_runtime.__all__
    assert getattr(runtime, name) is getattr(runtime.compiled, name)
