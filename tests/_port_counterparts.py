"""Run a JAX test of ``tests/`` against the port: the same body, inputs and
assertions, with the JAX package's modules in its namespace swapped for the
port's.

:func:`namespace` copies a JAX test module's globals, replaces the named
modules and re-creates every function the module defines over the copy, so
its helpers (a fake clock's ledger, a trace writer) reach the port too.
:func:`call` runs one test function of such a namespace, its arguments
taken from ``local`` (fixtures the JAX module defines, re-made here) or
from pytest's own fixtures (``tmp_path``, ``monkeypatch``, ``capsys``).
"""
import importlib.util
import inspect
import os
import types

_HERE = os.path.dirname(os.path.abspath(__file__))
_loaded = {}


def jax_tests(name):
    """The module ``tests/<name>.py``, imported once under a private name."""
    mod = _loaded.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(f"_jax_{name}",
                                                      os.path.join(_HERE, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[name] = mod
    return mod


def namespace(module, **names):
    """``module``'s globals with ``names`` replaced, its functions re-made
    over the copy (the original module is untouched)."""
    g = dict(vars(module))
    g.update(names)
    for key, v in list(g.items()):
        if isinstance(v, types.FunctionType) and v.__module__ == module.__name__:
            fn = getattr(v, "__wrapped__", v)
            g[key] = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__,
                                        fn.__closure__)
    return g


def call(g, test_name, request, local=None):
    """Run ``g[test_name]``: each argument from ``local`` (name -> a callable
    taking ``get``, which resolves another argument by name) or pytest's
    fixture of that name. A generator in ``local`` is a fixture with
    teardown: it runs past its yield when the test ends."""
    local = local or {}
    fn = g[test_name]
    made, finalizers = {}, []

    def get(arg):
        if arg not in made:
            if arg in local:
                val = local[arg](get)
                if isinstance(val, types.GeneratorType):
                    finalizers.append(val)
                    val = next(val)
                made[arg] = val
            else:
                made[arg] = request.getfixturevalue(arg)
        return made[arg]

    try:
        return fn(**{arg: get(arg) for arg in inspect.signature(fn).parameters})
    finally:
        for gen in reversed(finalizers):
            next(gen, None)
