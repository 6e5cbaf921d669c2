"""Runtime pieces of the port: the store of captured steps (``compiled``),
counterpart of ``paddle_tpu/runtime``. The JAX package's names are
exported here: ``CompiledStore`` (a ``GraphStore`` under the JAX constructor),
``CompiledEntry`` (a ``CapturedStep``), ``CompileWatch``, ``any_deleted``
and ``cache_capacity``."""
from . import compiled  # noqa: F401
from .compiled import (  # noqa: F401
    CompiledEntry,
    CompiledStore,
    CompileWatch,
    any_deleted,
    cache_capacity,
)

__all__ = ["CompiledEntry", "CompiledStore", "CompileWatch", "any_deleted", "cache_capacity"]
