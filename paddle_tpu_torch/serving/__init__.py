"""Online serving of the port: batcher, replica pool, HTTP servers, continuous
batching of generation, and the fleet's router and backend processes
(``python -m paddle_tpu_torch.serving.backend``,
``python -m paddle_tpu_torch.serving.router``)."""
import atexit
import weakref

from .batcher import (  # noqa: F401
    DeadlineExceededError,
    DynamicBatcher,
    QueueFullError,
    ServingClosedError,
    parse_buckets,
)
from .continuous import ContinuousBatcher, GenerationRequest  # noqa: F401
from .replica import ReplicaPool, predictor_input_specs  # noqa: F401
from .router import (  # noqa: F401
    BackendState,
    BackendTimeoutError,
    BackendUnavailableError,
    NoBackendError,
    Router,
)
from .server import LOADZ_SCHEMA_VERSION, GenerationServer, InferenceServer  # noqa: F401

__all__ = [
    "DynamicBatcher", "ReplicaPool", "InferenceServer", "ContinuousBatcher",
    "GenerationRequest", "GenerationServer", "LOADZ_SCHEMA_VERSION",
    "Router", "BackendState", "NoBackendError", "BackendUnavailableError",
    "BackendTimeoutError", "QueueFullError", "DeadlineExceededError",
    "ServingClosedError", "parse_buckets", "predictor_input_specs", "shutdown_all",
]

# every live server and router registers here, so one call stops them all
_live = weakref.WeakSet()


def _register_live(obj):
    _live.add(obj)


def shutdown_all():
    """Stop every live router, then every server (which drain their own
    pools and schedulers). Idempotent; exceptions are swallowed: this is the
    exit and test-teardown path, where a half-built object must not mask
    the real failure."""
    objs = list(_live)
    for cls in (Router, InferenceServer, GenerationServer):
        for obj in objs:
            if type(obj) is cls:
                try:
                    obj.stop(drain=False, timeout=2.0)
                except Exception:  # noqa: BLE001
                    pass


# a worker parked in a CUDA call while the interpreter tears down can abort
# the process: stop the subsystem before Python starts dying
atexit.register(shutdown_all)
