"""Online serving of the port: batcher, replica pool, HTTP server."""
from .batcher import (  # noqa: F401
    DeadlineExceededError,
    DynamicBatcher,
    QueueFullError,
    ServingClosedError,
    parse_buckets,
)
from .replica import ReplicaPool, predictor_input_specs  # noqa: F401
from .server import InferenceServer  # noqa: F401
