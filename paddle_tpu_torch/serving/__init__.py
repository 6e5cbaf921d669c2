"""Online serving of the port: batcher, replica pool, HTTP servers, and continuous
batching of generation."""
from .batcher import (  # noqa: F401
    DeadlineExceededError,
    DynamicBatcher,
    QueueFullError,
    ServingClosedError,
    parse_buckets,
)
from .continuous import ContinuousBatcher, GenerationRequest  # noqa: F401
from .replica import ReplicaPool, predictor_input_specs  # noqa: F401
from .server import GenerationServer, InferenceServer  # noqa: F401
