"""Framework pieces of the port: the ``Tensor`` and the places
(:mod:`.tensor`, :mod:`.place`), dtypes, gradient switches, reading
``paddle_tpu.save`` files, the random state, and the training step."""
from . import jit, random  # noqa: F401
from .random import seed  # noqa: F401
from .serialization import load, save  # noqa: F401
