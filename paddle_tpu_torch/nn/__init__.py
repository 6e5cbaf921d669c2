"""Layers of the port (``paddle_tpu.nn``)."""
from . import functional  # noqa: F401
from .layers import Dropout, Embedding, LayerList, LayerNorm, Linear  # noqa: F401
from .transformer import (  # noqa: F401
    MultiHeadAttention,
    TransformerEncoder,
    TransformerEncoderLayer,
)
