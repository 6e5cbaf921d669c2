"""Layers of the port (``paddle_tpu.nn``)."""
from . import functional, initializer  # noqa: F401
from .layers import (  # noqa: F401
    AdaptiveAvgPool2D,
    BatchNorm2D,
    Conv2D,
    Dropout,
    Embedding,
    Flatten,
    LayerList,
    LayerNorm,
    Linear,
    MaxPool2D,
    Sequential,
    fused_conv_bn_relu,
)
from .transformer import (  # noqa: F401
    MultiHeadAttention,
    Transformer,
    TransformerDecoder,
    TransformerDecoderLayer,
    TransformerEncoder,
    TransformerEncoderLayer,
)
