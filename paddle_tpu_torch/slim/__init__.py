"""Model compression of the port (``paddle_tpu/slim/``): post-training
quantization of static programs. Quantization-aware training is not ported."""
from .ptq import (  # noqa: F401
    QUANT_METADATA_FILENAME,
    PostTrainingQuantization,
    load_quant_metadata,
    quantize_static_program,
    rewrite_int8_program,
)
