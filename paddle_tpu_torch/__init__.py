"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

A package beside ``paddle_tpu`` that imports ``torch`` and never JAX or
``paddle_tpu``. This slice serves BERT: ``models.BertModel`` behind
``inference.Predictor`` and ``serving.InferenceServer``, with hand-written
CUDA kernels (``ops/cuda``, sources in ``csrc/``) for flash attention and
the fused residual-add + LayerNorm. Entry points run on the CUDA card
unless the caller passes ``device="cpu"``.
"""
from .flags import flag, set_flags  # noqa: F401
from .framework import load  # noqa: F401
