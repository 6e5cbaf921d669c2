"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

A package beside ``paddle_tpu`` that imports ``torch`` and never JAX or
``paddle_tpu``. It serves BERT (``models.BertModel`` behind
``inference.Predictor`` and ``serving.InferenceServer``) and trains it
(``models.BertForPretraining`` through ``framework.jit.train_step`` with
``optimizer.AdamW``), with hand-written CUDA kernels (``ops/cuda``,
sources in ``csrc/``) for flash attention and the fused residual-add +
LayerNorm, forward and backward. Entry points run on the CUDA card unless
the caller passes ``device="cpu"``.
"""
from .flags import flag, set_flags  # noqa: F401
from .framework import load, seed  # noqa: F401
