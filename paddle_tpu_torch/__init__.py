"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

A package beside ``paddle_tpu`` that imports ``torch`` and never JAX or
``paddle_tpu``. It serves BERT (``models.BertModel`` behind
``inference.Predictor`` and ``serving.InferenceServer``) and trains it
(``models.BertForPretraining`` through ``framework.jit.train_step`` with
``optimizer.AdamW``), with hand-written CUDA kernels (``ops/cuda``,
sources in ``csrc/``) for flash attention and the fused residual-add +
LayerNorm, forward and backward. It serves and trains ResNet (fused conv +
batch norm + relu, momentum and max-pool backward kernels) and serves saved
static programs, float or post-training-quantized to int8 (``static``,
``slim``, ``inference.create_predictor``; the int8 matmul kernel). ``amp``
is the JAX package's mixed precision: ``auto_cast`` (O1 and O2, bf16),
``GradScaler`` and ``decorate``; under it BERT trains through the bf16
attention and LayerNorm kernels. Static programs train too
(``static.append_backward``, ``static.optimizer``: the MNIST LeNet through
the max-pool backward kernel), and dygraph steps take SGD, the lr
schedules and the gradient clips. Entry points run on the CUDA card unless
the caller passes ``device="cpu"``.
"""
from . import amp  # noqa: F401
from .flags import flag, set_flags  # noqa: F401
from .framework import load, save, seed  # noqa: F401
