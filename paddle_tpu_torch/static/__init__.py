"""Static graph mode of the port (``paddle_tpu/static/``): the Program IR,
the layer helpers that build a program, autodiff that appends a program's
gradient ops (``append_backward``, ``gradients``), the static optimizers
(SGD, Momentum, Adam), an interpreter that runs it, captured once a
signature on the card, and the inference-model files. Enough to build,
train, calibrate, quantize, save and serve a feed-forward program; control
flow (``while``, ``cond``, ``scan``) is not ported."""
from . import io, nn, optimizer  # noqa: F401
from .backward import append_backward, gradients  # noqa: F401
from .executor import Executor, Scope, global_scope  # noqa: F401
from .io import load_inference_model, save_inference_model  # noqa: F401
from .program import (  # noqa: F401
    Block,
    OpDesc,
    Program,
    VarDesc,
    Variable,
    data,
    default_main_program,
    default_startup_program,
    disable_static,
    enable_static,
    in_static_mode,
    program_guard,
    reset_default_programs,
)
