"""Static graph mode of the port (``paddle_tpu/static/``): the Program IR,
the layer helpers that build a program, autodiff that appends a program's
gradient ops (``append_backward``, ``gradients``), the static optimizers
(SGD, Momentum, Adam), an interpreter that runs it, captured once a
signature on the card, control flow over nested blocks (``while_loop``,
``cond``, ``scan``, ``case``, ``switch_case``) with the recurrent layers
built on ``scan``, random ops in programs, and the model and checkpoint
files (``save``/``load``, ``save_persistables``/``load_persistables``,
the inference model). Enough to build, train, checkpoint, calibrate,
quantize, save and serve a program with loops, branches and recurrent
layers. A program holding an unbounded ``while`` runs uncaptured on the
card (``Executor.store.uncaptured`` counts such runs). ``InputSpec`` (the
class ``jit`` declares inputs with) and ``ExponentialMovingAverage`` (the
optimizer wrapper, whose dygraph state works for a program's parameters
pulled out of the scope) are exported here as in ``paddle.static``."""
from . import io, nn, optimizer  # noqa: F401
from .backward import append_backward, gradients  # noqa: F401
from .control_flow import case, cond, scan, switch_case, while_loop  # noqa: F401
from ..jit_api import InputSpec  # noqa: F401
from ..optimizer.wrappers import ExponentialMovingAverage  # noqa: F401
from .executor import Executor, Scope, global_scope  # noqa: F401
from .io import (  # noqa: F401
    load,
    load_inference_model,
    load_persistables,
    save,
    save_inference_model,
    save_persistables,
)
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
    in_dynamic_mode,
    in_static_mode,
    program_guard,
    reset_default_programs,
)
