"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

A package beside ``paddle_tpu`` that imports ``torch`` and never JAX or
``paddle_tpu``. A Paddle-style script runs on it as ``import
paddle_tpu_torch as paddle``: ``paddle.to_tensor``, the ``Tensor`` (a
``torch.Tensor`` subclass with Paddle's members), the places and
``set_device``, the tensor functions at the top level and in ``tensor``
and ``linalg``, ``nn.Layer`` (a ``torch.nn.Module``) with the rest of
``nn``, the optimizers, and ``jit.to_static``/``jit.save``/``jit.load``.
Entry points run on the CUDA card unless the caller asks for the CPU
(``set_device("cpu")``, or ``device="cpu"`` where a function takes one);
without a card they raise.

Underneath, it serves BERT (``models.BertModel`` behind
``inference.Predictor`` and ``serving.InferenceServer``) and trains it
(``framework.jit.train_step`` with ``optimizer.AdamW``), with hand-written
CUDA kernels (``ops/cuda``, sources in ``csrc/``) for flash attention and
the fused residual-add + LayerNorm, forward and backward; serves and
trains ResNet (fused conv + batch norm + relu, momentum and max-pool
backward kernels); serves saved static programs, float or post-training
quantized to int8 (``static``, ``slim``, ``inference.create_predictor``;
the int8 matmul kernel); trains under ``amp`` (``auto_cast`` O1 and O2,
bf16, ``GradScaler``, ``decorate``); trains static programs
(``static.append_backward``, ``static.optimizer``); and generates text
(``generation``, ``serving``).
"""
__version__ = "0.1.0"  # the JAX package's

from . import amp  # noqa: F401
from .flags import flag, get_flags, set_flags  # noqa: F401
from .framework import load, save, seed  # noqa: F401
from .framework.autograd import enable_grad, grad, is_grad_enabled, no_grad  # noqa: F401
from .framework.dtype import (  # noqa: F401
    bfloat16,
    bool_,
    complex64,
    complex128,
    float16,
    float32,
    float64,
    get_default_dtype,
    int8,
    int16,
    int32,
    int64,
    set_default_dtype,
    uint8,
)
from .framework.place import (  # noqa: F401
    CPUPlace,
    CUDAPlace,
    Place,
    TPUPlace,
    get_device,
    is_compiled_with_tpu,
    set_device,
)
from .framework.tensor import Parameter, Tensor, to_tensor  # noqa: F401
from . import ops  # noqa: F401
from .ops import (  # noqa: F401
    abs,
    accuracy,
    acos,
    add,
    addmm,
    all,
    any,
    arange,
    argmax,
    argmin,
    argsort,
    asin,
    atan,
    atan2,
    bernoulli,
    bitwise_and,
    bitwise_not,
    bitwise_or,
    bitwise_xor,
    bmm,
    broadcast_to,
    cast,
    ceil,
    chunk,
    clip,
    clone,
    concat,
    cos,
    cosh,
    cross,
    cumprod,
    cumsum,
    diag,
    diag_embed,
    diagflat,
    dist,
    divide,
    dot,
    einsum,
    empty,
    empty_like,
    equal,
    erf,
    exp,
    expand,
    expand_as,
    expm1,
    eye,
    flatten,
    flip,
    floor,
    floor_divide,
    full,
    full_like,
    gather,
    gather_nd,
    greater_equal,
    greater_than,
    increment,
    index_sample,
    index_select,
    inner,
    inverse,
    is_complex,
    is_integer,
    isfinite,
    isinf,
    isnan,
    kthvalue,
    less_equal,
    less_than,
    linspace,
    log,
    log1p,
    log2,
    log10,
    logical_and,
    logical_not,
    logical_or,
    logical_xor,
    logsumexp,
    masked_select,
    matmul,
    max,
    maximum,
    mean,
    meshgrid,
    min,
    minimum,
    mod,
    multinomial,
    multiplex,
    multiply,
    mv,
    neg,
    normal,
    not_equal,
    numel,
    ones,
    ones_like,
    outer,
    poisson,
    pow,
    prod,
    put_along_axis,
    rand,
    randint,
    randn,
    randperm,
    rank,
    reciprocal,
    remainder,
    repeat_interleave,
    reshape,
    roll,
    round,
    rsqrt,
    scale,
    scatter,
    scatter_nd_add,
    shape,
    shard_index,
    sigmoid,
    sign,
    sin,
    sinh,
    slice,
    sort,
    split,
    sqrt,
    square,
    squeeze,
    stack,
    standard_normal,
    stanh,
    strided_slice,
    subtract,
    sum,
    t,
    take_along_axis,
    tan,
    tanh,
    tile,
    topk,
    transpose,
    tril,
    triu,
    trunc,
    unbind,
    uniform,
    unsqueeze,
    unstack,
    where,
    zeros,
    zeros_like,
)
from . import device, inference, linalg, models, nn, optimizer, static, tensor  # noqa: F401,E402
from . import jit_api as jit  # noqa: F401,E402
from . import incubate, io, metric, reader, text, vision  # noqa: F401,E402
from .hapi import Model  # noqa: F401,E402
from .hapi.model import summary  # noqa: F401,E402
from . import distributed, parallel  # noqa: F401,E402
from . import distribution, errors, utils  # noqa: F401,E402
from .distributed import DataParallel  # noqa: F401,E402
