"""Global FLAGS registry (env-driven runtime configuration), the port's own copy.

Counterpart of ``paddle_tpu/flags.py`` for the flags the port's paths
read: the same names, defaults and ``FLAGS_<name>`` environment
overrides (read when the flag is defined, gflags' init semantics).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

from .errors import InvalidArgumentError, NotFoundError

__all__ = ["define_flag", "set_flags", "flag"]


@dataclass
class _Flag:
    name: str
    value: object
    type: type
    help: str


_REGISTRY: dict[str, _Flag] = {}


def _coerce(value, typ):
    if typ is bool and isinstance(value, str):
        return value.strip().lower() in ("1", "true", "yes", "on")
    return typ(value)


def define_flag(name: str, default, help: str = ""):
    """Register a flag; ``FLAGS_<name>`` in the environment overrides the
    default."""
    typ = type(default)
    env = os.environ.get(f"FLAGS_{name}")
    value = default if env is None else _coerce(env, typ)
    _REGISTRY[name] = _Flag(name, value, typ, help)
    return value


def flag(name: str):
    """Current value of a flag."""
    try:
        return _REGISTRY[name].value
    except KeyError:
        raise NotFoundError(f"unknown flag {name!r}; known: {sorted(_REGISTRY)}") from None


def set_flags(flags_map: dict):
    """Update flag values with type checking."""
    for name, value in flags_map.items():
        f = _REGISTRY.get(name)
        if f is None:
            raise NotFoundError(f"unknown flag {name!r}; known: {sorted(_REGISTRY)}")
        try:
            f.value = _coerce(value, f.type)
        except (TypeError, ValueError) as e:
            raise InvalidArgumentError(
                f"flag {name!r} expects {f.type.__name__}, got {value!r}") from e


# nn/transformer.py _residual_norm — the post-norm residual-add + LayerNorm
# pair goes through the fused kernel (ops/cuda/layernorm_residual.py);
# off, the block computes norm(residual + y) op by op.
define_flag("use_fused_layernorm", True,
            "fused residual-add + LayerNorm kernel in post-norm blocks")

# nn/layers.py fused_conv_bn_relu — admitted conv -> batch_norm -> relu
# triples go through the fused kernels (ops/cuda/conv_bn_relu.py); off,
# the triple runs as conv2d, batch_norm and relu op by op.
define_flag("use_fused_conv_bn", True,
            "fused conv + batch_norm + relu kernels for admitted triples")

# optimizer Momentum — the update (with L2 decay folded in) goes through the
# fused in-place kernel (ops/cuda/optimizer_update.py); off, the same
# expression op by op.
define_flag("use_fused_optimizer", True,
            "fused in-place momentum / weight-decay update kernel")

# nn/functional.py max_pool2d — in training, admitted max pools take their
# backward from the hand-written kernel (ops/cuda/pool_backward.py) instead
# of torch's own; the gradient is the same first-max subgradient.
define_flag("use_pallas_pool_bwd", False,
            "hand-written max-pool backward kernel (the name is the JAX "
            "package's, whose kernel is Pallas)")

# ops/quantize_kernels.py mul_int8 / matmul_int8 — the int8 product goes
# through the hand-written int8 kernel (ops/cuda/int8_matmul.py). The flag
# chooses between exact routes and never changes a number; the card has no
# second exact integer route, so off raises there.
define_flag("use_int8_matmul", True,
            "hand-written int8 x int8 -> int32 matmul kernel for "
            "mul_int8 / matmul_int8")

# runtime/compiled.py GraphStore — the bound of every store of captured
# CUDA graphs (framework/jit.py train_step and eval_step), read at insert
# time so set_flags applies to live stores; evictions are counted per store.
define_flag("compiled_cache_capacity", 128,
            "LRU bound of every store of captured steps (train step / eval "
            "step); evictions counted per store")

# serving/batcher.py — the batch-axis bucket ladder: every assembled batch
# is padded up to the smallest bucket that covers its rows.
define_flag("serving_batch_buckets", "1,2,4,8",
            "comma-separated ascending batch-axis bucket sizes for the "
            "online serving batcher")

# serving/batcher.py — bounded admission queue; full rejects (HTTP 429).
define_flag("serving_queue_capacity", 256,
            "max requests the serving batcher holds before rejecting "
            "(backpressure: HTTP 429)")

# serving/batcher.py — how long an open batch waits for more requests.
define_flag("serving_batch_timeout_ms", 2.0,
            "max ms the serving batcher waits to fill a batch beyond "
            "its first request (0: dispatch immediately)")

# serving/replica.py — worker threads in the replica pool.
define_flag("serving_replicas", 1,
            "replica worker threads serving the online batcher")

# serving/batcher.py — default per-request deadline (0: none).
define_flag("serving_default_deadline_ms", 0.0,
            "default per-request serving deadline in ms (0: none); "
            "expired requests error without dispatch")

# framework/jit.py TrainStepFn + static/executor.py Executor.run — the train
# step runs a checked variant whose every op's output is tested for NaN
# (framework/nan_inf.py), and the executor scans what a run fetched and
# wrote for NaN/Inf, each naming what made the first bad value.
define_flag("check_nan_inf", False,
            "scan step outputs for NaN/Inf and name the producing op")

# framework/nan_inf.py — what a NaN/Inf found under check_nan_inf does.
define_flag("check_nan_inf_action", "raise",
            "on NaN/Inf detection: raise | warn (count+log, continue) | "
            "dump (flight-recorder snapshot, then raise)")

# distributed/checkpoint.py save — the serialize + fsync + publish of a
# snapshot runs on a background writer thread.
define_flag("checkpoint_async", True,
            "serialize + fsync checkpoints in a background thread "
            "(off the training step critical path)")

# generation/engine.py — capacity (tokens) of the ring KV cache of each
# decode slot; past it the ring overwrites the oldest token (sliding-window
# attention of this width, which the model computes when its
# attention_window is the same).
define_flag("generation_kv_cache_len", 256,
            "per-slot ring KV cache capacity (tokens) for autoregressive "
            "decoding; also the sliding attention window width")

# generation/engine.py — storage dtype of the ring KV cache. The port keeps
# float32; int8 (QuantizedStaticCache) raises UnimplementedError.
define_flag("generation_kv_cache_dtype", "float32",
            "KV cache storage dtype for decoding: float32 | int8 "
            "(int8: per-head dynamic scales, ~4x fewer cache bytes)")

# generation/engine.py — physical layout of the decode KV store. The port
# keeps the per-slot ring; paged raises UnimplementedError.
define_flag("kv_cache_layout", "ring",
            "decode KV cache layout: ring (per-slot contiguous) | paged "
            "(shared page pool + per-slot page tables with copy-on-write "
            "prefix reuse)")

# generation/engine.py — the prompt-length bucket ladder of prefill: a
# prompt pads up to the smallest covering bucket, one captured graph each.
define_flag("generation_prefill_buckets", "16,32,64,128",
            "comma-separated ascending prompt-length buckets for "
            "generation prefill; each bucket is one compiled shape")

# generation/engine.py + serving/continuous.py — decode slots of the one
# decode graph; a finished sequence vacates its slot mid-batch.
define_flag("generation_decode_slots", 4,
            "decode slots co-batched in the compiled generation step "
            "(continuous batching admits into vacant slots mid-batch)")

# generation/engine.py — default generation budget of a request.
define_flag("generation_max_new_tokens", 64,
            "default max tokens generated per request (requests may "
            "override below the model's position limit)")

# generation/engine.py — default sampling temperature; 0 = greedy. A
# request's temperature is a device input of the graphs.
define_flag("generation_temperature", 0.0,
            "default sampling temperature (0: greedy argmax); "
            "per-request override is compile-free")

# generation/engine.py — top-k filter width (0: off); engine-wide, as it
# shapes the captured graphs.
define_flag("generation_top_k", 0,
            "top-k sampling filter for generation (0: full distribution); "
            "engine-level — changing it recompiles the decode step")

# serving/continuous.py — bounded admission queue of generation requests
# (full: QueueFullError, HTTP 429).
define_flag("generation_queue_capacity", 128,
            "max generation requests queued for decode slots before "
            "rejecting (backpressure: HTTP 429)")

# generation/engine.py check_memory_budget — the engine's weights and KV
# cache against the card's memory (torch.cuda.mem_get_info) at
# construction: off | warn | strict.
define_flag("memory_budget_check", "warn",
            "static peak-HBM admission before compile: off | warn | "
            "strict (strict rejects over-budget programs and unsafe "
            "donations with the high-water op named)")

# serving/server.py GenerationServer — the backend's role. The port serves
# generate; prefill and decode (the disaggregated tiers) raise
# UnimplementedError.
define_flag("backend_kind", "generate",
            "generation backend role: generate | prefill | decode "
            "(disaggregated fleets run distinct prefill/decode tiers)")
