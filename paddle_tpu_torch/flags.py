"""Global FLAGS registry (env-driven runtime configuration), the port's own copy.

Counterpart of ``paddle_tpu/flags.py`` for the flags the port's paths
read: the same names, defaults and ``FLAGS_<name>`` environment
overrides (read when the flag is defined, gflags' init semantics).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

from .errors import InvalidArgumentError, NotFoundError

__all__ = ["define_flag", "set_flags", "get_flags", "flag", "globals_view"]


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


def get_flags(names):
    """``{name: value}`` of a flag name or a list of them."""
    return {n: flag(n) for n in ([names] if isinstance(names, str) else names)}


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
        # a flag flip is a breadcrumb a post-mortem needs
        from .monitor import flight_recorder as _flight

        _flight.record_event("flag_change", flag=name, value=repr(f.value))


def globals_view() -> dict:
    """Every flag's current value."""
    return {n: f.value for n, f in _REGISTRY.items()}


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

# incubate/auto_checkpoint.py — minimum seconds between periodic snapshots;
# negative defers to the PADDLE_EDL_SAVE_CHECKPOINT_INTER env.
define_flag("checkpoint_save_inter_s", -1.0,
            "min seconds between auto-checkpoint snapshots "
            "(< 0: use PADDLE_EDL_SAVE_CHECKPOINT_INTER env)")

# incubate/auto_checkpoint.py — the newest N intact snapshots are kept.
define_flag("checkpoint_keep", 2,
            "intact snapshots kept by checkpoint rotation")

# distributed/chaos.py — ';'-separated `action:key=val,...` directives
# (kill|exit|delay|raise at step|mid_save); empty disables.
define_flag("fault_injection", "",
            "chaos directives: 'action:k=v,...;...' with actions "
            "kill|exit|delay|raise at points step|mid_save (empty: off)")

# io/dataloader.py _DevicePrefetcher — a background thread fetches the next
# batches and enqueues their copies to the card while the step runs; off,
# the consumer's __next__ refills inline.
define_flag("io_prefetch_overlap", True,
            "overlap dataloader H2D transfers with compute via a "
            "background prefetch thread (double-buffered)")

# generation/engine.py — capacity (tokens) of the ring KV cache of each
# decode slot; past it the ring overwrites the oldest token (sliding-window
# attention of this width, which the model computes when its
# attention_window is the same).
define_flag("generation_kv_cache_len", 256,
            "per-slot ring KV cache capacity (tokens) for autoregressive "
            "decoding; also the sliding attention window width")

# generation/engine.py + nn/transformer.py QuantizedStaticCache — storage
# dtype of the KV cache. int8 stores K/V as int8 with one dynamic abs-max
# scale per head vector (quantized on the cache write, dequantized in the
# attention read): (D + 4) / (4 D) of the float32 bytes, 3.76x fewer at
# head_dim 64.
define_flag("generation_kv_cache_dtype", "float32",
            "KV cache storage dtype for decoding: float32 | int8 "
            "(int8: per-head dynamic scales, ~4x fewer cache bytes)")

# generation/paging.py + nn/transformer.py PagedStaticCache — physical
# layout of the decode KV store: ring (each slot its own window) or paged
# (the same logical ring in fixed-size pages from one shared pool through
# per-slot page tables, with copy-on-write prefix sharing across requests).
# Greedy tokens are the same in both layouts.
define_flag("kv_cache_layout", "ring",
            "decode KV cache layout: ring (per-slot contiguous) | paged "
            "(shared page pool + per-slot page tables with copy-on-write "
            "prefix reuse)")

# generation/paging.py — tokens per KV page under the paged layout. Smaller
# pages share more (a prefix must fill a whole page to be reused) but widen
# the page tables; must divide generation_kv_cache_len.
define_flag("generation_kv_page_size", 16,
            "tokens per KV page under kv_cache_layout=paged; must "
            "divide generation_kv_cache_len evenly")

# generation/paging.py — usable pages in the shared pool (the trash page
# comes on top). 0 sizes it at slots x pages_per_slot, the ring's worst
# case; fewer pages bank on shared prefixes and short sequences.
define_flag("generation_kv_pool_pages", 0,
            "physical KV pages in the paged pool (0: slots x "
            "pages_per_slot, the no-overcommit default)")

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

# static/executor.py Executor.run + analysis/verifier.py — verify the
# program IR before it runs or is captured, raising a VerifyError naming the
# offending op index/type/var instead of failing wherever torch fails.
# Values: off | on | strict ("strict" promotes dead-code findings to
# errors). The verdict is cached per program version.
define_flag("program_verify", "on",
            "verify program IR before lowering: off | on | strict "
            "(strict also fails on dead ops/vars)")

# static/executor.py + analysis/memory.py — static peak-memory admission:
# before a program runs or is captured, plan its liveness footprint
# (analysis.plan_memory) and compare the predicted peak against the card's
# memory (torch.cuda.mem_get_info; FLAGS_device_peaks hbm_bytes= overrides
# it). "strict" rejects over-budget programs (MemoryBudgetError naming the
# high-water op and top tensors) and unsafe donations (DonationError);
# "warn" warns and admits. generation/engine.py applies the same budget to
# its weights and KV cache at construction.
define_flag("memory_budget_check", "warn",
            "static peak-HBM admission before compile: off | warn | "
            "strict (strict rejects over-budget programs and unsafe "
            "donations with the high-water op named)")

# static/executor.py Executor.run + inference/predictor.py +
# analysis/optimizer.py — the program-IR optimizer gate, run after the
# verify gate and before the memory gate. 0: off (programs run exactly as
# built). 1: fusion rewrites onto the fused registry ops
# (conv2d->batch_norm->relu onto fused_conv_bn_relu, residual-add->layer_norm
# onto fused_layernorm_residual, dequantized-int8 matmul/mul chains onto
# matmul_int8/mul_int8) plus side-effect-safe dead-op elimination. 2: level 1
# plus rematerialization when the memory plan is over the budget. The
# optimized clone caches per program version.
define_flag("ir_opt_level", 1,
            "program-IR optimizer level: 0 off, 1 fusion+DCE, "
            "2 +rematerialization under memory pressure")

# analysis/memory.py hbm_budget_bytes — 'hbm_bytes=<B>' overrides the card's
# memory as the budget of the memory gate, the remat pass and the generation
# engine; the JAX flag's other keys (flops, hbm_bw, ici_bw) are ignored: the
# port has no utilization accounting yet.
define_flag("device_peaks", "",
            "override device peak throughputs for utilization accounting:"
            " 'flops=<FLOP/s>,hbm_bw=<B/s>,ici_bw=<B/s>' (any subset)")

# serving/backend.py — speculative decoding for a backend process. With a
# draft model (the engine's draft_model=), every decode round runs the draft
# chain and ONE target verify over draft_k + 1 positions instead of one
# target step a token; greedy output is token-identical to the plain engine.
# The backend CLI reads it beside --draft-dir (as --speculative does); an
# engine built in-process speculates whenever it is given a draft_model=.
define_flag("speculative_enabled", False,
            "backend processes given --draft-dir decode speculatively "
            "(like --speculative); in-process engines speculate when "
            "given draft_model=")

# generation/engine.py — proposals per speculative round; engine-wide: k
# shapes the draft and verify graphs and widens the ring store by k
# scratch entries.
define_flag("speculative_draft_k", 4,
            "draft tokens proposed per speculative decoding round; "
            "engine-level — changing it recompiles draft+verify")

# serving/server.py GenerationServer — the backend's role: "generate"
# serves /generate end to end; "prefill" runs only the bucketed forward and
# answers the KV slab (POST /prefill); "decode" admits handed-off slabs
# into decode slots (POST /generate_kv).
define_flag("backend_kind", "generate",
            "generation backend role: generate | prefill | decode "
            "(disaggregated fleets run distinct prefill/decode tiers)")

# serving/router.py — budget for the prefill leg of a disaggregated
# /generate (prompt -> KV slab). The decode leg keeps the normal request
# timeout: prefill is one bounded forward, decode an open-ended generation.
define_flag("serving_handoff_timeout_s", 30.0,
            "router timeout for the prefill->slab leg of a "
            "disaggregated /generate handoff")

# serving/router.py — period of the router's backend prober (GET /healthz +
# /loadz per backend): the freshness of the load signals and the only way
# back into rotation for an evicted backend.
define_flag("serving_router_probe_interval_s", 1.0,
            "seconds between router health/load probes of each backend; "
            "also the re-admission latency for a recovered backend")

# serving/router.py — distinct backends one request may be offered before
# the router answers 503. Only connection failures and admission refusals
# (503) retry; work a backend answered is never replayed.
define_flag("serving_router_retries", 3,
            "max distinct backends tried per routed request before 503 "
            "(connection failures / admission rejects only)")

# serving/router.py — TCP connect budget per dispatch attempt: a dead
# backend costs milliseconds, then the next backend is tried.
define_flag("serving_router_connect_timeout_ms", 1000.0,
            "router->backend TCP connect timeout per attempt in ms")

# serving/router.py — budget for one proxied request once a backend has it
# (its queueing and dispatch there).
define_flag("serving_router_request_timeout_s", 120.0,
            "router->backend response timeout once a request is "
            "dispatched (seconds)")

# monitor/registry.py — per-family bound on labeled children: past it every
# new label set collapses into the shared "other" series, so an unbounded
# dimension (a hostile tenant header) cannot grow the registry. Read at
# labels() time, so set_flags applies to live families.
define_flag("metrics_max_series", 64,
            "max distinct label sets per metric family before new sets "
            "collapse into the shared 'other' overflow series")

# monitor/training_monitor.py — steps between TrainingMonitor log lines
# (step wall time, examples/s, input-wait share, MFU, HBM share, roofline
# class). 0 silences the line; aggregation always runs.
define_flag("monitor_interval", 100,
            "steps between TrainingMonitor log lines (0: silent)")

# monitor/flight_recorder.py — the structured-event ring buffer the
# executor, captured steps, the router and flag changes report into;
# dumped on an unhandled exception, SIGUSR1 or a watchdog trip.
define_flag("flight_recorder", True,
            "record structured runtime events into the in-memory ring "
            "buffer for crash/hang post-mortems")

# monitor/flight_recorder.py — ring capacity, read once when the recorder
# is made (resizing a live ring would tear its seq accounting)
define_flag("flight_recorder_capacity", 4096,
            "flight-recorder ring buffer capacity (events)")

# monitor/flight_recorder.py — where dump files land
# (paddle_tpu_flight_rank<r>_pid<pid>.json); empty: the system temp dir
define_flag("flight_recorder_dump_dir", "",
            "directory for flight-recorder dump files (empty: temp dir)")

# monitor/flight_recorder.py HangWatchdog — trips when no step completes
# within the deadline; the trip dumps the recorder and every thread's
# stack. 0 disables.
define_flag("watchdog_timeout_s", 0.0,
            "hang watchdog deadline in seconds (0: disabled); on trip, "
            "dump the flight recorder + thread stacks + desync report")

# monitor/debug_server.py — /healthz /metrics /flightrecorder /threadz
# /flagz /costz /goodputz on 127.0.0.1:<port + rank>. 0 disables.
define_flag("debug_port", 0,
            "base port for the loopback HTTP debug endpoint "
            "(bound at port+rank; 0: disabled)")

# monitor/tracing.py — per-request trace spans, traceparent propagation
# router -> backend, /tracez.
define_flag("trace_enabled", True,
            "record per-request trace spans (traceparent propagation, "
            "/tracez, /statz slowest table)")

# monitor/tracing.py TraceStore — tail sampling: flagged traces are always
# kept, of the rest the K slowest a window
define_flag("trace_sample_slowest_k", 5,
            "retain the K slowest traces per sampling window in "
            "addition to every errored/flagged trace (0: flagged only)")

define_flag("trace_sample_window_s", 30.0,
            "tail-sampling window in seconds for the slowest-K "
            "retention race")

# monitor/tracing.py TraceStore — bound on retained traces (in-flight
# traces are bounded at 4x this)
define_flag("trace_store_capacity", 256,
            "maximum retained traces in the in-process trace store")

# monitor/slo.py — objectives, the engine's sampling period and the
# burn-rate alert multiple
define_flag("slo_objectives", "",
            "SLO definitions 'name|selector|k=v|...' joined by ';' "
            "(fields: threshold_ms | error_ratio, target, window_s, "
            "alert_burn); empty disables")

define_flag("slo_sample_interval_s", 10.0,
            "seconds between SLO engine good/total samples of the "
            "metric registry")

define_flag("slo_burn_alert", 14.4,
            "error-budget burn-rate multiple at which an SLO alerts "
            "(both windows) and the autoscaler sees up-pressure")

# monitor/goodput.py — the lifetime goodput ledger's GOODPUT.json
# directory (empty: off), its publication period and an optional
# goodput-ratio objective
define_flag("goodput_dir", "",
            "directory for the training goodput ledger's GOODPUT.json "
            "sidecar; empty disables the ledger")

define_flag("goodput_publish_interval_s", 30.0,
            "seconds between goodput sidecar publications (piggybacked "
            "on step commits; 0 publishes every step)")

define_flag("goodput_slo_target", 0.0,
            "goodput-ratio SLO target (e.g. 0.9) installed through the "
            "burn-rate engine; 0 disables")

# monitor/opprof.py profile_program — each op warmed opprof_warmup times,
# then timed best-of-opprof_repeats; top_ops/profilez keep opprof_topk
define_flag("opprof_warmup", 1,
            "per-op replay profiler: warmup runs before timing each op")
define_flag("opprof_repeats", 3,
            "per-op replay profiler: timed runs per op (best-of-N)")
define_flag("opprof_topk", 10,
            "top-K ops by device time shown on /statz and /profilez")
