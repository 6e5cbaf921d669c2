"""Backend-process entry point: one serving process of the fleet (``paddle_tpu/serving/backend.py``).

``python -m paddle_tpu_torch.serving.backend --kind predict --model-dir DIR``
boots an :class:`~paddle_tpu_torch.serving.InferenceServer` over a saved
static program (float or int8: ``create_predictor(Config(dir))``); ``--kind
generate | prefill | decode --gpt-dir DIR`` a
:class:`~paddle_tpu_torch.serving.GenerationServer` over a GPT saved by
``models.save_gpt_model`` (of either package), speculative with
``--draft-dir`` and ``--speculative`` (or ``FLAGS_speculative_enabled``).
It warms every graph of its kind, then waits for SIGTERM or SIGINT, on
which it drains (queued work completes, the listener closes) and exits 0.
This is the unit the router spreads traffic over.

With ``--port 0`` (the default) the bound port is announced through
``--port-file``: written atomically (a temporary file renamed) after
warmup, so a launcher polling for it never reads a half-written file or a
backend that is not ready.

``--device`` picks the device (the card unless named; ``cpu`` is how a test
asks for the CPU); the JAX CLI has no such flag. A geometry the memory
budget refuses (``FLAGS_memory_budget_check=strict``) exits 2 with the
``MemoryBudgetError`` on stderr, as the JAX CLI does. Objectives in
``FLAGS_slo_objectives`` are installed before the port is announced, so
``/sloz`` serves them. The JAX CLI's ``--mesh-dp`` (ROADMAP.md Queue A item
9) is not ported.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import tempfile
import threading

__all__ = ["main", "build_server"]


def _parse_args(argv):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.serving.backend",
        description="boot one serving backend process over a saved static program (predict) "
                    "or a saved GPT (generate / prefill / decode)")
    p.add_argument("--kind", default="predict",
                   choices=("predict", "generate", "prefill", "decode"),
                   help="backend role: predict serves /predict over --model-dir; the "
                        "generation kinds serve a causal LM from --gpt-dir (prefill/decode "
                        "are the disaggregated tiers)")
    p.add_argument("--model-dir", default=None,
                   help="directory of a saved static program (predict kind)")
    p.add_argument("--gpt-dir", default=None,
                   help="directory produced by models.save_gpt_model (generation kinds)")
    p.add_argument("--draft-dir", default=None,
                   help="draft-model directory (save_gpt_model): speculative decoding on the "
                        "generate/decode kinds with --speculative or FLAGS_speculative_enabled")
    p.add_argument("--speculative", action="store_true",
                   help="enable speculative decoding (needs --draft-dir)")
    p.add_argument("--draft-k", type=int, default=None,
                   help="proposals per speculative round (default: FLAGS_speculative_draft_k)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 binds an ephemeral port (see --port-file)")
    p.add_argument("--port-file", default="",
                   help="file to write the bound port into (atomic; written after warmup)")
    p.add_argument("--device", default=None,
                   help="torch device to serve on (default: the current CUDA card)")
    p.add_argument("--replicas", type=int, default=None)
    p.add_argument("--buckets", default=None,
                   help="comma-separated batch bucket ladder override")
    p.add_argument("--queue-capacity", type=int, default=None)
    p.add_argument("--batch-timeout-ms", type=float, default=None)
    # generation-engine knobs (generation kinds only)
    p.add_argument("--slots", type=int, default=None, help="decode slots (generation kinds)")
    p.add_argument("--cache-len", type=int, default=None, help="KV window (generation kinds)")
    p.add_argument("--prefill-buckets", default=None,
                   help="comma-separated prompt-length ladder (generation kinds)")
    p.add_argument("--kv-cache-dtype", default=None,
                   help="float32 | int8 (generation kinds; handoff tiers must match)")
    args = p.parse_args(argv)
    if args.kind == "predict" and not args.model_dir:
        p.error("--kind predict needs --model-dir")
    if args.kind != "predict" and not args.gpt_dir:
        p.error(f"--kind {args.kind} needs --gpt-dir")
    if args.speculative and not args.draft_dir:
        # a plain engine would leave the operator believing speculation is on
        p.error("--speculative needs --draft-dir")
    return args


def build_server(args):
    """The server of ``args.kind``, not started (tests drive it
    in-process): a predictor behind an ``InferenceServer`` for
    ``predict``, a ``GenerationEngine`` (speculative with a draft) behind a
    ``GenerationServer`` of the kind otherwise."""
    if args.kind != "predict":
        return _build_generation_server(args)
    from ..inference import Config, create_predictor
    from .server import InferenceServer

    pred = create_predictor(Config(args.model_dir), device=args.device)
    return InferenceServer(pred, port=args.port, host=args.host, replicas=args.replicas,
                           buckets=args.buckets, queue_capacity=args.queue_capacity,
                           batch_timeout_ms=args.batch_timeout_ms)


def _build_generation_server(args):
    from ..flags import flag
    from ..generation.engine import GenerationEngine
    from ..models.gpt import load_gpt_model
    from .server import GenerationServer

    model = load_gpt_model(args.gpt_dir)
    draft = None
    if args.draft_dir and (args.speculative or flag("speculative_enabled")):
        draft = load_gpt_model(args.draft_dir)
    engine = GenerationEngine(model, slots=args.slots, cache_len=args.cache_len,
                              prefill_buckets=args.prefill_buckets,
                              kv_cache_dtype=args.kv_cache_dtype, draft_model=draft,
                              draft_k=args.draft_k, device=args.device)
    return GenerationServer(engine, port=args.port, host=args.host, kind=args.kind,
                            queue_capacity=args.queue_capacity)


def _announce_port(path, port):
    """Write ``port`` to ``path`` atomically: the launcher polls for the
    file and must never read a partial write."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".port_")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(str(port))
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def main(argv=None) -> int:
    args = _parse_args(argv)
    from ..analysis import MemoryBudgetError

    try:
        srv = build_server(args)
    except MemoryBudgetError as e:
        # the geometry does not fit the card: refused at boot, naming the
        # geometry that would fit
        print(f"backend refused: {e}", file=sys.stderr, flush=True)
        return 2
    from ..monitor import slo as _slo

    _slo.install_from_flags()
    srv.start(warmup=True)  # /healthz turns ready only after warmup
    if args.port_file:
        _announce_port(args.port_file, srv.port)
    print(f"serving backend ready on {srv.url} (kind={args.kind}, "
          f"model={args.model_dir or args.gpt_dir}, pid={os.getpid()})", flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda s, f: stop.set())
    signal.signal(signal.SIGINT, lambda s, f: stop.set())
    stop.wait()
    # drain: admission refused (503: the router evicts), queued work
    # flushes, the listener closes
    srv.stop(drain=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
