"""Autoregressive decoding of the port (``paddle_tpu/generation``).

- :mod:`generation.cache`: the ring KV cache ``(k, v, pos)`` and the masks
  that make decoding through it equal a sliding-window full forward;
- :mod:`generation.sampling`: greedy / temperature / top-k sampling on the
  device, and the eager greedy ``decode_loop`` of the seq2seq model;
- :mod:`generation.engine`: :class:`GenerationEngine`, a CUDA graph per
  prefill bucket and one decode graph over every slot, with compile
  accounting (``extra_compiles() == 0`` in steady state).

Continuous batching over the engine and HTTP ``/generate`` live in
:mod:`paddle_tpu_torch.serving.continuous` and
:class:`paddle_tpu_torch.serving.GenerationServer`. The int8 and paged
caches, the handoff wire formats and speculative decoding are not ported
(ROADMAP.md Queue A item 3).

Quickstart::

    from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny_config
    from paddle_tpu_torch.generation import GenerationEngine

    engine = GenerationEngine(GPTForCausalLM(gpt_tiny_config()),
                              slots=4, cache_len=64).warmup()
    tokens = engine.generate([[5, 6, 7]], max_new_tokens=16)[0]
"""
from ..nn.transformer import (  # noqa: F401
    PagedStaticCache,
    QuantizedPagedCache,
    QuantizedStaticCache,
    StaticCache,
    causal_mask,
)
from .cache import (  # noqa: F401
    cache_nbytes,
    decode_mask,
    fresh_layer_caches,
    init_cache,
    insert_slot,
    insert_slot_kv,
    kv_bytes_per_token,
    layer_caches,
    pad_slot_arrays,
    prefill_mask,
    stack_layer_caches,
    verify_mask,
)
from .engine import COMPILE_COUNTER, GenerationEngine, MemoryBudgetError  # noqa: F401
from .sampling import decode_loop, sample_logits, top_k_filter  # noqa: F401

__all__ = [
    "GenerationEngine", "COMPILE_COUNTER", "MemoryBudgetError", "StaticCache",
    "QuantizedStaticCache", "PagedStaticCache", "QuantizedPagedCache", "causal_mask",
    "sample_logits", "top_k_filter", "decode_loop",
    "init_cache", "layer_caches", "stack_layer_caches", "fresh_layer_caches", "insert_slot",
    "insert_slot_kv", "cache_nbytes", "kv_bytes_per_token",
    "decode_mask", "prefill_mask", "verify_mask", "pad_slot_arrays",
]
