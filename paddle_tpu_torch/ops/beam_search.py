"""Beam search ops (``paddle_tpu/ops/beam_search.py``), registered under the same names.

A fixed beam width everywhere: the batch of beams is a dense ``[batch,
beam]`` lattice. A step takes the best ``beam_size`` of ``[batch,
beam * vocab]`` running scores; decoding walks the stored parent pointers
backwards. The JAX step takes them with ``lax.top_k``, which puts the
lower flat index first among equal scores; ``torch.topk`` promises no
order among ties on the card, and ties are common here (``log(max(p,
1e-9))`` clamps every tiny probability to one value), so the step sorts
stably in descending order and keeps the first ``beam_size``. Parents and
tokens are int32, as ``lax.top_k``'s indices are.
"""
from __future__ import annotations

import torch

from .registry import register_op

__all__ = ["beam_search_step", "beam_search_decode"]


@register_op("beam_search_step", num_outputs=3)
def beam_search_step(log_probs, beam_scores, *, beam_size, end_id=None, first_step=False):
    """One beam expansion. ``log_probs [batch, beam, vocab]``, ``beam_scores
    [batch, beam]``; returns ``(scores, parent_idx, token_ids)``, each
    ``[batch, beam_size]``. On the first step every beam is the same
    hypothesis, so only beam 0 expands (the others are masked to -inf)."""
    b, k, v = log_probs.shape
    total = beam_scores[:, :, None] + log_probs
    if first_step:
        mask = torch.full((1, k, 1), float("-inf"), dtype=total.dtype, device=total.device)
        mask[0, 0, 0] = 0.0
        total = total + mask
    scores, idx = torch.sort(total.reshape(b, k * v), dim=1, descending=True, stable=True)
    scores, idx = scores[:, :int(beam_size)], idx[:, :int(beam_size)].to(torch.int32)
    return scores, torch.div(idx, v, rounding_mode="floor"), idx % v


@register_op("beam_search_decode", num_outputs=2)
def beam_search_decode(parents, tokens, final_scores, *, end_id=None):
    """Backtrack ``parents``/``tokens [T, batch, beam]`` (the steps' outputs)
    to ``(sequences [T, batch, beam], final_scores)``: column ``j`` of every
    batch row is the hypothesis that ends in beam ``j``."""
    t, b, k = tokens.shape
    beam = torch.arange(k, device=tokens.device).expand(b, k)
    seqs = [None] * t
    for i in reversed(range(t)):
        seqs[i] = torch.gather(tokens[i], 1, beam)
        beam = torch.gather(parents[i], 1, beam).to(torch.int64)
    return torch.stack(seqs), final_scores
