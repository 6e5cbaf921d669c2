"""Token sampling and the eager greedy loop (``paddle_tpu/generation/sampling.py``).

- :func:`sample_logits` draws one token per row on the logits' device with
  no host decision, so a CUDA graph captures it: greedy rows (temperature
  <= 0) and sampled rows are both computed and selected with
  ``torch.where``, so per-row greedy/sampled mixes share one graph; top-k is
  an engine-wide setting (it shapes the graph), the temperature a device
  input. Sampled rows take the Gumbel-max of the scaled logits over
  uniforms drawn from an explicit ``torch.Generator``, the method of
  ``jax.random.categorical``; the streams differ from JAX's, so only the
  distribution is comparable.
- :func:`decode_loop` is the eager greedy loop the seq2seq model shares.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["sample_logits", "top_k_filter", "decode_loop"]


def top_k_filter(logits, k):
    """Every logit below the k-th largest of its row set to -inf; ``k <= 0``
    (or ``k`` past the vocabulary) keeps the whole row. The threshold is the
    k-th value of ``torch.topk``, so the mask does not depend on the order
    of ties."""
    k = int(k)
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, -float("inf")), logits)


def sample_logits(logits, generator, temperature, top_k=0):
    """One token per row of ``logits [B, V]`` (int64 ``[B]``).

    ``temperature`` is a number or a ``[B]`` tensor on the logits' device:
    rows at ``<= 0`` take the argmax (the first index among ties, as
    ``jnp.argmax``), the others sample ``softmax(top_k(logits) / T)`` by
    Gumbel-max over uniforms from ``generator`` (a ``torch.Generator`` on
    the logits' device)."""
    temperature = torch.as_tensor(temperature, dtype=logits.dtype, device=logits.device)
    if temperature.dim() == 0:
        temperature = temperature.expand(logits.shape[0])
    greedy = torch.argmax(logits, dim=-1)
    scaled = top_k_filter(logits, top_k) / torch.clamp(temperature, min=1e-6)[:, None]
    u = torch.rand(logits.shape, generator=generator, dtype=logits.dtype,
                   device=logits.device)
    # jax.random.gumbel: -log(-log(u)), u in [tiny, 1)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(logits.dtype).tiny)))
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(temperature > 0.0, sampled, greedy)


def decode_loop(next_logits, ys, max_len, eos_id=None):
    """Greedy host-side decode loop (eager models, no KV cache).

    ``next_logits(ys) -> [B, V]`` returns next-token logits given the tokens
    so far (``ys [B, T]``); the loop appends the argmax (the first index
    among ties) until ``ys`` reaches ``max_len`` columns or, with ``eos_id``
    set, every row has emitted EOS, which the host reads after each step.
    Returns the grown ``ys`` (int64)."""
    b = ys.shape[0]
    done = np.zeros(b, bool)
    for _ in range(int(max_len) - ys.shape[1]):
        nxt = torch.argmax(next_logits(ys), dim=-1)
        ys = torch.cat([ys, nxt.reshape(b, 1).to(torch.int64)], dim=1)
        if eos_id is not None:
            done |= nxt.reshape(-1).cpu().numpy() == eos_id
            if done.all():
                break
    return ys
