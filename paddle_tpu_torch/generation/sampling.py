"""The eager greedy decode loop (``paddle_tpu/generation/sampling.py:53-76``)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["decode_loop"]


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
