"""Transformer sequence-to-sequence model for machine translation (``paddle_tpu/models/seq2seq.py``).

An encoder-decoder over :class:`~paddle_tpu_torch.nn.Transformer` with
separate source and target embeddings, sinusoidal positions, pad masking
of the source and the causal mask of the target, with the JAX model's
parameter names (so ``paddle_tpu`` weights load by name through
:mod:`paddle_tpu_torch.convert`). Two decoders: greedy, through
:func:`~paddle_tpu_torch.generation.decode_loop`, and beam search, through
the ``beam_search_step`` / ``beam_search_decode`` ops. Every post-norm
residual pair goes through the fused LayerNorm kernel; the attention is
the unfused path (the model builds no flash attention, as the JAX one).
"""
from __future__ import annotations

import numpy as np
import torch

from ..generation.sampling import decode_loop
from ..nn import functional as F
from ..nn.layer_base import Layer
from ..nn.initializer import Normal
from ..nn.layers import Dropout, Embedding, Linear
from ..nn.transformer import Transformer
from ..ops.registry import kernel

__all__ = ["TransformerSeq2Seq"]


def _positional_encoding(max_len, d_model):
    """The sinusoidal table ``[max_len, d_model]``, computed in float64 and
    rounded to float32, as the JAX package computes it."""
    pos = np.arange(max_len)[:, None]
    i = np.arange(d_model)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / d_model)
    enc = np.where(i % 2 == 0, np.sin(angle), np.cos(angle))
    return enc.astype(np.float32)


class TransformerSeq2Seq(Layer):
    """Encoder-decoder MT model. ``pad_id`` source tokens are masked out of
    the attention over the source; the decoder's self-attention is causal.
    The embeddings start at N(0, d_model**-0.5), so that the ``x *
    sqrt(d_model)`` convention gives unit variance."""

    def __init__(self, src_vocab, tgt_vocab, d_model=128, nhead=4, num_layers=2,
                 dim_feedforward=256, dropout=0.1, max_len=256, bos_id=0, eos_id=1, pad_id=2,
                 generator=None, device=None):
        super().__init__()
        self.bos_id, self.eos_id, self.pad_id = bos_id, eos_id, pad_id
        self.d_model = d_model
        kw = dict(generator=generator, device=device)
        emb_init = Normal(0.0, d_model ** -0.5)
        self.src_emb = Embedding(src_vocab, d_model, weight_attr=emb_init, **kw)
        self.tgt_emb = Embedding(tgt_vocab, d_model, weight_attr=emb_init, **kw)
        self.register_buffer("pos_enc", torch.from_numpy(
            _positional_encoding(max_len, d_model)).to(device))
        self.dropout = Dropout(dropout)
        self.core = Transformer(d_model=d_model, nhead=nhead, num_encoder_layers=num_layers,
                                num_decoder_layers=num_layers, dim_feedforward=dim_feedforward,
                                dropout=dropout, **kw)
        self.out_proj = Linear(d_model, tgt_vocab, **kw)

    # -- pieces --------------------------------------------------------------
    def _embed(self, emb, ids):
        x = emb(ids) * float(np.sqrt(self.d_model))
        return self.dropout(x + self.pos_enc[:ids.shape[1]][None])

    def _pad_mask(self, ids):
        """``[B, L]`` ids -> the additive ``[B, 1, 1, L]`` mask, -1e9 on pads."""
        keep = (ids != self.pad_id).to(torch.float32)
        return (1.0 - keep[:, None, None, :]) * -1e9

    def encode(self, src_ids):
        return self.core.encoder(self._embed(self.src_emb, src_ids), self._pad_mask(src_ids))

    def decode_logits(self, memory, memory_mask, tgt_ids):
        causal = Transformer.generate_square_subsequent_mask(tgt_ids.shape[1],
                                                             device=tgt_ids.device)
        out = self.core.decoder(self._embed(self.tgt_emb, tgt_ids), memory, tgt_mask=causal,
                                memory_mask=memory_mask)
        return self.out_proj(out)

    def forward(self, src_ids, tgt_ids):
        """Teacher-forced training logits ``[B, T, V]``."""
        memory = self.encode(src_ids)
        return self.decode_logits(memory, self._pad_mask(src_ids), tgt_ids)

    # -- decoding -------------------------------------------------------------
    @torch.no_grad()
    def greedy_decode(self, src_ids, max_len=20, stop_at_eos=False):
        """Greedy decoding through :func:`decode_loop`: ``[B, max_len]``
        int64 ids from BOS. ``stop_at_eos`` ends early once every row has
        emitted EOS (off by default: the loop runs ``max_len - 1`` steps)."""
        memory = self.encode(src_ids)
        src_mask = self._pad_mask(src_ids)
        ys = torch.full((src_ids.shape[0], 1), self.bos_id, dtype=torch.int64,
                        device=src_ids.device)
        return decode_loop(lambda ys_: self.decode_logits(memory, src_mask, ys_)[:, -1], ys,
                           max_len, eos_id=self.eos_id if stop_at_eos else None)

    @torch.no_grad()
    def beam_search(self, src_ids, beam_size=4, max_len=20):
        """Beam-search decoding over the beam_search op pair. Returns
        ``(sequences [T, B, beam] int32, scores [B, beam])``: the best
        hypothesis of row ``b`` is column ``scores[b].argmax()``, backtracked
        by ``beam_search_decode``."""
        b, k = src_ids.shape[0], int(beam_size)
        dev = src_ids.device
        memory = self.encode(src_ids)
        # memory and mask repeated over the beams: [B*K, L, D], [B*K, 1, 1, L]
        mem_k = memory.repeat_interleave(k, dim=0)
        mask_k = self._pad_mask(src_ids).repeat_interleave(k, dim=0)
        scores = torch.zeros((b, k), dtype=torch.float32, device=dev)
        ys = torch.full((b * k, 1), self.bos_id, dtype=torch.int32, device=dev)
        rows = torch.arange(b, device=dev)[:, None] * k
        parents, tokens = [], []
        for t in range(max_len - 1):
            logits = self.decode_logits(mem_k, mask_k, ys)[:, -1]
            logp = torch.log(torch.clamp_min(F.softmax(logits), 1e-9)).reshape(b, k, -1)
            scores, parent, token = kernel("beam_search_step")(logp, scores, beam_size=k,
                                                               first_step=t == 0)
            parents.append(parent)
            tokens.append(token)
            # reorder the beams' histories by their parents, append the tokens
            ys = torch.cat([ys[(parent + rows).reshape(-1)], token.reshape(-1, 1)], dim=1)
        return kernel("beam_search_decode")(torch.stack(parents), torch.stack(tokens), scores)
