"""hapi text layers (``paddle_tpu/incubate/hapi_text.py``; incubate/hapi/text/text.py parity).

The reference names of layers the port already has are re-exported (the
RNN family from ``nn/rnn.py``; ``MultiHeadAttention`` and the Transformer
classes from ``nn/transformer.py``, so ``use_flash_attention`` reaches the
hand-written attention and the post-norm residual LayerNorm kernels). The
module's own pieces:

- :class:`Conv1dPoolLayer` / :class:`CNNEncoder` (text.py:1218, :1287):
  conv1d + pooling over time, several filter sizes concatenated.
- :class:`LinearChainCRF` (text.py:1344, operators/linear_chain_crf_op.cc):
  the per-sequence negative log-likelihood, with the ``[n+2, n]``
  transition (row 0 the start scores, row 1 the stop scores, rows 2.. the
  label-to-label ones). The JAX package runs the forward algorithm under
  ``lax.scan``; here a loop over the T positions runs it on tensors, each
  position past a row's length leaving that row's state as it was, so the
  loop captures into a CUDA graph as it is.
- :class:`CRFDecoding` (text.py:1421, operators/crf_decoding_op.cc):
  Viterbi with back-pointers. Ties take the first maximum, as
  ``jnp.argmax``; a position past a row's length points at itself, so the
  path repeats the last label there.
- :class:`SequenceTagging` (text.py:1583): embedding, GRU, emission
  projection and CRF, the lexical-analysis tagger.

Numpy or list inputs become tensors on the layer's device.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import ops
from ..framework.tensor import wrap
from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer_base import Layer
from ..nn.layers import Conv1D, Embedding, Linear
from ..nn.rnn import GRU, LSTM, GRUCell, LSTMCell, SimpleRNN
from ..nn.transformer import (
    MultiHeadAttention,
    TransformerDecoder,
    TransformerDecoderLayer,
    TransformerEncoder,
    TransformerEncoderLayer,
)

__all__ = [
    # re-exported equivalents (reference names)
    "RNN", "LSTM", "GRU", "BasicLSTMCell", "BasicGRUCell",
    "MultiHeadAttention", "TransformerEncoderLayer", "TransformerEncoder",
    "TransformerDecoderLayer", "TransformerDecoder",
    # implemented here
    "Conv1dPoolLayer", "CNNEncoder",
    "LinearChainCRF", "CRFDecoding", "SequenceTagging",
]

RNN = SimpleRNN
BasicLSTMCell = LSTMCell
BasicGRUCell = GRUCell


def _tensor(v, device, dtype=None):
    """``v`` as a tensor on ``device`` (``dtype`` when it is converted)."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)


class Conv1dPoolLayer(Layer):
    """conv1d + pooling over time (text.py:1218): ``x [B, C, T]`` ->
    ``[B, num_filters]``, the relu'd convolution's max (or, for any other
    ``pool_type``, its mean) over T."""

    def __init__(self, num_channels, num_filters, filter_size, pool_type="max",
                 generator=None, device=None):
        super().__init__()
        self.conv = Conv1D(num_channels, num_filters, filter_size, padding=filter_size // 2,
                           generator=generator, device=device)
        self.pool_type = pool_type

    def forward(self, x):
        h = F.relu(self.conv(x))
        return ops.max(h, axis=-1) if self.pool_type == "max" else ops.mean(h, axis=-1)


class CNNEncoder(Layer):
    """Conv1dPoolLayers over several filter sizes, concatenated (text.py:1287,
    the Kim-CNN text encoder): ``[B, C, T]`` -> ``[B, len(filter_sizes) *
    num_filters]``."""

    def __init__(self, num_channels, num_filters, filter_sizes=(2, 3, 4), pool_type="max",
                 generator=None, device=None):
        super().__init__()
        self.convs = [self.add_sublayer(f"conv_pool_{i}", Conv1dPoolLayer(
            num_channels, num_filters, fs, pool_type, generator=generator, device=device))
            for i, fs in enumerate(filter_sizes)]

    def forward(self, x):
        return ops.concat([c(x) for c in self.convs], axis=-1)


def _crf_nll(emission, transition, labels, lengths):
    """Per-sequence CRF negative log-likelihood ``[B]``: log Z by the forward
    algorithm minus the gold path's score (``_crf_lognorm`` minus
    ``_crf_scores`` of the JAX module). ``emission [B, T, n]``,
    ``transition [n+2, n]``, ``labels [B, T]`` and ``lengths [B]`` int64."""
    b, t, n = emission.shape
    start, stop, trans = transition[0], transition[1], transition[2:]
    pos = torch.arange(t, device=emission.device)
    mask = (pos[None, :] < lengths[:, None]).to(emission.dtype)
    emit = torch.gather(emission, 2, labels[..., None])[..., 0]
    score = (emit * mask).sum(1) + start[labels[:, 0]]
    pair = trans[labels[:, :-1], labels[:, 1:]]
    score = score + (pair * mask[:, 1:]).sum(1)
    last = torch.clamp(lengths - 1, 0, t - 1)
    score = score + stop[torch.gather(labels, 1, last[:, None])[:, 0]]
    alpha = start + emission[:, 0]
    for i in range(1, t):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) + emission[:, i]
        alpha = torch.where((lengths > i)[:, None], nxt, alpha)
    return torch.logsumexp(alpha + stop[None], dim=1) - score


def _crf_viterbi(emission, transition, lengths):
    """The best label path ``[B, T]`` int64 of each sequence under the CRF
    (the JAX ``CRFDecoding.forward``)."""
    b, t, n = emission.shape
    start, stop, trans = transition[0], transition[1], transition[2:]
    same = torch.arange(n, device=emission.device)[None, :].expand(b, n)
    alpha = start + emission[:, 0]
    ptrs = []
    for i in range(1, t):
        cand = alpha[:, :, None] + trans[None]  # [B, from, to]
        valid = (lengths > i)[:, None]
        alpha = torch.where(valid, cand.amax(dim=1) + emission[:, i], alpha)
        ptrs.append(torch.where(valid, cand.argmax(dim=1), same))
    lab = (alpha + stop[None]).argmax(dim=1)
    path = [lab]
    for ptr in reversed(ptrs):
        lab = torch.gather(ptr, 1, lab[:, None])[:, 0]
        path.append(lab)
    return torch.stack(path[::-1], dim=1)


class LinearChainCRF(Layer):
    """CRF negative log-likelihood layer (text.py:1344):
    ``forward(emission, labels, lengths)`` -> per-sequence NLL ``[B]``. The
    transition ``[size + 2, size]`` is drawn from N(0, 0.1) unless
    ``param_attr`` says otherwise."""

    def __init__(self, size, param_attr=None, generator=None, device=None):
        super().__init__()
        self.size = size
        self.transition = self.create_parameter(
            [size + 2, size], attr=param_attr, default_initializer=I.Normal(0.0, 0.1),
            generator=generator, device=device)

    def forward(self, emission, labels, lengths):
        dev = self.transition.device
        return wrap(_crf_nll(_tensor(emission, dev), self.transition,
                             _tensor(labels, dev, torch.int64),
                             _tensor(lengths, dev, torch.int64)))


class CRFDecoding(Layer):
    """Viterbi decoding sharing a :class:`LinearChainCRF`'s transition
    (text.py:1421): ``forward(emission, lengths)`` -> int64 paths
    ``[B, T]``."""

    def __init__(self, crf: LinearChainCRF):
        super().__init__()
        self.crf = crf

    def forward(self, emission, lengths):
        tr = self.crf.transition
        with torch.no_grad():
            return wrap(_crf_viterbi(_tensor(emission, tr.device).to(tr.dtype), tr.detach(),
                                     _tensor(lengths, tr.device, torch.int64)))


class SequenceTagging(Layer):
    """embedding -> GRU -> emission -> CRF (text.py:1583): ``forward(word_ids,
    labels, lengths)`` is the mean CRF NLL, the training loss;
    :meth:`decode` runs Viterbi."""

    def __init__(self, vocab_size, num_labels, word_emb_dim=64, hidden_size=64):
        super().__init__()
        self.embedding = Embedding(vocab_size, word_emb_dim)
        self.gru = GRU(word_emb_dim, hidden_size)
        self.emission_fc = Linear(hidden_size, num_labels)
        self.crf = LinearChainCRF(num_labels)
        self.decoder = CRFDecoding(self.crf)

    def _emission(self, word_ids):
        h, _ = self.gru(self.embedding(_tensor(word_ids, self.crf.transition.device,
                                               torch.int64)))
        return self.emission_fc(h)

    def forward(self, word_ids, labels, lengths):
        return self.crf(self._emission(word_ids), labels, lengths).mean()

    def decode(self, word_ids, lengths):
        return self.decoder(self._emission(word_ids), lengths)
