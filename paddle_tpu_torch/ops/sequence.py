"""The sequence (ragged) op family (``paddle_tpu/ops/sequence.py``).

A ragged batch is dense plus lengths, as in the JAX package: ``[B, T,
...]`` values and ``lengths [B]`` (every op here but ``segment_pool``,
which takes flat ``[N, ...]`` values and ``segment_ids [N]``). Masks
against the lengths stand in for the reference's LoD offsets, so the ops
run on the card without reading a length on the host and a static program
that holds them is captured.

Some forms size their output from the data and read it on the host
(``runtime.compiled.host_read``): ``sequence_unpad``, ``sequence_expand``,
``sequence_erase`` and ``sequence_mask``/``sequence_pad`` with
``maxlen=None``. The op front refuses them in a static program, as the
JAX package refuses them when they are appended; eagerly they run.
"""
from __future__ import annotations

import torch

from ..framework.dtype import torch_dtype
from .registry import host_read, register_op

__all__ = []

_NEG_INF = -1e9


def _time_mask(lengths, maxlen):
    """``[B, T]`` bool validity mask from ``lengths``."""
    return torch.arange(maxlen, device=lengths.device)[None, :] < lengths[:, None]


def _trail(m, ndim):
    """``m [B, T]`` reshaped to broadcast over ``ndim - 2`` trailing dims."""
    return m.reshape(m.shape + (1,) * (ndim - 2))


def _take_time(x, src):
    """``x[b, src[b, t], ...]`` for ``src [B, T']`` (``take_along_axis`` on
    axis 1)."""
    idx = _trail(src, x.dim()).expand((src.shape[0], src.shape[1]) + tuple(x.shape[2:]))
    return torch.gather(x, 1, idx)


def _data_maxlen(name, lengths):
    host_read(name)
    return int(lengths.max())


@register_op("sequence_mask")
def sequence_mask(lengths, *, maxlen=None, out_dtype="int64"):
    """``sequence_mask_op.cc``; ``maxlen=None`` takes the longest length
    (read on the host)."""
    maxlen = _data_maxlen("sequence_mask", lengths) if maxlen is None else int(maxlen)
    return _time_mask(lengths, maxlen).to(torch_dtype(out_dtype))


@register_op("sequence_pad", num_outputs=2)
def sequence_pad(x, lengths, *, maxlen=None, pad_value=0.0):
    """Flat ``[N, ...]`` + ``lengths [B]`` -> padded ``[B, maxlen, ...]`` +
    lengths; gather indices clipped into range, as the JAX kernel clips."""
    maxlen = _data_maxlen("sequence_pad", lengths) if maxlen is None else int(maxlen)
    offsets = torch.cumsum(lengths, 0) - lengths
    idx = offsets[:, None] + torch.arange(maxlen, device=x.device)[None, :]
    out = x[torch.clamp(idx, 0, x.shape[0] - 1)]
    mask = _trail(_time_mask(lengths, maxlen), out.dim())
    return torch.where(mask, out, torch.full((), pad_value, dtype=out.dtype,
                                             device=out.device)), lengths


@register_op("sequence_unpad")
def sequence_unpad(x, lengths):
    """Padded ``[B, T, ...]`` -> flat ``[N, ...]``, rows in batch order; the
    size is the lengths' sum (read on the host)."""
    host_read("sequence_unpad")
    return x[_time_mask(lengths, x.shape[1])]


@register_op("sequence_pool")
def sequence_pool(x, lengths, *, pooltype="SUM"):
    """``sequence_pool_op.cc`` over padded ``[B, T, ...]``:
    SUM/AVERAGE/SQRT/MAX/MIN/FIRST/LAST; SQRT divides by ``sqrt(len)``."""
    mask_e = _trail(_time_mask(lengths, x.shape[1]), x.dim())
    pool = pooltype.upper()
    if pool in ("SUM", "AVERAGE", "SQRT"):
        s = torch.where(mask_e, x, torch.zeros((), dtype=x.dtype, device=x.device)).sum(1)
        if pool == "SUM":
            return s
        denom = torch.clamp(lengths, min=1).to(s.dtype).reshape((-1,) + (1,) * (s.dim() - 1))
        return s / (denom if pool == "AVERAGE" else torch.sqrt(denom))
    if pool == "MAX":
        return torch.amax(torch.where(mask_e, x, -torch.inf), dim=1)
    if pool == "MIN":
        return torch.amin(torch.where(mask_e, x, torch.inf), dim=1)
    if pool == "FIRST":
        return x[:, 0]
    if pool == "LAST":
        return _take_time(x, torch.clamp(lengths - 1, min=0)[:, None]).squeeze(1)
    raise ValueError(f"unknown pooltype {pooltype}")


@register_op("segment_pool")
def segment_pool(x, segment_ids, *, num_segments, pooltype="SUM"):
    """Flat + segment ids pooling (``jax.ops.segment_*``): ids out of
    ``[0, num_segments)`` are dropped; an empty segment's MAX is -inf and
    its MIN +inf (the reductions' identities)."""
    pool = pooltype.upper()
    ids = segment_ids.to(torch.int64)
    ok = (ids >= 0) & (ids < num_segments)
    ids = torch.where(ok, ids, torch.zeros_like(ids))
    okx = ok.reshape((-1,) + (1,) * (x.dim() - 1))
    xm = torch.where(okx, x, torch.zeros((), dtype=x.dtype, device=x.device))
    shape = (int(num_segments),) + tuple(x.shape[1:])
    if pool in ("SUM", "AVERAGE"):
        s = torch.zeros(shape, dtype=x.dtype, device=x.device).index_add(0, ids, xm)
        if pool == "SUM":
            return s
        cnt = torch.zeros(shape[0], dtype=x.dtype, device=x.device).index_add(
            0, ids, ok.to(x.dtype))
        return s / torch.clamp(cnt, min=1).reshape((-1,) + (1,) * (s.dim() - 1))
    if pool in ("MAX", "MIN"):
        fill = -torch.inf if pool == "MAX" else torch.inf
        if not x.dtype.is_floating_point:
            info = torch.iinfo(x.dtype)
            fill = info.min if pool == "MAX" else info.max
        xs = torch.where(okx, x, torch.full((), fill, dtype=x.dtype, device=x.device))
        idx = ids.reshape((-1,) + (1,) * (x.dim() - 1)).expand(x.shape)
        return torch.full(shape, fill, dtype=x.dtype, device=x.device).scatter_reduce(
            0, idx, xs, reduce="amax" if pool == "MAX" else "amin", include_self=True)
    raise ValueError(f"unknown pooltype {pooltype}")


@register_op("sequence_softmax")
def sequence_softmax(x, lengths):
    """Masked softmax over the time axis, in float32."""
    mask = _trail(_time_mask(lengths, x.shape[1]), x.dim())
    w = torch.softmax(torch.where(mask, x, _NEG_INF).float(), dim=1)
    return torch.where(mask, w, 0.0).to(x.dtype)


@register_op("sequence_reverse")
def sequence_reverse(x, lengths):
    """Each valid prefix reversed, padding kept in place."""
    t = x.shape[1]
    ar = torch.arange(t, device=x.device)[None, :]
    src = torch.where(ar < lengths[:, None], lengths[:, None] - 1 - ar, ar)
    return _take_time(x, torch.clamp(src, 0, t - 1))


@register_op("sequence_slice")
def sequence_slice(x, offset, length, *, maxlen=None):
    """``out[b, t] = x[b, offset[b] + t]`` for ``t < length[b]``, zeros to
    a static ``maxlen`` (default ``T``)."""
    t = x.shape[1]
    maxlen = int(maxlen) if maxlen is not None else t
    ar = torch.arange(maxlen, device=x.device)[None, :]
    src = torch.clamp(offset.reshape(-1, 1) + ar, 0, t - 1)
    valid = _trail(ar < length.reshape(-1, 1), x.dim())
    return torch.where(valid, _take_time(x, src), torch.zeros((), dtype=x.dtype,
                                                              device=x.device))


@register_op("sequence_concat", num_outputs=2)
def sequence_concat(x, xlen, y, ylen):
    """``out[b] = x[b][:xlen] ++ y[b][:ylen]`` padded to ``Tx + Ty``."""
    t_out = x.shape[1] + y.shape[1]
    ar = torch.arange(t_out, device=x.device)[None, :]
    in_x = ar < xlen[:, None]
    x_src = torch.clamp(ar + torch.zeros_like(xlen[:, None]), 0, x.shape[1] - 1)
    y_src = torch.clamp(ar - xlen[:, None], 0, y.shape[1] - 1)
    out = torch.where(_trail(in_x, x.dim()), _take_time(x, x_src), _take_time(y, y_src))
    lengths = xlen + ylen
    mask = _trail(_time_mask(lengths, t_out), x.dim())
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype, device=out.device)), lengths


@register_op("sequence_expand")
def sequence_expand(x, rep):
    """Row ``b`` of ``x`` repeated ``rep[b]`` times; the row count is the
    data's (read on the host)."""
    host_read("sequence_expand")
    return torch.repeat_interleave(x, rep.to(torch.int64), dim=0)


@register_op("sequence_enumerate")
def sequence_enumerate(x, *, win_size, pad_value=0):
    """Every ``win_size`` window of ``x [N]``, ``pad_value`` past the end."""
    n = x.shape[0]
    idx = torch.arange(n, device=x.device)[:, None] + torch.arange(int(win_size),
                                                                   device=x.device)[None, :]
    return torch.where(idx < n, x[torch.clamp(idx, 0, n - 1)],
                       torch.full((), pad_value, dtype=x.dtype, device=x.device))


@register_op("sequence_erase")
def sequence_erase(x, *, tokens=()):
    """``x`` without the listed tokens; the size is the data's (read on
    the host)."""
    host_read("sequence_erase")
    toks = torch.tensor(list(tokens), dtype=x.dtype).to(x.device)
    return x[~torch.isin(x, toks)]


@register_op("sequence_conv")
def sequence_conv(x, lengths, weight, *, context_length, context_start=None):
    """Context-window convolution over time (``sequence_conv_op.cc``): at
    each step the features of ``[t + start, t + start + context_length)``
    (zeros outside the valid range) concatenated, times ``weight [ctx*D,
    M]``."""
    _, t, _ = x.shape
    start = -((context_length - 1) // 2) if context_start is None else int(context_start)
    mask = _time_mask(lengths, t)
    xm = x * mask[:, :, None].to(x.dtype)
    ar = torch.arange(t, device=x.device)
    cols = []
    for k in range(int(context_length)):
        pos = ar + (start + k)
        in_range = ((pos >= 0) & (pos < t))[None, :, None].to(x.dtype)
        cols.append(xm[:, torch.clamp(pos, 0, t - 1)] * in_range)
    out = torch.cat(cols, dim=-1) @ weight
    return out * mask[:, :, None].to(out.dtype)


@register_op("sequence_first_step")
def sequence_first_step(x, lengths):
    return sequence_pool(x, lengths, pooltype="FIRST")


@register_op("sequence_last_step")
def sequence_last_step(x, lengths):
    return sequence_pool(x, lengths, pooltype="LAST")

