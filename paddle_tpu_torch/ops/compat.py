"""Reference op-type compatibility: aliases and the small tail kernels (``paddle_tpu/ops/compat.py``).

An alias registers a reference op type that dispatches to the port's
kernel of its target (``reshape2``, ``transpose2``, ``matmul_v2`` and
``lookup_table_v2`` are what Paddle 2.0 writes into the programs it
saves), so a program either package wrote with those names runs. The
rest are plain torch over the JAX kernels' attribute names and
expressions.

Three kernels read values on the host (``runtime.compiled.host_read``),
so a static program that holds one runs uncaptured: ``print``,
``py_func`` (the callable runs on numpy arrays) and ``filter_by_instag``
(its row count is the data's; the op front refuses it in a static
program, as the JAX package does). ``shuffle_batch`` and
``sample_logits`` draw through ``generator=`` (the port's random ops'
rule); the JAX package's ``key`` attribute is taken and not read.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..framework.dtype import convert_dtype, torch_dtype
from .kernels import _draw
from .registry import get_op, host_read, register_op, register_shape

__all__ = []


def _alias(ref_name, target, num_outputs=1):
    k = get_op(target).fn

    def fn(*args, **kwargs):
        return k(*args, **kwargs)

    fn.__name__ = ref_name
    fn.__doc__ = f"alias of {target!r} (reference op type {ref_name!r})"
    register_op(ref_name, num_outputs=num_outputs)(fn)


# -- v2 / *2 io-variants (the same math, another slot layout) ---------------------
_alias("matmul_v2", "matmul")
_alias("reshape2", "reshape")
_alias("transpose2", "transpose")
_alias("squeeze2", "squeeze")
_alias("unsqueeze2", "unsqueeze")
_alias("flatten2", "flatten")
_alias("flatten_contiguous_range", "flatten")
_alias("top_k_v2", "top_k", num_outputs=2)
_alias("lookup_table_v2", "lookup_table")
_alias("elementwise_minus", "elementwise_sub")
_alias("minus", "elementwise_sub")


@register_op("space_to_depth")
def space_to_depth(x, *, blocksize):
    """``space_to_depth_op.cc``: ``pixel_unshuffle`` under the reference's
    attribute name."""
    return get_op("pixel_unshuffle").fn(x, downscale_factor=blocksize)


@register_op("shuffle_channel")
def shuffle_channel(x, *, group=None, groups=None):
    """``shuffle_channel_op.cc``: ``channel_shuffle`` (attribute ``group``)."""
    return get_op("channel_shuffle").fn(x, groups=group if group is not None else groups)


@register_op("fill_constant_batch_size_like")
def fill_constant_batch_size_like(x, *, shape, value=0.0, dtype="float32", input_dim_idx=0,
                                  output_dim_idx=0):
    """A constant of ``shape`` whose dim ``output_dim_idx`` is the input's
    dim ``input_dim_idx``."""
    out_shape = list(shape)
    out_shape[output_dim_idx] = x.shape[input_dim_idx]
    return torch.full(out_shape, value, dtype=convert_dtype(dtype), device=x.device)


@register_op("tril_triu")
def tril_triu(x, *, diagonal=0, lower=True):
    return (torch.tril if lower else torch.triu)(x, diagonal=diagonal)


# -- the interpolation family (``interpolate_op.cc`` registers one op a mode) -----


def _interp_mode(mode):
    def fn(x, *, out_h=None, out_w=None, out_d=None, scale=None, align_corners=False,
           align_mode=1, data_format="NCHW"):
        size = None
        if out_h is not None and out_w is not None:
            size = [out_d, out_h, out_w] if out_d is not None else [out_h, out_w]
        return get_op("interpolate").fn(x, size=size, scale_factor=scale, mode=mode,
                                        align_corners=align_corners, data_format=data_format)

    fn.__name__ = f"{mode}_interp"
    return fn


for _mode in ("nearest", "bilinear", "trilinear", "bicubic", "linear"):
    register_op(f"{_mode}_interp")(_interp_mode(_mode))


# -- pooling with indices ---------------------------------------------------------


def _tuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


@register_op("max_pool2d_with_index", num_outputs=2)
def max_pool2d_with_index(x, *, kernel_size, stride=None, padding=0, global_pooling=False,
                          adaptive=False):
    """``pool_with_index_op.cc``: the max of each window and its flat
    index in the ``H*W`` plane (int32), the first maximum in row-major
    order (``lax.reduce_window`` with a strict ``>``)."""
    _, _, h, w = x.shape
    ks = _tuple(kernel_size, 2)
    st = _tuple(stride, 2) if stride is not None else ks
    p = _tuple(padding, 2)
    if global_pooling:
        ks, st, p = (h, w), (1, 1), (0, 0)
    out, idx = F.max_pool2d(x, ks, st, p, return_indices=True)
    return out, idx.to(torch.int32)


@register_op("max_pool3d_with_index", num_outputs=2)
def max_pool3d_with_index(x, *, kernel_size, stride=None, padding=0):
    """The 3-D path: flat index in the ``D*H*W`` volume."""
    ks = _tuple(kernel_size, 3)
    st = ks if stride is None else _tuple(stride, 3)
    out, idx = F.max_pool3d(x, ks, st, _tuple(padding, 3), return_indices=True)
    return out, idx.to(torch.int32)


@register_op("unpool")
def unpool(x, indices, *, output_size):
    """``unpool_op.cc``: pooled values scattered back to the flat positions
    ``max_pool2d_with_index`` recorded."""
    n, c, _, _ = x.shape
    oh, ow = int(output_size[0]), int(output_size[1])
    flat = torch.zeros((n, c, oh * ow), dtype=x.dtype, device=x.device)
    flat = flat.scatter(2, indices.reshape(n, c, -1).to(torch.int64), x.reshape(n, c, -1))
    return flat.reshape(n, c, oh, ow)


# -- the small math and vision tail ---------------------------------------------------


@register_op("squared_l2_norm")
def squared_l2_norm(x):
    return torch.sum(torch.square(x))


@register_op("squared_l2_distance", num_outputs=2)
def squared_l2_distance(x, y):
    sub = x - y
    return sub, torch.sum(torch.square(sub), dim=tuple(range(1, x.dim())))


@register_op("pad_constant_like")
def pad_constant_like(x, y, *, pad_value=0.0):
    """``y`` padded at the end of each dim up to ``x``'s shape."""
    pads = [p for xs, ys in zip(reversed(x.shape), reversed(y.shape)) for p in (0, xs - ys)]
    return F.pad(y, pads, value=pad_value)


@register_op("lrn", num_outputs=2)
def lrn(x, *, n=5, k=1.0, alpha=1e-4, beta=0.75):
    """``lrn_op.cc``: local response normalization over channels; returns
    ``(out, mid)``, ``mid`` the denominator's base."""
    sq = torch.square(x)
    half = n // 2
    pad = F.pad(sq, (0, 0, 0, 0, half, n - 1 - half))
    acc = pad[:, 0:x.shape[1]]
    for i in range(1, n):
        acc = acc + pad[:, i:i + x.shape[1]]
    mid = k + alpha * acc
    return x / torch.pow(mid, beta), mid


@register_op("temporal_shift")
def temporal_shift(x, *, seg_num, shift_ratio=0.25):
    """``temporal_shift_op.cc`` (TSM): channel slices shifted across the
    time dim of ``[N*T, C, H, W]``."""
    nt, c, h, w = x.shape
    t = int(seg_num)
    v = x.reshape(nt // t, t, c, h, w)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    fwd = torch.cat([torch.zeros_like(v[:, :1, :c1]), v[:, :-1, :c1]], dim=1)
    bwd = torch.cat([v[:, 1:, c1:c2], torch.zeros_like(v[:, :1, c1:c2])], dim=1)
    return torch.cat([fwd, bwd, v[:, :, c2:]], dim=2).reshape(x.shape)


@register_op("cos_sim")
def cos_sim(x, y):
    xn = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), dim=-1, keepdim=True))
    return torch.sum(x * y, dim=-1, keepdim=True) / torch.clamp(xn * yn, min=1e-12)


@register_op("rank_loss")
def rank_loss(label, left, right):
    """``rank_loss_op.cc``: RankNet's pairwise loss."""
    d = left - right
    return torch.log1p(torch.exp(d)) - label * d


@register_op("margin_rank_loss", num_outputs=2)
def margin_rank_loss(label, left, right, *, margin=0.0):
    out = torch.clamp(-label * (left - right) + margin, min=0.0)
    return out, (out > 0).to(left.dtype)


@register_op("bpr_loss")
def bpr_loss(x, label):
    """``bpr_loss_op.cc``: Bayesian personalized ranking over logits ``[N,
    C]`` with positive labels ``[N, 1]``."""
    _, c = x.shape
    lbl = label.reshape(-1).to(torch.int64)
    diff = torch.gather(x, 1, lbl[:, None]) - x
    mask = torch.arange(c, device=x.device)[None, :] != lbl[:, None]
    return torch.sum(-F.logsigmoid(diff) * mask, dim=1, keepdim=True) / (c - 1)


@register_op("center_loss", num_outputs=3)
def center_loss(x, label, centers, *, alpha=0.1, update=True):
    """``center_loss_op.cc``: returns ``(loss [N, 1], diff, new_centers)``."""
    lbl = label.reshape(-1).to(torch.int64)
    diff = x - centers[lbl]
    loss = 0.5 * torch.sum(torch.square(diff), dim=1, keepdim=True)
    if not update:
        return loss, diff, centers
    cnt = torch.zeros(centers.shape[0], dtype=x.dtype, device=x.device).index_add(
        0, lbl, torch.ones_like(lbl, dtype=x.dtype))
    upd = torch.zeros_like(centers).index_add(0, lbl, diff)
    return loss, diff, centers + alpha * upd / (1.0 + cnt)[:, None]


@register_op("conv_shift")
def conv_shift(x, y):
    """``conv_shift_op.cc``: circular correlation of ``[B, N]`` with ``[B,
    M]`` (M odd, M <= N)."""
    n_len, m = x.shape[1], y.shape[1]
    half = m // 2
    idx = (torch.arange(n_len, device=x.device)[:, None]
           + torch.arange(-half, half + 1, device=x.device)[None, :]) % n_len
    return torch.einsum("bnm,bm->bn", x[:, idx], y)


@register_op("partial_concat")
def partial_concat(xs, *, start_index=0, length=-1):
    parts = [x[:, start_index:(x.shape[1] if length == -1 else start_index + length)]
             for x in xs]
    return torch.cat(parts, dim=1)


@register_op("partial_sum")
def partial_sum(xs, *, start_index=0, length=-1):
    out = None
    for x in xs:
        s = x[:, start_index:(x.shape[1] if length == -1 else start_index + length)]
        out = s if out is None else out + s
    return out


@register_op("shuffle_batch", num_outputs=2)
def shuffle_batch(x, *, key=None, generator=None):
    """The rows of ``x`` in a random order, and the order (int64)."""
    perm = _draw(x.device, generator, lambda gen: torch.randperm(
        x.shape[0], generator=gen, device=x.device))
    return x[perm], perm.to(torch.int64)


@register_op("sequence_reshape")
def sequence_reshape(x, *, new_dim):
    """``sequence_reshape_op.cc`` on the flat representation."""
    return x.reshape(-1, int(new_dim))


@register_op("sequence_scatter")
def sequence_scatter(x, index, updates):
    """``sequence_scatter_op.cc`` (flat segments): ``updates`` added at the
    flat row indices."""
    return x.index_add(0, index.reshape(-1).to(torch.int64), updates)


@register_op("row_conv")
def row_conv(x, w):
    """``row_conv_op.cc``: lookahead row convolution over ``[B, T, D]`` with
    a filter ``[future_context + 1, D]``."""
    ctx, t = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, 0, ctx - 1))
    out = pad[:, 0:t] * w[0][None, None, :]
    for i in range(1, ctx):
        out = out + pad[:, i:i + t] * w[i][None, None, :]
    return out


@register_op("affine_channel")
def affine_channel(x, scale, bias, *, data_format="NCHW"):
    shape = [1, -1] + [1] * (x.dim() - 2) if data_format == "NCHW" else [1] * (x.dim() - 1) + [-1]
    return x * scale.reshape(shape) + bias.reshape(shape)


@register_shape("print")
def _print_shape(x, **_):
    return torch.empty(x.shape, dtype=x.dtype, device="meta")


@register_op("print")
def print_op(x, *, message="", summarize=20, first_n=-1):
    """``print_op.cc``: prints the value on the host (a sanctioned host
    read) and passes it on unchanged."""
    host_read("print")
    print(message, x.detach().cpu().numpy())
    return x


@register_shape("py_func")
def _py_func_shape(*args, func, out_shapes, out_dtypes):
    outs = [torch.empty(tuple(s), dtype=torch_dtype(d), device="meta")
            for s, d in zip(out_shapes, out_dtypes)]
    return outs[0] if len(outs) == 1 else tuple(outs)


@register_op("py_func")
def py_func(*args, func, out_shapes, out_dtypes):
    """``py_func_op.cc``: a Python callable run as an op on the inputs'
    numpy arrays (a host read); its outputs cast to ``out_dtypes`` and
    placed on the first input's device."""
    host_read("py_func")
    out = func(*[a.detach().cpu().numpy() for a in args])
    outs = out if isinstance(out, (tuple, list)) else [out]
    device = args[0].device if args else None
    cast = [torch.from_numpy(np.ascontiguousarray(np.asarray(o, dtype=np.dtype(str(d))))).to(
        device) for o, d in zip(outs, out_dtypes)]
    return tuple(cast) if len(cast) > 1 else cast[0]


@register_op("shard_index_ref")
def shard_index_ref(x, *, index_num, nshards, shard_id, ignore_value=-1):
    """``shard_index_op.cc`` under its reference name."""
    shard_size = (index_num + nshards - 1) // nshards
    in_shard = torch.div(x, shard_size, rounding_mode="floor") == shard_id
    return torch.where(in_shard, torch.remainder(x, shard_size),
                       torch.full((), ignore_value, dtype=x.dtype, device=x.device))


# -- the rest of the reference tail -----------------------------------------------------

_alias("expand_v2", "expand")
_alias("expand_as_v2", "expand_as")
_alias("grid_sampler", "grid_sample")
_alias("cross_entropy2", "cross_entropy")
_alias("kldiv_loss", "kl_div")


@register_op("deformable_conv_v1")
def deformable_conv_v1(x, offset, weight, **kw):
    """``deformable_conv_v1_op.cc``: the unmodulated variant (no mask)."""
    return get_op("deformable_conv").fn(x, offset, None, weight, **kw)


@register_op("depthwise_conv2d_transpose")
def depthwise_conv2d_transpose(x, w, *, stride=1, padding=0, output_padding=0, dilation=1,
                               data_format="NCHW"):
    channels = x.shape[1] if data_format == "NCHW" else x.shape[-1]
    return get_op("conv2d_transpose").fn(x, w, stride=stride, padding=padding,
                                         output_padding=output_padding, dilation=dilation,
                                         groups=channels, data_format=data_format)


@register_op("frobenius_norm")
def frobenius_norm(x, *, axis=None, keepdim=False):
    dims = tuple(axis) if axis is not None else tuple(range(x.dim()))
    return torch.sqrt(torch.sum(torch.square(x), dim=dims, keepdim=keepdim))


@register_op("l1_norm")
def l1_norm(x):
    return torch.sum(torch.abs(x))


@register_op("huber_loss", num_outputs=2)
def huber_loss(x, y, *, delta=1.0):
    """``huber_loss_op.cc``: returns ``(out, residual)``."""
    r = y - x
    a = torch.abs(r)
    return torch.where(a <= delta, 0.5 * r * r, delta * (a - 0.5 * delta)), r


@register_op("crop_tensor")
def crop_tensor(x, *, shape, offsets=None):
    """``crop_tensor_op.cc``: a static window."""
    off = list(offsets) if offsets is not None else [0] * x.dim()
    return x[tuple(slice(o, o + s) for o, s in zip(off, shape))]


_alias("crop", "crop_tensor")


@register_op("gather_tree")
def gather_tree(ids, parents):
    """``gather_tree_op.cc``: beam-search backtracking, ``ids``/``parents``
    ``[T, B, W]`` -> the full sequences ``[T, B, W]``, one step a time
    step from the last."""
    t, b, w = ids.shape
    beams = torch.arange(w, dtype=parents.dtype, device=ids.device).expand(b, w)
    out = [None] * t
    for s in range(t - 1, -1, -1):
        idx = beams.to(torch.int64)
        out[s] = torch.gather(ids[s], 1, idx)
        beams = torch.gather(parents[s], 1, idx)
    return torch.stack(out)


@register_op("im2sequence")
def im2sequence(x, *, kernels, strides=(1, 1), paddings=(0, 0, 0, 0), dilations=(1, 1)):
    """``im2sequence_op.cc`` on the dense design: ``[N, C, H, W]`` -> ``[N,
    oh*ow, C*kh*kw]`` patch rows (paddings are top, left, bottom, right)."""
    ph0, pw0, ph1, pw1 = paddings
    xp = F.pad(x, (pw0, pw1, ph0, ph1))
    patches = F.unfold(xp, tuple(kernels), dilation=tuple(dilations), stride=tuple(strides))
    return patches.transpose(1, 2)


@register_op("fsp")
def fsp(x, y):
    """``fsp_op.cc``: the flow-of-solution-procedure matrix ``[N, C1, C2]``."""
    _, _, h, w = x.shape
    return torch.einsum("nahw,nbhw->nab", x, y) / (h * w)


@register_op("cvm")
def cvm(x, cvm_in, *, use_cvm=True):
    """``cvm_op.cc``: show/click columns log-transformed (``use_cvm``) or
    dropped."""
    if not use_cvm:
        return x[:, 2:]
    show = torch.log(x[:, 0:1] + 1.0)
    click = torch.log(x[:, 1:2] + 1.0) - torch.log(x[:, 0:1] + 1.0)
    return torch.cat([show, click, x[:, 2:]], dim=1)


@register_op("batch_fc")
def batch_fc(x, w, bias=None):
    """``batch_fc_op.cc``: ``[S, B, D] @ [S, D, O] + [S, 1, O]``."""
    out = torch.einsum("sbd,sdo->sbo", x, w)
    return out if bias is None else out + bias


def _act(name):
    return (lambda v: v) if name == "identity" else getattr(torch, name)


@register_op("gru_unit", num_outputs=3)
def gru_unit(x, h_prev, weight, bias=None, *, activation="tanh", gate_activation="sigmoid"):
    """``gru_unit_op.cc``: one GRU step over pre-projected ``x [B, 3D]``,
    ``weight [D, 3D]`` (update | reset | candidate). Returns ``(h,
    reset_h, gates)``."""
    d = x.shape[1] // 3
    act, gate = _act(activation), _act(gate_activation)
    xs = x + bias if bias is not None else x
    g_uz = gate(xs[:, :2 * d] + h_prev @ weight[:, :2 * d])
    u, r = g_uz[:, :d], g_uz[:, d:]
    rh = r * h_prev
    c = act(xs[:, 2 * d:] + rh @ weight[:, 2 * d:])
    h = u * h_prev + (1.0 - u) * c
    return h, rh, torch.cat([g_uz, c], dim=1)


@register_op("lstm_unit", num_outputs=2)
def lstm_unit(x, c_prev, *, forget_bias=0.0):
    """``lstm_unit_op.cc``: one LSTM cell step over gates ``x [B, 4D]``
    (i, f, o, g). Returns ``(c, h)``."""
    d = x.shape[1] // 4
    i, f, o, g = (x[:, k * d:(k + 1) * d] for k in range(4))
    c = c_prev * torch.sigmoid(f + forget_bias) + torch.sigmoid(i) * torch.tanh(g)
    return c, torch.sigmoid(o) * torch.tanh(c)


@register_op("lstmp", num_outputs=2)
def lstmp(x, w_proj, *, hidden_size):
    """``lstmp_op.cc``: an LSTM whose hidden state is projected; ``x [T, B,
    4H]`` pre-projected gates -> outputs ``[T, B, P]``, final cell ``[B,
    H]``."""
    c = torch.zeros((x.shape[1], int(hidden_size)), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(x.shape[0]):
        c, hh = lstm_unit(x[t], c)
        ys.append(hh @ w_proj)
    return torch.stack(ys), c


@register_op("mean_iou", num_outputs=3)
def mean_iou(predictions, labels, *, num_classes):
    """``mean_iou_op.cc``: ``(mean_iou, out_wrong, out_correct)``; labels
    out of ``[0, num_classes)`` are dropped."""
    p = predictions.reshape(-1).to(torch.int64)
    lb = labels.reshape(-1).to(torch.int64)
    k = int(num_classes)

    def count(idx, vals):
        ok = (idx >= 0) & (idx < k)
        return torch.zeros(k, dtype=torch.int64, device=p.device).index_add(
            0, torch.where(ok, idx, 0), torch.where(ok, vals, 0))

    ones = torch.ones_like(p)
    correct = count(lb, (p == lb).to(torch.int64))
    pred_cnt, label_cnt = count(p, ones), count(lb, ones)
    union = pred_cnt + label_cnt - correct
    valid = union > 0
    iou = torch.where(valid, correct.float() / torch.clamp(union, min=1).float(), 0.0)
    miou = torch.sum(iou) / torch.clamp(torch.sum(valid), min=1).float()
    return miou, (label_cnt - correct).to(torch.int32), correct.to(torch.int32)


@register_op("linear_chain_crf", num_outputs=4)
def linear_chain_crf(emission, transition, label):
    """``linear_chain_crf_op.cc`` on dense ``[B, T, C]``: the label path's
    negative log-likelihood; ``transition [C+2, C]`` is start, stop, then
    the pairwise scores. Returns ``(alpha [B, T, C], exp(emission),
    exp(transition), nll [B, 1])``."""
    b, t, _ = emission.shape
    start, stop, trans = transition[0], transition[1], transition[2:]
    alpha = start[None, :] + emission[:, 0]
    alphas = [alpha]
    for s in range(1, t):
        alpha = torch.logsumexp(alpha[:, :, None] + trans[None, :, :], dim=1) + emission[:, s]
        alphas.append(alpha)
    logz = torch.logsumexp(alpha + stop[None, :], dim=1)
    lbl = label.reshape(b, t).to(torch.int64)
    e_score = torch.gather(emission, 2, lbl[:, :, None])[..., 0].sum(dim=1)
    tr_score = trans[lbl[:, :-1], lbl[:, 1:]].sum(dim=1) if t > 1 else 0.0
    path = e_score + tr_score + start[lbl[:, 0]] + stop[lbl[:, -1]]
    return (torch.stack(alphas, dim=1), torch.exp(emission), torch.exp(transition),
            (logz - path)[:, None])


@register_op("nce")
def nce(x, weight, bias, label, sample_ids, *, num_total_classes, num_neg_samples):
    """``nce_op.cc``: noise-contrastive estimation over caller-given
    negatives ``sample_ids [B, S]``; ``x [B, D]``, ``weight [C, D]``."""
    label = label.to(torch.int64)
    sample_ids = sample_ids.to(torch.int64)
    true_logit = torch.sum(x * weight[label], dim=1)
    neg_logit = torch.einsum("bd,bsd->bs", x, weight[sample_ids])
    if bias is not None:
        true_logit = true_logit + bias[label]
        neg_logit = neg_logit + bias[sample_ids]
    pos_loss = -F.logsigmoid(true_logit)
    neg_loss = -torch.sum(F.logsigmoid(-neg_logit), dim=1)
    return (pos_loss + neg_loss)[:, None]


@register_op("sample_logits", num_outputs=4)
def sample_logits(logits, labels, *, key=None, num_samples, use_customized_samples=False,
                  customized_samples=None, customized_probabilities=None,
                  remove_accidental_hits=True, seed=0, generator=None):
    """``sample_logits_op.cc``: the true labels' logits and ``num_samples``
    uniformly drawn classes, corrected by ``-log q`` and with accidental
    hits pushed to -1e20. Returns ``(samples [B, T+S], probabilities,
    sampled_logits, sampled_labels [B, T])``."""
    b, c = logits.shape
    t, s = labels.shape[1], int(num_samples)
    if use_customized_samples:
        samples, probs = customized_samples, customized_probabilities
    else:
        neg = _draw(logits.device, generator, lambda gen: torch.randint(
            0, c, (b, s), generator=gen, device=logits.device))
        samples = torch.cat([labels.to(neg.dtype), neg], dim=1)
        probs = torch.full((b, t + s), 1.0 / c, dtype=logits.dtype, device=logits.device)
    picked = torch.gather(logits, 1, samples.to(torch.int64))
    sampled_logits = picked - torch.log(torch.clamp(probs, min=1e-20))
    if remove_accidental_hits:
        hit = torch.any(samples[:, None, t:] == labels[:, :, None], dim=1)
        mask = torch.cat([torch.zeros((b, t), dtype=torch.bool, device=hit.device), hit], dim=1)
        sampled_logits = torch.where(mask, sampled_logits - 1e20, sampled_logits)
    sampled_labels = torch.arange(t, device=logits.device).expand(b, t)
    return samples, probs, sampled_logits, sampled_labels


@register_op("filter_by_instag", num_outputs=3)
def filter_by_instag(x, instags, filter_tags, *, is_lod=True, out_val_if_empty=0.0):
    """``filter_by_instag_op.cc``: the rows whose tags meet the filter set;
    the row count is the data's (read on the host). Returns ``(out,
    loss_weight [kept, 1], kept_index)``."""
    host_read("filter_by_instag")
    xs, tags = x.detach().cpu().numpy(), instags.detach().cpu().numpy()
    fset = set(filter_tags.detach().cpu().numpy().reshape(-1).tolist())
    idx = np.nonzero(np.array([bool(fset.intersection(row.reshape(-1).tolist()))
                               for row in tags], dtype=bool))[0]
    if idx.size == 0:
        return (torch.full((1,) + tuple(x.shape[1:]), out_val_if_empty, dtype=x.dtype,
                           device=x.device),
                torch.zeros((1, 1), dtype=x.dtype, device=x.device),
                torch.zeros(1, dtype=torch.int64, device=x.device))
    return (torch.from_numpy(xs[idx]).to(x.device),
            torch.ones((idx.size, 1), dtype=x.dtype, device=x.device),
            torch.from_numpy(idx.astype(np.int64)).to(x.device))
