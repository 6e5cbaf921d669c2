"""3-D convolution and pooling, deformable convolution, ``data_norm`` and RoI pooling (``paddle_tpu/ops/nn_extra.py``).

Plain torch over the JAX kernels' attribute names and expressions (each
cites the reference's C++ source as the JAX kernel does): the
convolutions through ``F.conv3d``/``F.conv_transpose3d`` on explicitly
padded inputs, the pooling as a windowed max or sum over an input padded
as ``lax.reduce_window`` pads it, deformable convolution as bilinear
samples gathered into columns and one product a group, and the RoI pools
bin by bin.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import register_op, register_shape

__all__ = []


def _triple(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v, v)


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def _same_pads(sizes, kernel, stride, dilation):
    """``lax``'s ``"SAME"`` padding: ``[(lo, hi)]`` a spatial dim."""
    out = []
    for n, k, s, d in zip(sizes, kernel, stride, dilation):
        total = max((math.ceil(n / s) - 1) * s + (k - 1) * d + 1 - n, 0)
        out.append((total // 2, total - total // 2))
    return out


def _pad_last3(x, pads, value=0.0):
    """``x`` padded on its last three dims by ``[(lo, hi)] * 3``."""
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    return F.pad(x, flat, value=value) if any(flat) else x


@register_op("conv3d")
def conv3d(x, w, *, stride=1, padding=0, dilation=1, groups=1, data_format="NCDHW"):
    """``operators/conv_op.cc``'s 3-D path: ``x [N, C, D, H, W]``, ``w [O,
    C/g, kD, kH, kW]``; ``padding`` an int, three, or ``"SAME"``/``"VALID"``."""
    assert data_format == "NCDHW"
    stride, dilation = _triple(stride), _triple(dilation)
    if isinstance(padding, str):
        pads = ([(0, 0)] * 3 if padding.upper() == "VALID"
                else _same_pads(x.shape[2:], w.shape[2:], stride, dilation))
    else:
        pads = [(p, p) for p in _triple(padding)]
    return F.conv3d(_pad_last3(x, pads), w, stride=stride, dilation=dilation, groups=groups)


@register_op("conv3d_transpose")
def conv3d_transpose(x, w, *, stride=1, padding=0, output_padding=0, dilation=1, groups=1,
                     data_format="NCDHW"):
    """``conv_transpose_op.cc``'s 3-D path; ``w [C, O/g, kD, kH, kW]`` (the
    reference's deconvolution layout, torch's too)."""
    assert data_format == "NCDHW"
    return F.conv_transpose3d(x, w, stride=_triple(stride), padding=_triple(padding),
                              output_padding=_triple(output_padding), groups=groups,
                              dilation=_triple(dilation))


@register_op("pool3d")
def pool3d(x, *, kernel_size, stride=None, padding=0, pooling_type="max", ceil_mode=False,
           exclusive=True, data_format="NCDHW"):
    """``pool_op.cc``'s 3-D path as ``lax.reduce_window`` computes it: the
    input padded by ``padding`` (``ceil_mode`` adds ``stride - 1`` at the
    end), a window's max, or its sum over the count of real elements
    (``exclusive``) or over the window's size."""
    assert data_format == "NCDHW"
    ks = _triple(kernel_size)
    st = _triple(stride) if stride is not None else ks
    pads = [(p, p + (s - 1 if ceil_mode else 0)) for p, s in zip(_triple(padding), st)]
    if pooling_type == "max":
        low = -math.inf if x.dtype.is_floating_point else torch.iinfo(x.dtype).min
        return F.max_pool3d(_pad_last3(x, pads, low), ks, st)
    total = F.avg_pool3d(_pad_last3(x, pads), ks, st, divisor_override=1)
    if exclusive:
        return total / F.avg_pool3d(_pad_last3(torch.ones_like(x), pads), ks, st,
                                    divisor_override=1)
    return total / float(math.prod(ks))


# -- deformable convolution ----------------------------------------------------------


def _bilinear_chw(img, y, x):
    """``img [C, H, W]`` at float coordinates ``y [K]``, ``x [K]`` -> ``[C,
    K]``; zero outside (the deformable convolution's border rule)."""
    _, h, w = img.shape
    inb = (y > -1.0) & (y < h) & (x > -1.0) & (x < w)
    y0, x0 = torch.floor(y), torch.floor(x)
    wy1, wx1 = y - y0, x - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1

    def at(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        yc = torch.clamp(yy, 0, h - 1).to(torch.int64)
        xc = torch.clamp(xx, 0, w - 1).to(torch.int64)
        return torch.where(ok[None, :], img[:, yc, xc], 0.0)

    v = (at(y0, x0) * (wy0 * wx0)[None] + at(y0, x0 + 1) * (wy0 * wx1)[None]
         + at(y0 + 1, x0) * (wy1 * wx0)[None] + at(y0 + 1, x0 + 1) * (wy1 * wx1)[None])
    return torch.where(inb[None, :], v, 0.0)


@register_op("deformable_conv")
def deformable_conv(x, offset, mask, weight, *, stride=1, padding=0, dilation=1,
                    deformable_groups=1, groups=1, im2col_step=1):
    """``operators/deformable_conv_op.cc`` (modulated, v2; ``mask=None`` is
    v1): ``x [N, C, H, W]``, ``offset [N, 2*dg*kh*kw, Ho, Wo]`` ((dy, dx)
    a tap), ``mask [N, dg*kh*kw, Ho, Wo]``, ``weight [O, C/g, kh, kw]``.
    Sampled columns, then one product a group."""
    n, c, h, w_in = x.shape
    o, cpg, kh, kw = weight.shape
    st, dil, p = _pair(stride), _pair(dilation), _pair(padding)
    ho = (h + 2 * p[0] - (dil[0] * (kh - 1) + 1)) // st[0] + 1
    wo = (w_in + 2 * p[1] - (dil[1] * (kw - 1) + 1)) // st[1] + 1
    dg = deformable_groups
    cpdg = c // dg
    dev = x.device
    base_y = (torch.arange(ho, device=dev) * st[0] - p[0])[:, None, None, None]
    base_x = (torch.arange(wo, device=dev) * st[1] - p[1])[None, :, None, None]
    ky = (torch.arange(kh, device=dev) * dil[0])[None, None, :, None]
    kx = (torch.arange(kw, device=dev) * dil[1])[None, None, None, :]
    opg = o // groups
    outs = []
    for i in range(n):
        off = offset[i].reshape(dg, kh, kw, 2, ho, wo)
        msk = None if mask is None else mask[i].reshape(dg, kh, kw, ho, wo)
        cols = []
        for g in range(dg):
            dy = off[g, :, :, 0].permute(2, 3, 0, 1)  # [Ho, Wo, kh, kw]
            dx = off[g, :, :, 1].permute(2, 3, 0, 1)
            yy = base_y + ky + dy
            xx = base_x + kx + dx
            v = _bilinear_chw(x[i, g * cpdg:(g + 1) * cpdg], yy.reshape(-1),
                              xx.reshape(-1)).reshape(cpdg, ho, wo, kh, kw)
            if msk is not None:
                v = v * msk[g].permute(2, 3, 0, 1)[None]
            cols.append(v)
        col = torch.cat(cols, 0).permute(0, 3, 4, 1, 2).reshape(c * kh * kw, ho * wo)
        per = [weight[g * opg:(g + 1) * opg].reshape(opg, cpg * kh * kw)
               @ col[g * cpg * kh * kw:(g + 1) * cpg * kh * kw] for g in range(groups)]
        outs.append(torch.cat(per, 0).reshape(o, ho, wo))
    return torch.stack(outs)


# -- data_norm -------------------------------------------------------------------------


@register_op("data_norm", num_outputs=3)
def data_norm(x, batch_size, batch_sum, batch_square_sum, *, epsilon=1e-4):
    """``operators/data_norm_op.cc``'s forward: normalized by the
    accumulated statistics. Returns ``(y, means, scales)``."""
    means = batch_sum / batch_size
    scales = torch.sqrt(batch_size / batch_square_sum)
    return (x - means[None, :]) * scales[None, :], means, scales


# -- RoI pooling -------------------------------------------------------------------------


def _batch_indices(rois, batch_indices):
    if batch_indices is None:
        return [0] * rois.shape[0]
    return [int(b) for b in batch_indices.to(torch.int64).tolist()]


def _roi_shape(x, rois, *, batch_indices=None, pooled_height=1, pooled_width=1,
               output_channels=None, **_):
    """The RoI pools' output ``[R, C, ph, pw]`` (``C`` the output channels
    of ``psroi_pool``): static shape inference reads no batch index."""
    c = x.shape[1] if output_channels is None else int(output_channels)
    return torch.empty((rois.shape[0], c, int(pooled_height), int(pooled_width)),
                       dtype=x.dtype, device="meta")


for _name in ("roi_pool", "psroi_pool", "prroi_pool"):
    register_shape(_name)(_roi_shape)


@register_op("roi_pool")
def roi_pool(x, rois, *, batch_indices=None, pooled_height=1, pooled_width=1,
             spatial_scale=1.0):
    """``operators/roi_pool_op.cc``: the max of each RoI bin, the bins'
    boundaries rounded to whole cells; ``rois [R, 4]`` (x1, y1, x2, y2)."""
    _, _, h, w = x.shape
    ph, pw = int(pooled_height), int(pooled_width)
    ys, xs = torch.arange(h, device=x.device), torch.arange(w, device=x.device)
    out = []
    for roi, b in zip(rois, _batch_indices(rois, batch_indices)):
        x1, y1, x2, y2 = (torch.round(roi[k] * spatial_scale).to(torch.int64) for k in range(4))
        rh = torch.clamp(y2 - y1 + 1, min=1)
        rw = torch.clamp(x2 - x1 + 1, min=1)
        img = x[b]
        grid = []
        for py in range(ph):
            row = []
            for px in range(pw):
                hs = y1 + torch.div(py * rh, ph, rounding_mode="floor")
                he = y1 + torch.div((py + 1) * rh + ph - 1, ph, rounding_mode="floor")
                ws = x1 + torch.div(px * rw, pw, rounding_mode="floor")
                we = x1 + torch.div((px + 1) * rw + pw - 1, pw, rounding_mode="floor")
                m = (((ys >= hs) & (ys < torch.maximum(he, hs + 1)))[None, :, None]
                     & ((xs >= ws) & (xs < torch.maximum(we, ws + 1)))[None, None, :])
                row.append(torch.amax(torch.where(m, img, -math.inf), dim=(1, 2)))
            grid.append(torch.stack(row, 1))
        out.append(torch.stack(grid, 1))  # [C, ph, pw]
    return torch.stack(out)


@register_op("psroi_pool")
def psroi_pool(x, rois, *, batch_indices=None, output_channels=1, pooled_height=1,
               pooled_width=1, spatial_scale=1.0):
    """``operators/psroi_pool_op.cc``: position-sensitive average pooling,
    bin (py, px) reading channel group ``py * pw + px`` of its output
    channel."""
    _, c, h, w = x.shape
    ph, pw, oc = int(pooled_height), int(pooled_width), int(output_channels)
    assert c == oc * ph * pw, (c, oc, ph, pw)
    ys = torch.arange(h, device=x.device)
    xs = torch.arange(w, device=x.device)
    out = []
    for roi, b in zip(rois, _batch_indices(rois, batch_indices)):
        x1 = torch.round(roi[0]) * spatial_scale
        y1 = torch.round(roi[1]) * spatial_scale
        x2 = torch.round(roi[2] + 1.0) * spatial_scale
        y2 = torch.round(roi[3] + 1.0) * spatial_scale
        bin_h = torch.clamp(y2 - y1, min=0.1) / ph
        bin_w = torch.clamp(x2 - x1, min=0.1) / pw
        img = x[b].reshape(oc, ph * pw, h, w)
        grid = []
        for py in range(ph):
            row = []
            for px in range(pw):
                hs, he = torch.floor(y1 + py * bin_h), torch.ceil(y1 + (py + 1) * bin_h)
                ws, we = torch.floor(x1 + px * bin_w), torch.ceil(x1 + (px + 1) * bin_w)
                m = ((ys >= hs) & (ys < he))[:, None] & ((xs >= ws) & (xs < we))[None, :]
                cnt = torch.clamp(m.sum(), min=1)
                g = img[:, py * pw + px]
                row.append(torch.where(m[None], g, 0.0).sum(dim=(1, 2)) / cnt)
            grid.append(torch.stack(row, 1))
        out.append(torch.stack(grid, 1))
    return torch.stack(out)


def _tri_integral(a, b, centers):
    """The integral of ``max(0, 1 - |t - i|)`` over ``[a, b]`` for every
    center ``i``."""
    def cdf(u):
        return torch.where(u <= -1.0, 0.0, torch.where(
            u <= 0.0, 0.5 * (u + 1.0) ** 2, torch.where(u <= 1.0, 1.0 - 0.5 * (1.0 - u) ** 2,
                                                       1.0)))

    return cdf(b - centers) - cdf(a - centers)


@register_op("prroi_pool")
def prroi_pool(x, rois, *, batch_indices=None, pooled_height=1, pooled_width=1,
               spatial_scale=1.0):
    """``operators/prroi_pool_op.cc``: Precise RoI Pooling, the exact
    integral of the bilinearly interpolated map over each bin divided by
    the bin's area (per axis, closed forms of the triangle kernel)."""
    _, _, h, w = x.shape
    ph, pw = int(pooled_height), int(pooled_width)
    ys = torch.arange(h, dtype=x.dtype, device=x.device)
    xs = torch.arange(w, dtype=x.dtype, device=x.device)
    out = []
    for roi, b in zip(rois, _batch_indices(rois, batch_indices)):
        x1, y1, x2, y2 = (roi[k] * spatial_scale for k in range(4))
        bin_w = torch.clamp(x2 - x1, min=1e-6) / pw
        bin_h = torch.clamp(y2 - y1, min=1e-6) / ph
        img = x[b]
        grid = []
        for py in range(ph):
            row = []
            for px in range(pw):
                ax, bx = x1 + px * bin_w, x1 + (px + 1) * bin_w
                ay, by = y1 + py * bin_h, y1 + (py + 1) * bin_h
                wx = _tri_integral(ax, bx, xs)
                wy = _tri_integral(ay, by, ys)
                area = torch.clamp((bx - ax) * (by - ay), min=1e-6)
                row.append(torch.einsum("chw,h,w->c", img, wy, wx) / area)
            grid.append(torch.stack(row, 1))
        out.append(torch.stack(grid, 1))
    return torch.stack(out)
