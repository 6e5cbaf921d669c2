"""Math, search and sampling op kernels (``paddle_tpu/ops/math_extra.py``), the ones ``tensor_kernels.py`` does not hold.

Plain torch over the JAX kernels' attribute names and expressions, so a
program either package saves runs in the other. ``bincount`` without a
static ``length`` and ``unique_consecutive`` have an output shape that
depends on the data: they run eagerly only, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .registry import register_op, register_shape

__all__ = []


@register_op("bincount")
def bincount(x, *, weights=None, minlength=0, length=None):
    """``length`` (static) fixes the output's size; counts of values at or
    past it are dropped. Without it the size is the data's (eager only)."""
    x = x.reshape(-1)
    if length is None:
        length = max(int(x.max()) + 1 if x.numel() else 0, int(minlength))
    length = int(length)
    # values at or past the end land in one extra bin, dropped
    x = torch.where(x < length, x, torch.full_like(x, length))
    w = None if weights is None else weights.reshape(-1)
    return torch.bincount(x, weights=w, minlength=length + 1)[:length]


@register_shape("bincount")
def _bincount_shape(x, *, weights=None, minlength=0, length=None):
    if length is None:
        raise ValueError("bincount without a static length= has a data-dependent size: "
                         "call it eagerly")
    dtype = torch.int64 if weights is None else weights.dtype
    return torch.empty(int(length), dtype=dtype, device="meta")


@register_op("unique_consecutive", num_outputs=3)
def unique_consecutive(x, *, return_inverse=False, return_counts=False, axis=None):
    """``(out, inverse, counts)`` (eager only: the size is the data's)."""
    xs = x.detach().cpu().numpy()
    xs = xs.reshape(-1) if axis is None else xs
    keep = np.ones(xs.shape[0], bool)
    if xs.shape[0] > 1:
        keep[1:] = np.any(xs[1:].reshape(xs.shape[0] - 1, -1)
                          != xs[:-1].reshape(xs.shape[0] - 1, -1), axis=1)
    grp = np.cumsum(keep) - 1
    out = [xs[keep], grp, np.bincount(grp)]
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(x.device) for a in out)


# -- pointwise -------------------------------------------------------------------


@register_op("logit")
def logit(x, *, eps=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1 - eps)
    return torch.log(x / (1 - x))


_ELEMENTWISE = {
    "logaddexp": torch.logaddexp, "heaviside": torch.heaviside, "gcd": torch.gcd,
    "lcm": torch.lcm, "nextafter": torch.nextafter, "ldexp": torch.ldexp,
    "copysign": torch.copysign, "hypot": torch.hypot,
}
for _name, _fn in _ELEMENTWISE.items():
    register_op(_name)(lambda x, y, _f=_fn: _f(x, y))

_UNARY = {
    "rad2deg": torch.rad2deg, "deg2rad": torch.deg2rad, "conj": torch.conj_physical,
    "i0": torch.i0, "sinc": torch.sinc, "signbit": torch.signbit,
}
for _name, _fn in _UNARY.items():
    register_op(_name)(lambda x, _f=_fn: _f(x))


@register_op("label_smooth")
def label_smooth(label, *, epsilon=0.1, prior_dist=None):
    """``operators/label_smooth_op.cc``."""
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


@register_op("glu")
def glu(x, *, axis=-1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


@register_op("rot90")
def rot90(x, *, k=1, axes=(0, 1)):
    return torch.rot90(x, k, list(axes))


@register_op("expand_as")
def expand_as(x, y):
    return torch.broadcast_to(x, y.shape)


_PAD_MODES = {"constant": "constant", "reflect": "reflect", "replicate": "replicate",
              "circular": "circular"}


@register_op("pad3d")
def pad3d(x, *, paddings, mode="constant", value=0.0, data_format="NCDHW"):
    """``operators/pad3d_op.cc``: the last three spatial dims, ``paddings =
    [left, right, top, bottom, front, back]``."""
    pads = [int(p) for p in paddings]
    channels_last = data_format != "NCDHW"
    if channels_last:  # NDHWC
        x = x.permute(0, 4, 1, 2, 3)
    kw = {"value": value} if mode == "constant" else {}
    out = F.pad(x, pads, mode=_PAD_MODES[mode], **kw)
    return out.permute(0, 2, 3, 4, 1) if channels_last else out


# -- sampling grids ----------------------------------------------------------------


@register_op("grid_sample")
def grid_sample(x, grid, *, mode="bilinear", padding_mode="zeros", align_corners=True):
    """``operators/grid_sampler_op.cc``: ``x [N, C, H, W]`` sampled at the
    normalized locations ``grid [N, Hg, Wg, 2]`` (x, y in [-1, 1])."""
    n, c, h, w = x.shape

    def unnormalize(coord, size):
        if align_corners:
            return (coord + 1) / 2 * (size - 1)
        return ((coord + 1) * size - 1) / 2

    gx = unnormalize(grid[..., 0], w)  # [N, Hg, Wg]
    gy = unnormalize(grid[..., 1], h)
    rows = torch.arange(n, device=x.device)[:, None, None]

    def at(yi, xi):
        """``x`` at integer-valued float coordinates: [N, C, Hg, Wg]."""
        yc = torch.clamp(yi, 0, h - 1).to(torch.int64)
        xc = torch.clamp(xi, 0, w - 1).to(torch.int64)
        v = x[rows, :, yc, xc].permute(0, 3, 1, 2)
        if padding_mode == "zeros":
            inb = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
            v = v * inb[:, None].to(x.dtype)
        return v

    if mode == "nearest":
        vals = at(torch.round(gy), torch.round(gx))
        if padding_mode == "zeros":
            inb = (gy >= 0) & (gy <= h - 1) & (gx >= 0) & (gx <= w - 1)
            vals = vals * inb[:, None].to(x.dtype)
        return vals
    y0, x0 = torch.floor(gy), torch.floor(gx)
    wy1, wx1 = gy - y0, gx - x0
    return (at(y0, x0) * ((1 - wy1) * (1 - wx1))[:, None]
            + at(y0, x0 + 1) * ((1 - wy1) * wx1)[:, None]
            + at(y0 + 1, x0) * (wy1 * (1 - wx1))[:, None]
            + at(y0 + 1, x0 + 1) * (wy1 * wx1)[:, None])


@register_op("affine_grid")
def affine_grid(theta, *, out_shape, align_corners=True):
    """``operators/affine_grid_op.cc``: ``theta [N, 2, 3]`` -> ``grid [N,
    H, W, 2]``."""
    _, _, h, w = [int(s) for s in out_shape]

    def linspace(size):
        if align_corners:
            return torch.linspace(-1.0, 1.0, size, dtype=theta.dtype, device=theta.device)
        step = 2.0 / size
        return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, size, dtype=theta.dtype,
                              device=theta.device)

    gy, gx = torch.meshgrid(linspace(h), linspace(w), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # [H, W, 3]
    return torch.einsum("hwk,njk->nhwj", base, theta)
