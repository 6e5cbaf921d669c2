"""The last registry tail: five niche reference ops (``paddle_tpu/ops/niche.py``).

``bilateral_slice`` (HDRNet's grid slice), ``rank_attention``,
``var_conv_2d`` and ``pyramid_hash`` are plain torch over static shapes.
``pyramid_hash`` hashes with the JAX package's FNV-1a (it stands in for
the reference's XXH32) in int64 masked to 32 bits, since torch has no
wrapping uint32 multiply on the card; the hashes are the JAX ones bit for
bit. ``tree_conv`` builds its patches by walking each tree on the host
(the reference does so too, ``math/tree2col.cc``): a sanctioned host read
(``runtime.compiled.host_read``), so a static program that holds it runs
uncaptured; only the patch-by-filter contraction runs on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import get_op, host_read, register_op, register_shape

__all__ = []


@register_op("bilateral_slice")
def bilateral_slice(x, grid, guide, *, has_offset=True):
    """``bilateral_slice_op.cc``: the grid ``[N, Co*(Ci+1), D, Gh, Gw]``
    (``Co*Ci`` without offset) sampled trilinearly at (x, y, guide) and
    applied as a per-pixel affine map to ``x [N, Ci, H, W]``."""
    n, ci, h, w = x.shape
    _, cg, d, gh, gw = grid.shape
    co = cg // (ci + 1) if has_offset else cg // ci
    dev = x.device
    gx = (torch.arange(w, device=dev) + 0.5) * gw / w - 0.5
    gy = (torch.arange(h, device=dev) + 0.5) * gh / h - 0.5
    gz = guide * d - 0.5
    fx = torch.clamp(torch.floor(gx), 0, gw - 2).to(torch.int64)
    fy = torch.clamp(torch.floor(gy), 0, gh - 2).to(torch.int64)
    fz = torch.clamp(torch.floor(gz), 0, d - 2).to(torch.int64)
    wx = torch.clamp(gx - fx, 0.0, 1.0)
    wy = torch.clamp(gy - fy, 0.0, 1.0)
    wz = torch.clamp(gz - fz, 0.0, 1.0)
    nn = torch.arange(n, device=dev)[:, None, None]
    acc = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                yy = (fy + dy)[None, :, None].expand(n, h, w)
                xx = (fx + dx)[None, None, :].expand(n, h, w)
                g = grid[nn, :, fz + dz, yy, xx]  # [N, H, W, Cg]
                wgt = ((wz if dz else (1 - wz)) * (wy if dy else (1 - wy))[None, :, None]
                       * (wx if dx else (1 - wx))[None, None, :])
                acc = acc + g * wgt[..., None]
    per_in = ci + 1 if has_offset else ci
    coeff = acc.reshape(n, h, w, co, per_in)
    out = torch.einsum("nhwoc,nhwc->nhwo", coeff[..., :ci], x.permute(0, 2, 3, 1))
    if has_offset:
        out = out + coeff[..., ci]
    return out.permute(0, 3, 1, 2)


@register_op("rank_attention", num_outputs=3)
def rank_attention(x, rank_offset, rank_param, *, max_rank=3, rank_param_shape=None):
    """``rank_attention_op.cc``: per-instance parameter blocks chosen by
    rank pairs, then one contraction. ``rank_offset [ins, 1+2*max_rank]``
    (own rank, then each other's rank and row). Returns ``(out [ins,
    para_col], input_help, ins_rank)``."""
    ins, fea = x.shape
    para_col = rank_param.shape[1]
    ro = rank_offset.to(torch.int64)
    ks = torch.arange(max_rank, device=x.device)
    lower = ro[:, 0] - 1
    faster = ro[:, 2 * ks + 1] - 1
    index = ro[:, 2 * ks + 2]
    valid = (lower[:, None] >= 0) & (faster >= 0)
    xin = torch.where(valid[..., None], x[torch.clamp(index, 0, ins - 1)], 0.0)
    blocks = rank_param.reshape(-1, fea, para_col)
    bidx = torch.clamp(lower[:, None] * max_rank + faster, 0, blocks.shape[0] - 1)
    par = torch.where(valid[..., None, None], blocks[bidx], 0.0)
    out = torch.einsum("ikf,ikfc->ic", xin, par)
    ins_rank = torch.where(ro[:, 0] > 0, ro[:, 0], -1).to(x.dtype)[:, None]
    return out, xin.reshape(ins, max_rank * fea), ins_rank


@register_op("var_conv_2d")
def var_conv_2d(x, w, rows, cols, *, output_channel, input_channel, kernel_h, kernel_w,
                stride_h=1, stride_w=1):
    """``var_conv_2d_op.cc`` on the padded batch ``[N, Cin, H, W]`` with
    each sample's extent ``rows``/``cols [N]``: input and output masked so
    positions past a sample's size are exactly zero."""
    _, _, hmax, wmax = x.shape
    rows, cols = rows.to(torch.int32), cols.to(torch.int32)
    hh = torch.arange(hmax, device=x.device)[None, :]
    ww = torch.arange(wmax, device=x.device)[None, :]
    in_mask = ((hh < rows[:, None])[:, None, :, None] & (ww < cols[:, None])[:, None, None, :])
    xm = torch.where(in_mask, x, 0.0)
    weight = w.reshape(output_channel, input_channel, kernel_h, kernel_w)
    out = get_op("conv2d").fn(xm, weight, stride=(stride_h, stride_w),
                              padding=(kernel_h // 2, kernel_w // 2))
    oh = torch.div(rows + stride_h - 1, stride_h, rounding_mode="floor")
    ow = torch.div(cols + stride_w - 1, stride_w, rounding_mode="floor")
    ho = torch.arange(out.shape[2], device=x.device)[None, :]
    wo = torch.arange(out.shape[3], device=x.device)[None, :]
    out_mask = ((ho < oh[:, None])[:, None, :, None] & (wo < ow[:, None])[:, None, None, :])
    return torch.where(out_mask, out, 0.0)


def _tree_patches(edges, n_nodes, max_depth):
    """``tree2col.cc``'s construct_tree and construct_patch on the host:
    from each root a depth-first walk to ``max_depth`` collecting (node,
    eta_l, eta_r, eta_t) of the continuous binary tree."""
    adj = [[] for _ in range(n_nodes + 1)]
    for a, b in edges:
        a, b = int(a), int(b)
        if a <= 0 or b <= 0:
            continue
        adj[a].append(b)  # parent -> child, 1-based (tree2col.cc:60)

    def eta(index, pclen, depth, fd):
        et = (fd - depth) / fd
        frac = 0.5 if pclen == 1 else (index - 1.0) / (pclen - 1.0)
        return et, (1.0 - et) * frac, (1.0 - et) * (1.0 - frac)

    patches = []
    for root in range(1, n_nodes + 1):
        patch = [(root, 1, 1, 0)]
        stack = [(root, 1, 1, 0)]
        visited = {root}
        while stack:
            node, _, _, depth = stack[-1]
            advanced = False
            children = adj[node]
            for i, v in enumerate(children):
                if v not in visited and depth + 1 < max_depth:
                    visited.add(v)
                    stack.append((v, i, len(children), depth + 1))
                    patch.append((v, i + 1, len(children), depth + 1))
                    advanced = True
            if not advanced:
                stack.pop()
        rows = []
        for node, idx, pclen, depth in patch:
            et, el, er = eta(idx, pclen, depth, float(max_depth))
            rows.append((node - 1, el, er, et))
        patches.append(rows)
    return patches


@register_shape("tree_conv")
def _tree_conv_shape(nodes_vector, edge_set, filter, *, max_depth=2):
    n, nodes = nodes_vector.shape[0], nodes_vector.shape[1]
    tail = tuple(filter.shape[2:])
    return torch.empty((n, max(1, nodes)) + tail, dtype=nodes_vector.dtype, device="meta")


@register_op("tree_conv")
def tree_conv(nodes_vector, edge_set, filter, *, max_depth=2):
    """``tree_conv_op.cc`` (TBCNN): ``nodes_vector [N, n, fea]``, ``edge_set
    [N, e, 2]`` (1-based parent, child; zero rows pad), ``filter [fea, 3,
    out_c(, num_filters)]`` -> ``[N, patches, out_c(, num_filters)]``. The
    patches are built on the host (a host read)."""
    host_read("tree_conv")
    nv = nodes_vector.detach().cpu().numpy()
    es = edge_set.detach().cpu().numpy()
    fea = nv.shape[2]
    per_batch = []
    for b in range(nv.shape[0]):
        patches = _tree_patches(es[b], nv.shape[1], max_depth)
        pm = np.zeros((max(1, len(patches)), fea, 3), np.float32)
        for pi, rows in enumerate(patches):
            for node_id, el, er, et in rows:
                pm[pi] += nv[b, node_id][:, None] * np.asarray([el, er, et], np.float32)
        per_batch.append(pm)
    most = max(pm.shape[0] for pm in per_batch)
    patch = np.stack([np.concatenate([pm, np.zeros((most - pm.shape[0], fea, 3), np.float32)])
                      for pm in per_batch])
    patch = torch.from_numpy(patch).to(device=nodes_vector.device, dtype=filter.dtype)
    squeeze = filter.dim() == 3
    filt = filter[..., None] if squeeze else filter
    out = torch.einsum("npft,ftcm->npcm", patch, filt)
    return out[..., 0] if squeeze else out


_MASK32 = 0xFFFFFFFF


def _fnv1a(tokens, seed):
    """FNV-1a over the bytes of int32 token windows ``[..., L]``, as uint32
    values held in int64 (the JAX package's stand-in for XXH32)."""
    h = torch.full(tokens.shape[:-1], (2166136261 ^ (int(seed) & _MASK32)), dtype=torch.int64,
                   device=tokens.device)
    toks = tokens.to(torch.int64) & _MASK32
    for k in range(tokens.shape[-1]):
        for shift in (0, 8, 16, 24):
            byte = (toks[..., k] >> shift) & 0xFF
            h = ((h ^ byte) * 16777619) & _MASK32
    return h


@register_op("pyramid_hash", num_outputs=2)
def pyramid_hash(x, w, *, num_emb, space_len, pyramid_layer, rand_len, white_list_len=0,
                 black_list_len=0, seed=0, drop_out_percent=0.0, is_training=0, use_filter=False,
                 lr=0.0, key=None):
    """``pyramid_hash_op.cc``: n-gram hash embeddings summed over the
    pyramid's levels. ``x [N, L]`` token ids (0 pads), ``w [space_len +
    rand_len, 1]``; each window of length 2..``pyramid_layer`` with no pad
    takes ``num_emb / rand_len`` hashed ``rand_len``-wide fragments of
    ``w``. Returns ``(out [N, num_emb] f32, drop_pos [N, 1] int32 ones)``."""
    n, length = x.shape
    n_frag = num_emb // rand_len
    acc = torch.zeros((n, num_emb), dtype=torch.float32, device=x.device)
    w_flat = w.reshape(-1)
    span = torch.arange(rand_len, device=x.device)
    for gram in range(2, pyramid_layer + 1):
        if gram > length:
            break
        for start in range(length - gram + 1):
            window = x[:, start:start + gram]
            valid = torch.all(window > 0, dim=1)
            frags = [w_flat[(_fnv1a(window, seed + j) % space_len)[:, None] + span]
                     for j in range(n_frag)]
            acc = acc + torch.where(valid[:, None], torch.cat(frags, dim=1), 0.0)
    return acc, torch.ones((n, 1), dtype=torch.int32, device=x.device)
