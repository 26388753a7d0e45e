"""Extended convolution and feature-interaction ops.

Counterpart of ``paddle_tpu.ops.conv_extra`` (the reference's 3-D and
depthwise transposed convolutions, deformable convolution v1/v2,
``row_conv``, ``var_conv_2d``, ``tree_conv``, ``spp``, ``fsp``,
``partial_sum``/``partial_concat``, ``batch_fc``, ``rank_attention``,
``cvm``, ``match_matrix_tensor`` and ``pyramid_hash``), with the JAX
module's dense designs: irregular gathers as gathers and one-hot
contractions, ragged inputs as padded ``(x, length)`` pairs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .nn_functional import (_conv_transpose, _pads, _pair,
                            adaptive_avg_pool2d, adaptive_max_pool2d,
                            conv2d)

__all__ = ["conv3d_transpose", "depthwise_conv2d_transpose",
           "deformable_conv", "row_conv", "var_conv_2d", "tree_conv",
           "spp", "fsp_matrix", "partial_sum", "partial_concat",
           "batch_fc", "rank_attention", "cvm", "match_matrix_tensor",
           "pyramid_hash"]


def conv3d_transpose(x: torch.Tensor, weight: torch.Tensor, bias=None,
                     stride=1, padding=0, output_padding=0, dilation=1,
                     groups: int = 1) -> torch.Tensor:
    """NCDHW transposed convolution, weight ``[in, out / groups, kd, kh,
    kw]`` (``nn_functional._conv_transpose``)."""
    out = _conv_transpose(x, weight, stride, padding, output_padding,
                          dilation, groups)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1, 1)
    return out


def depthwise_conv2d_transpose(x: torch.Tensor, weight: torch.Tensor,
                               bias=None, stride=1, padding=0,
                               output_padding=0,
                               dilation=1) -> torch.Tensor:
    from .nn_functional import conv2d_transpose
    return conv2d_transpose(x, weight, bias, stride, padding,
                            output_padding, dilation, groups=x.shape[1])


def _bilinear_gather(x: torch.Tensor, yy: torch.Tensor,
                     xx: torch.Tensor) -> torch.Tensor:
    """``x [B, C, H, W]`` sampled at fractional ``(yy, xx)`` ``[B, ...]``,
    a corner outside the map contributing 0 -> ``[B, C, ...]``."""
    b, c, h, w = x.shape
    flat = x.reshape(b, c, h * w)
    y0, x0 = torch.floor(yy), torch.floor(xx)
    wy, wx = yy - y0, xx - x0
    out = 0.0
    for dy, sy in ((0, 1 - wy), (1, wy)):
        for dx, sx in ((0, 1 - wx), (1, wx)):
            yi, xi = (y0 + dy).long(), (x0 + dx).long()
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            pos = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(
                b, 1, -1)
            v = flat.gather(2, pos.expand(b, c, pos.shape[-1])).reshape(
                (b, c) + tuple(yy.shape[1:]))
            out = out + v * (sy * sx * valid.to(x.dtype))[:, None]
    return out


def deformable_conv(x: torch.Tensor, offset: torch.Tensor,
                    weight: torch.Tensor, mask=None, bias=None, stride=1,
                    padding=0, dilation=1, groups: int = 1,
                    deformable_groups: int = 1) -> torch.Tensor:
    """Deformable convolution, v1, or v2 with ``mask``: ``x [N, C, H,
    W]``, ``offset [N, 2 dg kh kw, Ho, Wo]`` ((y, x) per kernel point),
    ``mask [N, dg kh kw, Ho, Wo]``; each tap bilinear sampled at its
    offset position, then one contraction with ``weight``."""
    n, c, h, w = x.shape
    oc, icg, kh, kw = weight.shape
    stride, dilation = _pair(stride), _pair(dilation)
    pad = _pads(padding, (h, w), (kh, kw), stride, dilation)
    ho = (h + pad[0][0] + pad[0][1] - (kh - 1) * dilation[0] - 1) \
        // stride[0] + 1
    wo = (w + pad[1][0] + pad[1][1] - (kw - 1) * dilation[1] - 1) \
        // stride[1] + 1
    dg, kk = deformable_groups, kh * kw
    dev = x.device
    off = offset.reshape(n, dg, kk, 2, ho, wo)
    base_y = (torch.arange(ho, device=dev) * stride[0] - pad[0][0])[:, None]
    base_x = (torch.arange(wo, device=dev) * stride[1] - pad[1][0])[None, :]
    ky, kx = torch.meshgrid(torch.arange(kh, device=dev) * dilation[0],
                            torch.arange(kw, device=dev) * dilation[1],
                            indexing="ij")
    ky, kx = ky.reshape(-1), kx.reshape(-1)
    # [N, dg, kk, Ho, Wo] sample positions
    yy = base_y + ky[:, None, None] + off[:, :, :, 0]
    xx = base_x + kx[:, None, None] + off[:, :, :, 1]
    cg = c // dg
    samp = _bilinear_gather(x.reshape(n * dg, cg, h, w),
                            yy.reshape(n * dg, kk, ho, wo),
                            xx.reshape(n * dg, kk, ho, wo))
    samp = samp.reshape(n, dg, cg, kk, ho, wo)
    if mask is not None:
        samp = samp * mask.reshape(n, dg, 1, kk, ho, wo)
    cols = samp.reshape(n, groups, c // groups, kk, ho, wo)
    wg = weight.reshape(groups, oc // groups, icg, kk)
    out = torch.einsum("ngckhw,gock->ngohw", cols, wg).reshape(n, oc, ho, wo)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def row_conv(x: torch.Tensor, weight: torch.Tensor,
             length=None) -> torch.Tensor:
    """Lookahead convolution: ``out[t] = sum_i w[i] x[t + i]`` over ``x [B,
    T, D]``, ``weight [k, D]``; zero past each length."""
    k, t = weight.shape[0], x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, 0, k - 1))
    out = sum(pad[:, i:i + t] * weight[i][None, None] for i in range(k))
    if length is not None:
        m = torch.arange(t, device=x.device)[None, :] \
            < torch.as_tensor(length, device=x.device).reshape(-1, 1)
        out = out * m[:, :, None].to(out.dtype)
    return out


def var_conv_2d(x: torch.Tensor, row_length, col_length,
                weight: torch.Tensor, out_channels: int,
                stride=1) -> torch.Tensor:
    """A convolution over per-example (H_i, W_i) images stored padded:
    positions past each extent zeroed before and after ("same" padding
    of half the kernel)."""
    n, c, h, w = x.shape
    if weight.shape[0] != out_channels:
        raise ValueError(
            f"var_conv_2d: weight has {weight.shape[0]} output "
            f"channels, expected out_channels={out_channels}")
    dev = x.device
    rl = torch.as_tensor(row_length, device=dev).reshape(-1, 1)
    cl = torch.as_tensor(col_length, device=dev).reshape(-1, 1)
    rm = torch.arange(h, device=dev)[None, :] < rl
    cm = torch.arange(w, device=dev)[None, :] < cl
    m = (rm[:, None, :, None] & cm[:, None, None, :]).to(x.dtype)
    out = conv2d(x * m, weight, stride=stride,
                 padding=(weight.shape[2] // 2, weight.shape[3] // 2))
    oh, ow = out.shape[2], out.shape[3]
    s = _pair(stride)
    rom = torch.arange(oh, device=dev)[None, :] < (rl + s[0] - 1) // s[0]
    com = torch.arange(ow, device=dev)[None, :] < (cl + s[1] - 1) // s[1]
    return out * (rom[:, None, :, None] & com[:, None, None, :]).to(
        out.dtype)


def tree_conv(nodes: torch.Tensor, edges: torch.Tensor,
              weight: torch.Tensor,
              max_depth: Optional[int] = None) -> torch.Tensor:
    """Tree-based convolution over depth-1 patches: ``nodes [B, N, D]``,
    ``edges [B, E, 2]`` (parent, child; -1 padded), ``weight [D, 3,
    out]``; each child weighted by its continuous binary-tree position
    among its siblings; ``tanh`` of the sum."""
    if max_depth is not None and max_depth > 2:
        raise NotImplementedError(
            "tree_conv: this implementation convolves depth-1 patches "
            "(each node with its direct children, the TBCNN default); "
            f"max_depth={max_depth} windows are not supported")
    n = nodes.shape[1]
    edges = torch.as_tensor(edges, device=nodes.device).long()
    parent, child = edges[..., 0], edges[..., 1]
    valid = (parent >= 0) & (child >= 0)
    p = torch.where(valid, parent, torch.zeros_like(parent))
    ch = torch.where(valid, child, torch.zeros_like(child))
    onehot_p = (p[..., None] == torch.arange(n, device=nodes.device)).to(
        nodes.dtype) * valid[..., None].to(nodes.dtype)
    n_children = onehot_p.sum(1)                          # [B, N]
    order = torch.cumsum(onehot_p, 1)
    pos = torch.einsum("ben,ben->be", order, onehot_p)    # 1-based
    nc_e = n_children.gather(1, p)                        # [B, E]
    eta_r = torch.where(nc_e > 1, (pos - 1) / torch.clamp(nc_e - 1, min=1),
                        torch.full_like(pos, 0.5))
    eta_l = 1.0 - eta_r
    w_t, w_l, w_r = weight[:, 0], weight[:, 1], weight[:, 2]
    child_feat = nodes.gather(1, ch[..., None].expand(
        ch.shape + (nodes.shape[2],)))
    contrib = (torch.einsum("bed,do->beo", child_feat, w_l)
               * eta_l[..., None]
               + torch.einsum("bed,do->beo", child_feat, w_r)
               * eta_r[..., None]) * valid[..., None]
    agg = torch.einsum("beo,ben->bno", contrib, onehot_p)
    return torch.tanh(torch.einsum("bnd,do->bno", nodes, w_t) + agg)


def spp(x: torch.Tensor, pyramid_height: int = 3,
        pool_type: str = "max") -> torch.Tensor:
    """Spatial pyramid pooling: adaptive pools to 1 x 1 ... 2^(L-1)
    squared bins, flattened and joined."""
    pool = adaptive_max_pool2d if pool_type == "max" \
        else adaptive_avg_pool2d
    return torch.cat([pool(x, (2 ** lv, 2 ** lv)).reshape(x.shape[0], -1)
                      for lv in range(pyramid_height)], 1)


def fsp_matrix(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``[B, C1, H, W] x [B, C2, H, W] -> [B, C1, C2] / (H W)``."""
    h, w = x.shape[2], x.shape[3]
    if (h, w) != tuple(y.shape[2:4]):
        raise ValueError(f"fsp_matrix spatial mismatch {(h, w)} vs "
                         f"{tuple(y.shape[2:4])}")
    return torch.einsum("bihw,bjhw->bij", x, y) / (h * w)


def partial_sum(inputs: Sequence, start_index: int = 0,
                length: int = -1) -> torch.Tensor:
    stop = None if length < 0 else start_index + length
    return sum(x[:, start_index:stop] for x in inputs)


def partial_concat(inputs: Sequence, start_index: int = 0,
                   length: int = -1) -> torch.Tensor:
    stop = None if length < 0 else start_index + length
    return torch.cat([x[:, start_index:stop] for x in inputs], 1)


def batch_fc(x: torch.Tensor, weight: torch.Tensor,
             bias=None) -> torch.Tensor:
    """Per-slot FC: ``x [S, B, Din]``, ``weight [S, Din, Dout]``, ``bias
    [S, Dout]``."""
    out = torch.einsum("sbi,sio->sbo", x, weight)
    if bias is not None:
        out = out + bias[:, None, :]
    return out


def rank_attention(x: torch.Tensor, rank_offset, rank_param: torch.Tensor,
                   max_rank: int) -> torch.Tensor:
    """``x [B, D]`` through the mean of the ``rank_param`` blocks (``[max
    rank^2, D, out]``: block (i, j) for an instance of rank i + 1 against
    a candidate of rank j + 1) over its present candidates; ``rank_offset
    [B, 2 max_rank + 1]``: column 0 the instance's rank (1-based, 0
    missing), column 2k + 1 candidate k's. A row with none gives 0."""
    d, out_dim = x.shape[1], rank_param.shape[-1]
    blocks = rank_param.reshape(max_rank, max_rank, d, out_dim)
    ro = torch.as_tensor(rank_offset, device=x.device).long()
    ins_rank = ro[:, 0]
    cand_rank = ro[:, 1::2][:, :max_rank]
    present = (cand_rank > 0) & (ins_rank > 0)[:, None]
    row = torch.clamp(ins_rank - 1, 0, max_rank - 1)
    col = torch.clamp(cand_rank - 1, 0, max_rank - 1)
    sel = blocks[row[:, None], col]                       # [B, R, D, out]
    wts = present.to(x.dtype)
    denom = torch.clamp(wts.sum(1), min=1.0)
    avg = torch.einsum("brdo,br->bdo", sel, wts) / denom[:, None, None]
    return torch.einsum("bd,bdo->bo", x, avg)


def cvm(x: torch.Tensor, use_cvm: bool = True) -> torch.Tensor:
    """Columns 0/1 (show/click counts) as ``log(show + 1)`` and
    ``log(click + 1) - log(show + 1)``, or dropped."""
    show = torch.log(x[:, 0:1] + 1.0)
    ctr = torch.log(x[:, 1:2] + 1.0) - torch.log(x[:, 0:1] + 1.0)
    if use_cvm:
        return torch.cat([show, ctr, x[:, 2:]], 1)
    return x[:, 2:]


def match_matrix_tensor(x: torch.Tensor, x_len, y: torch.Tensor, y_len,
                        weight: torch.Tensor) -> torch.Tensor:
    """``x [B, Tx, D]``, ``y [B, Ty, D]``, ``weight [D, dim_t, D]`` ->
    ``[B, dim_t, Tx, Ty]``, zero past the lengths."""
    out = torch.einsum("bxd,dte,bye->btxy", x, weight, y)
    dev = x.device
    mx = torch.arange(x.shape[1], device=dev)[None, :] \
        < torch.as_tensor(x_len, device=dev).reshape(-1, 1)
    my = torch.arange(y.shape[1], device=dev)[None, :] \
        < torch.as_tensor(y_len, device=dev).reshape(-1, 1)
    return out * (mx[:, None, :, None] & my[:, None, None, :]).to(out.dtype)


def pyramid_hash(ids: torch.Tensor, length, embedding: torch.Tensor,
                 num_buckets: int, min_win: int = 2, max_win: int = 4,
                 mul: int = 0x9E3779B1) -> torch.Tensor:
    """Hashed n-gram pyramid embedding: every window of ``min_win`` to
    ``max_win`` ids inside its sequence hashed (uint32 ``h * mul + id``)
    into ``embedding [num_buckets, D]``, summed per sequence ``[B, D]``."""
    b, t = ids.shape
    dev = ids.device
    mask = torch.arange(t, device=dev)[None, :] \
        < torch.as_tensor(length, device=dev).reshape(-1, 1)
    total = torch.zeros((b, embedding.shape[1]), dtype=embedding.dtype,
                        device=embedding.device)
    # uint32 arithmetic in int64, wrapped after every step
    ids32 = ids.long() & 0xFFFFFFFF
    for win in range(min_win, max_win + 1):
        if win > t:
            break
        h = torch.zeros((b, t - win + 1), dtype=torch.int64, device=dev)
        for i in range(win):
            h = (h * mul + ids32[:, i:t - win + 1 + i]) & 0xFFFFFFFF
        idx = h % num_buckets
        gram_valid = mask[:, win - 1:]
        total = total + (embedding[idx] * gram_valid[..., None].to(
            embedding.dtype)).sum(1)
    return total
