"""The detection ops.

Counterpart of ``paddle_tpu.ops.detection`` (the reference's
``operators/detection/`` family), with the JAX module's names, static
shapes and results:

- NMS returns ``max_out`` slots, -1 padded, with a validity mask: the
  JAX ``fori_loop`` of ``max_out`` argmax steps (the lowest index on a
  tie; once no box is live every later slot is empty, so the loop stops
  there, on a host read every ``_NMS_CHECK`` steps). ``multiclass_nms``
  runs every class's loop as one batched tensor loop (and
  ``layers.detection_output`` every image's too), then takes
  ``lax.top_k``'s order over the flat ``[C * per_class]`` scores
  (``ops.search.topk``: total order, ties to the lower index).
- The ``vmap``s over ROIs and images are batched tensor ops; a gather
  that the JAX code writes as ``feat[:, y, x]`` is one ``gather`` over
  the flattened map.
- A scatter whose indices repeat (each ground truth claiming its best
  prior) keeps the last write, as XLA's sequential scatter on the CPU.
- The sampled assignments (``use_random=True``) draw from a ``key``: a
  ``torch.Generator`` or an int seed (the ``random`` stream without
  one); those draws cannot be JAX's, and ``use_random=False`` is exact.
- Creation ops (``prior_box``, ``density_prior_box``,
  ``anchor_generator``) take ``device`` (None: the card).

Boxes are ``[x1, y1, x2, y2]`` unless noted.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..core.place import resolve_device

__all__ = [
    "iou_similarity", "box_area", "box_coder", "box_clip", "prior_box",
    "density_prior_box", "anchor_generator", "yolo_box", "nms",
    "multiclass_nms", "roi_align", "roi_pool", "bipartite_match",
    "distribute_fpn_proposals", "generate_proposals",
]

_INF = float("inf")
# NMS reads whether any box is still live every this many steps
_NMS_CHECK = 8


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of ``[..., 4]`` boxes."""
    return torch.clamp(boxes[..., 2] - boxes[..., 0], min=0) * \
        torch.clamp(boxes[..., 3] - boxes[..., 1], min=0)


def _iou(x: torch.Tensor, y: torch.Tensor, off: float) -> torch.Tensor:
    """Pairwise IoU ``[..., N, M]`` of ``x [..., N, 4]`` and ``y [..., M,
    4]``, ``off`` added to each width and height."""
    x, y = _f32(x), _f32(y)
    lt = torch.maximum(x[..., :, None, :2], y[..., None, :, :2])
    rb = torch.minimum(x[..., :, None, 2:4], y[..., None, :, 2:4])
    wh = torch.clamp(rb - lt + off, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_x = (x[..., 2] - x[..., 0] + off) * (x[..., 3] - x[..., 1] + off)
    area_y = (y[..., 2] - y[..., 0] + off) * (y[..., 3] - y[..., 1] + off)
    union = area_x[..., :, None] + area_y[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def iou_similarity(x: torch.Tensor, y: torch.Tensor,
                   box_normalized: bool = True) -> torch.Tensor:
    """Pairwise IoU ``[N, M]``; unnormalised boxes add 1 to widths and
    heights."""
    return _iou(x, y, 0.0 if box_normalized else 1.0)


def box_coder(prior_box, prior_box_var, target_box,
              code_type: str = "encode_center_size",
              box_normalized: bool = True) -> torch.Tensor:
    """Encode ``target [M, 4]`` boxes against N priors into ``[M, N, 4]``
    offsets, or decode ``target [M, N, 4]`` (or ``[M, 4]``) offsets into
    boxes."""
    off = 0.0 if box_normalized else 1.0
    pb = _f32(prior_box)
    pw = pb[:, 2] - pb[:, 0] + off
    ph = pb[:, 3] - pb[:, 1] + off
    pcx = pb[:, 0] + 0.5 * pw
    pcy = pb[:, 1] + 0.5 * ph
    if prior_box_var is None:
        var = torch.ones((pb.shape[0], 4), device=pb.device)
    elif torch.as_tensor(prior_box_var).ndim == 1:
        var = _f32(prior_box_var).to(pb.device).expand(pb.shape[0], 4)
    else:
        var = _f32(prior_box_var)
    t = _f32(target_box)
    if code_type == "encode_center_size":
        tw = t[:, 2] - t[:, 0] + off
        th = t[:, 3] - t[:, 1] + off
        tcx = t[:, 0] + 0.5 * tw
        tcy = t[:, 1] + 0.5 * th
        dx = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        dy = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        dw = torch.log(torch.clamp(tw[:, None] / pw[None, :], min=1e-10))
        dh = torch.log(torch.clamp(th[:, None] / ph[None, :], min=1e-10))
        return torch.stack([dx, dy, dw, dh], -1) / var[None, :, :]
    if code_type == "decode_center_size":
        if t.ndim == 2:
            t = t[:, None, :]
        d = t * var[None, :, :]
        cx = d[..., 0] * pw[None, :] + pcx[None, :]
        cy = d[..., 1] * ph[None, :] + pcy[None, :]
        w = torch.exp(d[..., 2]) * pw[None, :]
        h = torch.exp(d[..., 3]) * ph[None, :]
        out = torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                           cx + 0.5 * w - off, cy + 0.5 * h - off], -1)
        if torch.as_tensor(target_box).ndim == 2 and out.shape[1] == 1:
            return out[:, 0]
        return out
    raise ValueError(f"unknown code_type {code_type!r}")


def box_clip(boxes: torch.Tensor, im_shape) -> torch.Tensor:
    """Boxes clipped into an image of ``im_shape`` (H, W)."""
    h, w = im_shape[0], im_shape[1]
    return torch.stack([torch.clamp(boxes[..., 0], 0, w - 1),
                        torch.clamp(boxes[..., 1], 0, h - 1),
                        torch.clamp(boxes[..., 2], 0, w - 1),
                        torch.clamp(boxes[..., 3], 0, h - 1)], -1)


def _grid_boxes(fh: int, fw: int, step_w: float, step_h: float,
                offset: float, device) -> tuple:
    cx = (torch.arange(fw, dtype=torch.float32, device=device) + offset) \
        * step_w
    cy = (torch.arange(fh, dtype=torch.float32, device=device) + offset) \
        * step_h
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    return cxg, cyg


def prior_box(input_hw: Tuple[int, int], image_hw: Tuple[int, int],
              min_sizes: Sequence[float],
              max_sizes: Sequence[float] = (),
              aspect_ratios: Sequence[float] = (1.0,),
              variance: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
              flip: bool = False, clip: bool = False,
              step: Tuple[float, float] = (0.0, 0.0),
              offset: float = 0.5, min_max_aspect_ratios_order=False,
              device=None) -> tuple:
    """SSD prior boxes ``(boxes [H, W, A, 4], variances [H, W, A, 4])``,
    normalised to [0, 1]; the sizes are the JAX function's, in its
    order."""
    dev = resolve_device(device)
    fh, fw = input_hw
    ih, iw = image_hw
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - a) < 1e-6 for a in ars):
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
    step_w = step[0] if step[0] > 0 else iw / fw
    step_h = step[1] if step[1] > 0 else ih / fh
    widths, heights = [], []
    for ms in min_sizes:
        big = (ms * max_sizes[list(min_sizes).index(ms)]) ** 0.5 \
            if max_sizes else None
        if min_max_aspect_ratios_order:
            widths.append(ms)
            heights.append(ms)
            if big is not None:
                widths.append(big)
                heights.append(big)
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                widths.append(ms * ar ** 0.5)
                heights.append(ms / ar ** 0.5)
        else:
            for ar in ars:
                widths.append(ms * ar ** 0.5)
                heights.append(ms / ar ** 0.5)
            if big is not None:
                widths.append(big)
                heights.append(big)
    w = torch.tensor(widths, dtype=torch.float32, device=dev) / iw
    h = torch.tensor(heights, dtype=torch.float32, device=dev) / ih
    cx = (torch.arange(fw, dtype=torch.float32, device=dev) + offset) \
        * step_w / iw
    cy = (torch.arange(fh, dtype=torch.float32, device=dev) + offset) \
        * step_h / ih
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    boxes = torch.stack([cxg[..., None] - 0.5 * w, cyg[..., None] - 0.5 * h,
                         cxg[..., None] + 0.5 * w,
                         cyg[..., None] + 0.5 * h], -1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = torch.tensor(variance, dtype=torch.float32,
                       device=dev).expand(boxes.shape)
    return boxes, var


def density_prior_box(input_hw, image_hw, fixed_sizes, fixed_ratios,
                      densities, variance=(0.1, 0.1, 0.2, 0.2),
                      clip: bool = False, step=(0.0, 0.0),
                      offset: float = 0.5, device=None) -> tuple:
    """Density prior boxes ``(boxes [H, W, A, 4], variances)``."""
    dev = resolve_device(device)
    fh, fw = input_hw
    ih, iw = image_hw
    step_w = step[0] if step[0] > 0 else iw / fw
    step_h = step[1] if step[1] > 0 else ih / fh
    ws, hs, sxs, sys_ = [], [], [], []
    for size, density in zip(fixed_sizes, densities):
        for ratio in fixed_ratios:
            bw, bh = size * ratio ** 0.5, size / ratio ** 0.5
            shift = size / density
            for di in range(density):
                for dj in range(density):
                    ws.append(bw)
                    hs.append(bh)
                    sxs.append(-size / 2.0 + shift / 2.0 + dj * shift)
                    sys_.append(-size / 2.0 + shift / 2.0 + di * shift)

    def t(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    w, h, sx, sy = t(ws), t(hs), t(sxs), t(sys_)
    cxg, cyg = _grid_boxes(fh, fw, step_w, step_h, offset, dev)
    ccx = cxg[..., None] + sx
    ccy = cyg[..., None] + sy
    boxes = torch.stack([(ccx - 0.5 * w) / iw, (ccy - 0.5 * h) / ih,
                         (ccx + 0.5 * w) / iw, (ccy + 0.5 * h) / ih], -1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return boxes, t(variance).expand(boxes.shape)


def anchor_generator(input_hw, anchor_sizes, aspect_ratios, stride,
                     variance=(0.1, 0.1, 0.2, 0.2), offset: float = 0.5,
                     device=None) -> tuple:
    """RPN anchors in image coordinates ``(anchors [H, W, A, 4],
    variances)``."""
    dev = resolve_device(device)
    fh, fw = input_hw
    ws, hs = [], []
    for ar in aspect_ratios:
        for s in anchor_sizes:
            w = (s * s / ar) ** 0.5
            ws.append(w)
            hs.append(w * ar)
    w = torch.tensor(ws, dtype=torch.float32, device=dev)
    h = torch.tensor(hs, dtype=torch.float32, device=dev)
    cxg, cyg = _grid_boxes(fh, fw, stride[0], stride[1], offset, dev)
    anchors = torch.stack([cxg[..., None] - 0.5 * w, cyg[..., None] - 0.5 * h,
                           cxg[..., None] + 0.5 * w,
                           cyg[..., None] + 0.5 * h], -1)
    var = torch.tensor(variance, dtype=torch.float32,
                       device=dev).expand(anchors.shape)
    return anchors, var


def yolo_box(x: torch.Tensor, img_size: torch.Tensor, anchors: Sequence[int],
             class_num: int, conf_thresh: float, downsample_ratio: int,
             clip_bbox: bool = True, scale_x_y: float = 1.0) -> tuple:
    """Decodes a YOLOv3 head ``x [N, A * (5 + C), H, W]`` into ``(boxes [N,
    A H W, 4], scores [N, A H W, C])`` in the pixels of ``img_size [N,
    2]`` (h, w); a cell below ``conf_thresh`` gives zeros."""
    n, _, h, w = x.shape
    na = len(anchors) // 2
    an = torch.tensor(anchors, dtype=torch.float32,
                      device=x.device).reshape(na, 2)
    x = x.reshape(n, na, 5 + class_num, h, w)
    grid_x = torch.arange(w, dtype=torch.float32, device=x.device)
    grid_y = torch.arange(h, dtype=torch.float32, device=x.device)
    alpha, beta = scale_x_y, -0.5 * (scale_x_y - 1.0)
    bx = (torch.sigmoid(x[:, :, 0]) * alpha + beta
          + grid_x[None, None, None, :]) / w
    by = (torch.sigmoid(x[:, :, 1]) * alpha + beta
          + grid_y[None, None, :, None]) / h
    bw = torch.exp(x[:, :, 2]) * an[None, :, 0, None, None] \
        / (downsample_ratio * w)
    bh = torch.exp(x[:, :, 3]) * an[None, :, 1, None, None] \
        / (downsample_ratio * h)
    conf = torch.sigmoid(x[:, :, 4])
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    mask = (conf >= conf_thresh).to(x.dtype)
    img_h = _f32(img_size[:, 0])[:, None, None, None]
    img_w = _f32(img_size[:, 1])[:, None, None, None]
    x1, y1 = (bx - bw / 2) * img_w, (by - bh / 2) * img_h
    x2, y2 = (bx + bw / 2) * img_w, (by + bh / 2) * img_h
    if clip_bbox:
        x1 = torch.minimum(torch.clamp(x1, min=0), img_w - 1)
        y1 = torch.minimum(torch.clamp(y1, min=0), img_h - 1)
        x2 = torch.minimum(torch.clamp(x2, min=0), img_w - 1)
        y2 = torch.minimum(torch.clamp(y2, min=0), img_h - 1)
    boxes = torch.stack([x1, y1, x2, y2], -1) * mask[..., None]
    boxes = boxes.permute(0, 1, 3, 4, 2).reshape(n, na * h * w, 4)
    scores = (probs * mask[:, :, None]).permute(0, 1, 3, 4, 2) \
        .reshape(n, na * h * w, class_num)
    return boxes, scores


def _nms_loop(iou: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
              score_threshold: float, max_out: int) -> tuple:
    """Hard NMS of each row of ``scores [..., N]`` over ``iou`` (broadcast
    to ``[..., N, N]``): ``(indices [..., max_out] int64, -1 padded,
    valid [..., max_out])`` (see the module note)."""
    n = scores.shape[-1]
    lead = tuple(scores.shape[:-1])
    iou = iou.expand(lead + (n, n))
    live = scores > score_threshold
    sel_idx = torch.full(lead + (max_out,), -1, dtype=torch.int64,
                         device=scores.device)
    sel_valid = torch.zeros(lead + (max_out,), dtype=torch.bool,
                            device=scores.device)
    cols = torch.arange(n, device=scores.device)
    neg = torch.full_like(scores, -_INF)
    for it in range(max_out):
        if it % _NMS_CHECK == 0 and not bool(live.any()):
            break
        masked = torch.where(live, scores, neg)
        best = masked.argmax(-1)
        ok = masked.gather(-1, best[..., None])[..., 0] > -_INF
        sel_idx[..., it] = torch.where(ok, best, torch.full_like(best, -1))
        sel_valid[..., it] = ok
        row = iou.gather(-2, best[..., None, None].expand(
            lead + (1, n)))[..., 0, :]
        live = live & (row < iou_threshold) & (cols != best[..., None]) \
            & ok[..., None]
    return sel_idx, sel_valid


def nms(boxes: torch.Tensor, scores: torch.Tensor,
        iou_threshold: float = 0.3, score_threshold: float = -_INF,
        max_out: int = 100) -> tuple:
    """Hard NMS with static output: ``(indices [max_out], valid
    [max_out])``, indices into ``boxes [N, 4]``, -1 padded."""
    return _nms_loop(iou_similarity(boxes, boxes), scores, iou_threshold,
                     score_threshold, max_out)


def _multiclass_nms(bboxes: torch.Tensor, scores: torch.Tensor,
                    score_threshold: float, nms_threshold: float,
                    keep_top_k: int, nms_top_k: int,
                    background_label: int) -> tuple:
    """:func:`multiclass_nms` of each image: ``bboxes [B, N, 4]``, ``scores
    [B, C, N]`` -> ``(out [B, k, 6], valid [B, k])``."""
    from .search import topk
    b, c, n = scores.shape
    per_class = min(nms_top_k, n) if nms_top_k > 0 else n
    idx, valid = _nms_loop(iou_similarity(bboxes, bboxes)[:, None], scores,
                           nms_threshold, score_threshold, per_class)
    sc = torch.where(valid, scores.gather(-1, idx.clamp(min=0)),
                     torch.full(idx.shape, -_INF, device=scores.device))
    labels = torch.arange(c, device=scores.device)[None, :, None] \
        .expand(b, c, per_class)
    if background_label >= 0:
        sc = torch.where(labels == background_label,
                         torch.full_like(sc, -_INF), sc)
    flat_sc, flat_idx = sc.reshape(b, -1), idx.reshape(b, -1)
    k = min(keep_top_k, flat_sc.shape[1])
    top_sc, top_pos = topk(flat_sc, k)
    box_i = flat_idx.gather(1, top_pos).clamp(min=0)
    top_box = bboxes.gather(1, box_i[..., None].expand(b, k, 4))
    top_lab = labels.reshape(b, -1).gather(1, top_pos)
    ok = top_sc > -_INF
    out = torch.cat([top_lab[..., None].to(torch.float32),
                     torch.where(ok, top_sc, torch.zeros_like(top_sc))[
                         ..., None],
                     top_box * ok[..., None]], -1)
    return out, ok


def multiclass_nms(bboxes: torch.Tensor, scores: torch.Tensor,
                   score_threshold: float = 0.05,
                   nms_threshold: float = 0.3, keep_top_k: int = 100,
                   nms_top_k: int = 400, background_label: int = -1
                   ) -> tuple:
    """Per-class NMS, then the global top ``keep_top_k``: ``bboxes [N, 4]``
    shared across classes, ``scores [C, N]`` -> ``(out [keep_top_k, 6]``
    rows ``[label, score, x1, y1, x2, y2]``, ``valid)``."""
    out, valid = _multiclass_nms(
        _f32(bboxes)[None], scores[None], score_threshold, nms_threshold,
        keep_top_k, nms_top_k, background_label)
    return out[0], valid[0]


def _bilinear_sample(feat: torch.Tensor, y: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """``feat [C, H, W]`` (or ``[R, C, H, W]`` with ``y``/``x`` ``[R,
    ...]``) sampled at fractional ``(y, x)``: the four corners clamped
    into the map, the sample zero where ``y`` or ``x`` lies more than one
    cell outside -> ``[C, ...]`` (``[R, C, ...]``)."""
    single = feat.ndim == 3
    if single:
        feat, y, x = feat[None], y[None], x[None]
    y, x = torch.broadcast_tensors(y, x)
    r, c, h, w = feat.shape
    flat = feat.reshape(r, c, h * w)
    y0, x0 = torch.floor(y), torch.floor(x)
    ly, lx = y - y0, x - x0
    hy, hx = 1 - ly, 1 - lx

    def at(yy, xx):
        yi = torch.clamp(yy, 0, h - 1).long()
        xi = torch.clamp(xx, 0, w - 1).long()
        pos = (yi * w + xi).reshape(r, 1, -1)
        v = flat.gather(2, pos.expand(r, c, pos.shape[-1])) \
            .reshape((r, c) + tuple(yy.shape[1:]))
        inb = (yy >= -1) & (yy <= h) & (xx >= -1) & (xx <= w)
        return v * inb[:, None].to(feat.dtype)

    out = (at(y0, x0) * (hy * hx)[:, None]
           + at(y0, x0 + 1) * (hy * lx)[:, None]
           + at(y0 + 1, x0) * (ly * hx)[:, None]
           + at(y0 + 1, x0 + 1) * (ly * lx)[:, None])
    return out[0] if single else out


def _batch_idx(roi_batch_indices, r: int, device) -> torch.Tensor:
    if roi_batch_indices is None:
        return torch.zeros(r, dtype=torch.long, device=device)
    return torch.as_tensor(roi_batch_indices, device=device).long()


def _bin_grid(y1, x1, bin_h, bin_w, ph: int, pw: int, sr: int) -> tuple:
    """The ``sr x sr`` sample points of each bin, ``[R, ph, pw, sr, sr]``
    each for y and x."""
    dev = y1.device
    frac = (torch.arange(sr, dtype=torch.float32, device=dev) + 0.5) / sr
    gy = y1[:, None, None] \
        + torch.arange(ph, dtype=torch.float32, device=dev)[None, :, None] \
        * bin_h[:, None, None] + frac[None, None, :] * bin_h[:, None, None]
    gx = x1[:, None, None] \
        + torch.arange(pw, dtype=torch.float32, device=dev)[None, :, None] \
        * bin_w[:, None, None] + frac[None, None, :] * bin_w[:, None, None]
    r = y1.shape[0]
    return (gy[:, :, None, :, None].expand(r, ph, pw, sr, sr),
            gx[:, None, :, None, :].expand(r, ph, pw, sr, sr))


def roi_align(feat: torch.Tensor, rois: torch.Tensor,
              output_size: Tuple[int, int], spatial_scale: float = 1.0,
              sampling_ratio: int = -1, roi_batch_indices=None,
              aligned: bool = False) -> torch.Tensor:
    """ROI Align: each bin of each ROI the mean of ``sampling_ratio``
    squared bilinear samples (2 when not positive). ``feat [B, C, H,
    W]``, ``rois [R, 4]`` -> ``[R, C, ph, pw]``."""
    ph, pw = output_size
    sr = sampling_ratio if sampling_ratio > 0 else 2
    half = 0.5 if aligned else 0.0
    box = _f32(rois) * spatial_scale - half
    x1, y1, x2, y2 = box.unbind(-1)
    floor = 1e-6 if aligned else 1.0
    rw = torch.clamp(x2 - x1, min=floor)
    rh = torch.clamp(y2 - y1, min=floor)
    yy, xx = _bin_grid(y1, x1, rh / ph, rw / pw, ph, pw, sr)
    idx = _batch_idx(roi_batch_indices, rois.shape[0], feat.device)
    return _bilinear_sample(feat[idx], yy, xx).mean((-2, -1))


def _bin_masks(rois, spatial_scale: float, ph: int, pw: int, h: int, w: int,
               extent: float, floor: float) -> tuple:
    """The row and column membership of each integer-rounded ROI's bins:
    ``ym [R, ph, H]``, ``xm [R, pw, W]`` (a bin spans ``floor(start)`` to
    ``ceil(end)``, clipped to the map)."""
    box = torch.round(_f32(rois) * spatial_scale)
    x1, y1, x2, y2 = box.unbind(-1)
    rw = torch.clamp(x2 - x1 + extent, min=floor)
    rh = torch.clamp(y2 - y1 + extent, min=floor)
    dev = box.device
    py = torch.arange(ph, dtype=torch.float32, device=dev)
    px = torch.arange(pw, dtype=torch.float32, device=dev)
    # an elementwise divisor: the card divides by a Python number as a
    # product with its reciprocal, one rounding more, and a bin edge
    # then lands on the other side of an integer (7 / 3 * 3)
    bh = (rh / torch.full_like(rh, ph))[:, None]
    bw = (rw / torch.full_like(rw, pw))[:, None]
    ys_lo = torch.clamp(torch.floor(y1[:, None] + py * bh), 0, h)
    ys_hi = torch.clamp(torch.ceil(y1[:, None] + (py + 1) * bh), 0, h)
    xs_lo = torch.clamp(torch.floor(x1[:, None] + px * bw), 0, w)
    xs_hi = torch.clamp(torch.ceil(x1[:, None] + (px + 1) * bw), 0, w)
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    ym = (ys >= ys_lo[..., None]) & (ys < ys_hi[..., None])
    xm = (xs >= xs_lo[..., None]) & (xs < xs_hi[..., None])
    return ym, xm


def roi_pool(feat: torch.Tensor, rois: torch.Tensor,
             output_size: Tuple[int, int], spatial_scale: float = 1.0,
             roi_batch_indices=None) -> torch.Tensor:
    """ROI max pooling over integer-rounded bins; an empty bin gives 0.
    ``[R, C, ph, pw]``."""
    ph, pw = output_size
    h, w = feat.shape[-2:]
    ym, xm = _bin_masks(rois, spatial_scale, ph, pw, h, w, 1.0, 1.0)
    f = feat[_batch_idx(roi_batch_indices, rois.shape[0], feat.device)]
    neg = torch.finfo(f.dtype).min
    # the masked max is separable: over each bin's columns, then its rows
    cols = torch.where(xm[:, None, None, :, :], f[:, :, :, None, :],
                       torch.full((), neg, dtype=f.dtype,
                                  device=f.device)).amax(-1)  # [R,C,H,pw]
    out = torch.where(ym[:, None, :, :, None], cols[:, :, None, :, :],
                      torch.full((), neg, dtype=f.dtype,
                                 device=f.device)).amax(-2)  # [R,C,ph,pw]
    empty = ~(ym.any(-1)[:, :, None] & xm.any(-1)[:, None, :])
    return torch.where(empty[:, None], torch.zeros_like(out), out)


def bipartite_match(dist_mat: torch.Tensor) -> tuple:
    """Greedy bipartite matching (the reference's max-first greedy):
    ``min(N, M)`` steps each taking the global maximum (the first in
    row-major order on a tie) while it is positive. ``(match_indices [M]``
    int64, -1 unmatched, ``match_dist [M])``."""
    n, m = dist_mat.shape
    dist = _f32(dist_mat).clone()
    idx = torch.full((m,), -1, dtype=torch.int64, device=dist.device)
    val = torch.zeros(m, dtype=dist_mat.dtype, device=dist.device)
    for _ in range(min(n, m)):
        flat = dist.reshape(-1).argmax()
        i, j = flat // m, flat % m
        best = dist[i, j]
        ok = best > 0
        idx[j] = torch.where(ok, i, idx[j])
        val[j] = torch.where(ok, best.to(val.dtype), val[j])
        row = torch.arange(n, device=dist.device) == i
        col = torch.arange(m, device=dist.device) == j
        dist = torch.where(ok & (row[:, None] | col[None, :]),
                           torch.full_like(dist, -1.0), dist)
    return idx, val


def distribute_fpn_proposals(rois: torch.Tensor, min_level: int,
                             max_level: int, refer_level: int,
                             refer_scale: float) -> torch.Tensor:
    """Each ROI's FPN level ``[R]`` int32 in ``[min_level, max_level]``."""
    scale = torch.sqrt(box_area(rois))
    # an elementwise divisor, as in _bin_masks: floor sees the quotient
    lvl = torch.floor(torch.log2(scale / torch.full_like(scale, refer_scale)
                                 + 1e-8)) + refer_level
    return torch.clamp(lvl, min_level, max_level).to(torch.int32)


def generate_proposals(scores, bbox_deltas, anchors, variances, im_shape,
                       pre_nms_top_n: int = 6000,
                       post_nms_top_n: int = 1000,
                       nms_thresh: float = 0.7,
                       min_size: float = 0.0) -> tuple:
    """RPN proposals of one image: ``(proposals [post_nms_top_n, 4],
    scores, valid)``."""
    from .search import topk
    k = min(pre_nms_top_n, scores.shape[0])
    top_sc, top_i = topk(scores, k)
    boxes = box_coder(anchors[top_i],
                      variances[top_i] if variances is not None else None,
                      bbox_deltas[top_i], code_type="decode_center_size",
                      box_normalized=False)
    if boxes.ndim == 3:
        ar = torch.arange(k, device=boxes.device)
        boxes = boxes[ar, ar]
    boxes = box_clip(boxes, im_shape)
    wh = torch.stack([boxes[:, 2] - boxes[:, 0] + 1,
                      boxes[:, 3] - boxes[:, 1] + 1], -1)
    keep = (wh >= min_size).all(-1)
    sc = torch.where(keep, top_sc, torch.full_like(top_sc, -_INF))
    idx, valid = nms(boxes, sc, nms_thresh, max_out=post_nms_top_n)
    safe = idx.clamp(min=0)
    return (boxes[safe] * valid[:, None],
            torch.where(valid, sc[safe], torch.zeros_like(sc[safe])), valid)


def psroi_pool(feat: torch.Tensor, rois: torch.Tensor,
               output_size: Tuple[int, int], output_channels: int,
               spatial_scale: float = 1.0,
               roi_batch_indices=None) -> torch.Tensor:
    """Position-sensitive ROI average pooling: bin (i, j) of output
    channel c averages input channel ``c ph pw + i pw + j`` over the bin.
    ``[R, output_channels, ph, pw]``."""
    ph, pw = output_size
    h, w = feat.shape[-2:]
    ym, xm = _bin_masks(rois, spatial_scale, ph, pw, h, w, 0.0, 0.1)
    f = feat[_batch_idx(roi_batch_indices, rois.shape[0], feat.device)]
    f = f.reshape(f.shape[0], output_channels, ph, pw, h, w)
    ymf, xmf = ym.to(f.dtype), xm.to(f.dtype)
    s = torch.einsum("rcijhw,rih,rjw->rcij", f, ymf, xmf)
    cnt = torch.clamp(ymf.sum(-1)[:, :, None] * xmf.sum(-1)[:, None, :],
                      min=1.0)
    return s / cnt[:, None]


def prroi_pool(feat: torch.Tensor, rois: torch.Tensor,
               output_size: Tuple[int, int], spatial_scale: float = 1.0,
               roi_batch_indices=None,
               samples_per_bin: int = 4) -> torch.Tensor:
    """Precise ROI pooling as ``samples_per_bin`` squared bilinear samples
    a bin (the JAX approximation of the exact integral)."""
    ph, pw = output_size
    x1, y1, x2, y2 = (_f32(rois) * spatial_scale).unbind(-1)
    rh = torch.clamp(y2 - y1, min=1e-6)
    rw = torch.clamp(x2 - x1, min=1e-6)
    yy, xx = _bin_grid(y1, x1, rh / ph, rw / pw, ph, pw, samples_per_bin)
    idx = _batch_idx(roi_batch_indices, rois.shape[0], feat.device)
    return _bilinear_sample(feat[idx], yy, xx).mean((-2, -1))


def roi_perspective_transform(feat: torch.Tensor, rois: torch.Tensor,
                              transformed_height: int,
                              transformed_width: int,
                              spatial_scale: float = 1.0,
                              roi_batch_indices=None) -> torch.Tensor:
    """Quadrilateral ROIs ``[R, 8]`` (x1..x4, y1..y4, clockwise from the
    top left) warped to ``[R, C, th, tw]`` through the homography of the
    unit square onto each quad, bilinear sampled."""
    th, tw = transformed_height, transformed_width
    q = _f32(rois)
    x, y = q[:, 0:4] * spatial_scale, q[:, 4:8] * spatial_scale
    dev = q.device
    sx = torch.tensor([0.0, 1.0, 1.0, 0.0], device=dev)
    sy = torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    sxx, syy = sx.expand_as(x), sy.expand_as(x)
    row_x = torch.stack([sxx, syy, one, zero, zero, zero, -sxx * x,
                         -syy * x], -1)
    row_y = torch.stack([zero, zero, zero, sxx, syy, one, -sxx * y,
                         -syy * y], -1)
    a = torch.stack([row_x, row_y], 2).reshape(-1, 8, 8)
    b = torch.stack([x, y], 2).reshape(-1, 8)
    c = torch.linalg.solve(a, b)  # [R, 8]
    u = (torch.arange(tw, dtype=torch.float32, device=dev) + 0.5) / tw
    v = (torch.arange(th, dtype=torch.float32, device=dev) + 0.5) / th
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    c = c[:, :, None, None]
    denom = c[:, 6] * uu + c[:, 7] * vv + 1.0
    xs = (c[:, 0] * uu + c[:, 1] * vv + c[:, 2]) / denom
    ys = (c[:, 3] * uu + c[:, 4] * vv + c[:, 5]) / denom
    idx = _batch_idx(roi_batch_indices, rois.shape[0], feat.device)
    return _bilinear_sample(feat[idx], ys, xs)


def _decay(iou: torch.Tensor, use_gaussian: bool, sigma: float):
    if use_gaussian:
        return torch.exp(-(iou ** 2) / sigma)
    return 1.0 - iou


def matrix_nms(bboxes: torch.Tensor, scores: torch.Tensor,
               score_threshold: float = 0.05, post_threshold: float = 0.0,
               nms_top_k: int = 100, keep_top_k: int = 100,
               use_gaussian: bool = False, gaussian_sigma: float = 2.0,
               normalized: bool = True, background_label: int = 0) -> tuple:
    """Matrix NMS (parallel soft suppression through the pairwise IoU):
    ``(out [keep_top_k, 6], valid)``."""
    from .search import topk
    c, n = scores.shape
    k = min(nms_top_k, n)
    parts = []
    rows = torch.arange(k, device=scores.device)
    upper_mask = rows[:, None] < rows[None, :]
    for ci in range(c):
        if ci == background_label:
            continue
        s, order = topk(scores[ci], k)
        b = bboxes[order]
        iou = iou_similarity(b, b, box_normalized=normalized)
        upper = torch.where(upper_mask, iou, torch.zeros_like(iou))
        compensate = upper.max(0).values
        num = _decay(upper, use_gaussian, gaussian_sigma)
        den = _decay(compensate, use_gaussian, gaussian_sigma)
        ratio = num / torch.clamp(den[:, None], min=1e-12)
        ratio = torch.where(upper_mask, ratio, torch.full_like(ratio, _INF))
        decay = torch.clamp(ratio.min(0).values, max=1.0)
        new_s = torch.where(s > score_threshold, s * decay,
                            torch.zeros_like(s))
        new_s = torch.where(new_s > post_threshold, new_s,
                            torch.zeros_like(new_s))
        parts.append(torch.cat([torch.full((k, 1), float(ci),
                                           device=scores.device),
                                new_s[:, None], b.to(torch.float32)], 1))
    if not parts:
        raise ValueError("matrix_nms: no foreground classes "
                         "(set background_label=-1 to score all)")
    per_class = torch.cat(parts, 0)
    top = min(keep_top_k, per_class.shape[0])
    best_s, best_i = topk(per_class[:, 1], top)
    out = per_class[best_i]
    if top < keep_top_k:
        out = torch.nn.functional.pad(out, (0, 0, 0, keep_top_k - top))
        best_s = torch.nn.functional.pad(best_s, (0, keep_top_k - top))
    return out, best_s > 0


def locality_aware_nms(boxes: torch.Tensor, scores: torch.Tensor,
                       iou_threshold: float = 0.3,
                       score_threshold: float = 0.0,
                       max_out: int = 100) -> tuple:
    """Consecutive overlapping boxes merged by score-weighted averaging
    (one pass in order), then hard NMS: ``(indices, valid, merged boxes
    [N + 1, 4], merged scores [N + 1])``."""
    cur_box = torch.zeros(4, dtype=boxes.dtype, device=boxes.device)
    cur_score = torch.tensor(-_INF, device=boxes.device)
    have = torch.tensor(False, device=boxes.device)
    out_boxes, out_scores = [], []
    for i in range(boxes.shape[0]):
        box, score = boxes[i], scores[i]
        iou = iou_similarity(cur_box[None], box[None])[0, 0]
        merge = have & (iou >= iou_threshold)
        emit = have & ~merge
        w1, w2 = cur_score, score
        merged = (cur_box * w1 + box * w2) / torch.clamp(w1 + w2, min=1e-12)
        out_boxes.append(torch.where(emit, cur_box, torch.zeros_like(box)))
        out_scores.append(torch.where(emit, cur_score,
                                      torch.full_like(cur_score, -_INF)))
        cur_box = torch.where(merge, merged, box)
        cur_score = torch.where(merge, w1 + w2, score.to(cur_score.dtype))
        have = torch.tensor(True, device=boxes.device)
    mboxes = torch.stack(out_boxes + [cur_box])
    mscores = torch.stack(out_scores + [cur_score])
    return nms(mboxes, mscores, iou_threshold, score_threshold, max_out) \
        + (mboxes, mscores)


def collect_fpn_proposals(multi_rois, multi_scores,
                          post_nms_top_n: int) -> tuple:
    """The levels' proposals joined and the top ``post_nms_top_n`` by
    score kept: ``(rois [N, 4], scores [N])``."""
    from .search import topk
    rois, scores = torch.cat(list(multi_rois)), torch.cat(list(multi_scores))
    top_s, top_i = topk(scores, min(post_nms_top_n, scores.shape[0]))
    return rois[top_i], top_s


def target_assign(x: torch.Tensor, match_indices, neg_indices=None,
                  mismatch_value=0.0) -> tuple:
    """Per-prior targets gathered by match index: ``(out [P, K], weight
    [P, 1])``; an unmatched prior gets ``mismatch_value`` and weight 0
    (1 where ``neg_indices`` names it)."""
    mi = torch.as_tensor(match_indices, device=x.device).long()
    matched = mi >= 0
    out = torch.where(matched[..., None], x[mi.clamp(min=0)],
                      torch.as_tensor(mismatch_value, dtype=x.dtype,
                                      device=x.device))
    w = matched.to(torch.float32)[..., None]
    if neg_indices is not None:
        neg = torch.zeros(mi.shape, dtype=torch.bool, device=x.device)
        neg[torch.as_tensor(neg_indices, device=x.device).long()] = True
        w = torch.maximum(w, neg.to(torch.float32)[..., None])
    return out, w


def _claim_best(iou: torch.Tensor, valid_gt: torch.Tensor, best_gt,
                fg) -> tuple:
    """Every valid ground truth claims the box of its largest IoU (the
    last claim on a box kept, as XLA's scatter). ``iou [..., G, N]``."""
    g, n = iou.shape[-2:]
    claims = valid_gt[..., None] & (
        iou.argmax(-1)[..., None] == torch.arange(n, device=iou.device))
    gid = torch.arange(g, device=iou.device)[:, None]
    last = torch.where(claims, gid, torch.full_like(gid, -1)).amax(-2)
    hit = last >= 0
    return torch.where(hit, last, best_gt), fg | hit


def ssd_loss(location, confidence, gt_box, gt_label, prior_boxes,
             prior_box_var=None, background_label: int = 0,
             overlap_threshold: float = 0.5, neg_pos_ratio: float = 3.0,
             loc_loss_weight: float = 1.0,
             conf_loss_weight: float = 1.0) -> torch.Tensor:
    """SSD multibox loss of each image ``[B]``: each prior matched to its
    best ground truth (IoU at least ``overlap_threshold``, and each valid
    ground truth's best prior), smooth-L1 on the matched priors' encoded
    offsets, softmax cross entropy on the positives and the
    ``neg_pos_ratio`` x positives hardest negatives (a stable sort of
    their losses), over the count of positives. ``location [B, P, 4]``,
    ``confidence [B, P, C]``, ``gt_box [B, G, 4]`` (0 padded), ``gt_label
    [B, G]`` (-1 padded), ``prior_boxes [P, 4]``."""
    from .loss import smooth_l1_loss
    b, p, _ = confidence.shape
    lbls = torch.as_tensor(gt_label, device=confidence.device).long()
    valid_gt = lbls >= 0
    iou = _iou(gt_box, prior_boxes, 0.0)                      # [B, G, P]
    iou = torch.where(valid_gt[..., None], iou, torch.full_like(iou, -1.0))
    best_gt, matched = _claim_best(iou, valid_gt, iou.argmax(-2),
                                   iou.amax(-2) >= overlap_threshold)
    mg = gt_box.gather(1, best_gt[..., None].expand(b, p, 4))  # [B, P, 4]
    pb = prior_boxes
    pw, ph = pb[:, 2] - pb[:, 0], pb[:, 3] - pb[:, 1]
    pcx, pcy = pb[:, 0] + 0.5 * pw, pb[:, 1] + 0.5 * ph
    gw, gh = mg[..., 2] - mg[..., 0], mg[..., 3] - mg[..., 1]
    var = prior_box_var if prior_box_var is not None \
        else torch.ones(4, dtype=location.dtype, device=location.device)
    pw9, ph9 = torch.clamp(pw, min=1e-9), torch.clamp(ph, min=1e-9)
    enc = torch.stack(
        [(mg[..., 0] + 0.5 * gw - pcx) / pw9 / var[0],
         (mg[..., 1] + 0.5 * gh - pcy) / ph9 / var[1],
         torch.log(torch.clamp(gw / pw9, min=1e-9)) / var[2],
         torch.log(torch.clamp(gh / ph9, min=1e-9)) / var[3]], -1)
    loc_l = smooth_l1_loss(location, enc, reduction="none").sum(-1)
    zero = torch.zeros_like(loc_l)
    loc_loss = torch.where(matched, loc_l, zero).sum(-1)
    tgt = torch.where(matched, lbls.gather(1, best_gt),
                      torch.full_like(best_gt, background_label))
    logp = torch.log_softmax(confidence, -1)
    conf_l = -logp.gather(-1, tgt[..., None])[..., 0]
    n_pos = matched.sum(-1)
    n_neg = torch.minimum((neg_pos_ratio * n_pos).to(torch.int32),
                          p - n_pos)
    neg_cand = torch.where(matched, torch.full_like(conf_l, -_INF), conf_l)
    order = torch.argsort(-neg_cand, dim=-1, stable=True)
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(p, device=order.device).expand(b, p))
    neg_sel = ~matched & (rank < n_neg[:, None])
    conf_loss = torch.where(matched | neg_sel, conf_l, zero).sum(-1)
    denom = torch.clamp(n_pos, min=1).to(location.dtype)
    return (loc_loss_weight * loc_loss
            + conf_loss_weight * conf_loss) / denom


def _iou_cxcywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax1, ay1 = a[..., 0] - a[..., 2] / 2, a[..., 1] - a[..., 3] / 2
    ax2, ay2 = a[..., 0] + a[..., 2] / 2, a[..., 1] + a[..., 3] / 2
    bx1, by1 = b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2
    bx2, by2 = b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                     min=0.0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                     min=0.0)
    inter = iw * ih
    ua = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
    return inter / torch.clamp(ua, min=1e-9)


def yolov3_loss(x: torch.Tensor, gt_box: torch.Tensor, gt_label,
                anchors: Sequence[int], anchor_mask: Sequence[int],
                class_num: int, ignore_thresh: float = 0.7,
                downsample_ratio: int = 32, gt_score=None,
                use_label_smooth: bool = False) -> torch.Tensor:
    """YOLOv3's loss of one head, each image ``[B]``: each ground truth
    (cx, cy, w, h in [0, 1]) trains the cell it falls in at its best
    anchor over all anchors, if that anchor is in ``anchor_mask``;
    objectness negatives whose prediction overlaps a ground truth above
    ``ignore_thresh`` are ignored."""
    b, _, h, w = x.shape
    m = len(anchor_mask)
    dev = x.device
    x = x.reshape(b, m, 5 + class_num, h, w)
    an_all = torch.tensor(anchors, dtype=torch.float32,
                          device=dev).reshape(-1, 2)
    input_size = downsample_ratio * h
    tx, ty, tw, th, tobj = (x[:, :, i] for i in range(5))
    tcls = x[:, :, 5:]
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    mask_an = an_all[torch.tensor(list(anchor_mask), device=dev)]
    px = (torch.sigmoid(tx) + gx) / w
    py = (torch.sigmoid(ty) + gy) / h
    pw = torch.exp(tw) * mask_an[None, :, 0, None, None] / input_size
    ph = torch.exp(th) * mask_an[None, :, 1, None, None] / input_size
    lbls_all = torch.as_tensor(gt_label, device=dev).long()
    gscore_all = _f32(gt_score).to(dev) if gt_score is not None \
        else torch.ones(lbls_all.shape, device=dev)
    out = []
    for bi in range(b):
        gts, lbls, gscore = gt_box[bi], lbls_all[bi], gscore_all[bi]
        valid = (gts[:, 2] > 0) & (gts[:, 3] > 0)
        p_boxes = torch.stack([px[bi], py[bi], pw[bi], ph[bi]],
                              -1).reshape(-1, 4)
        iou_pg = _iou_cxcywh(p_boxes[:, None, :], gts[None, :, :])
        iou_pg = torch.where(valid[None, :], iou_pg,
                             torch.zeros_like(iou_pg))
        ignore = (iou_pg.max(1).values > ignore_thresh).reshape(m, h, w)
        g_wh = gts[:, 2:4] * input_size
        inter = (torch.minimum(g_wh[:, None, 0], an_all[None, :, 0])
                 * torch.minimum(g_wh[:, None, 1], an_all[None, :, 1]))
        union = (g_wh[:, 0:1] * g_wh[:, 1:2]
                 + an_all[None, :, 0] * an_all[None, :, 1] - inter)
        best_anchor = (inter / torch.clamp(union, min=1e-9)).argmax(1)
        gi = torch.clamp((gts[:, 0] * w).to(torch.int32), 0, w - 1).long()
        gj = torch.clamp((gts[:, 1] * h).to(torch.int32), 0, h - 1).long()
        scale = 2.0 - gts[:, 2] * gts[:, 3]
        loss = torch.zeros((), device=dev)
        obj_target = torch.zeros(m * h * w, device=dev)
        for k, a in enumerate(anchor_mask):
            sel = valid & (best_anchor == a)
            sw = torch.where(sel, scale, torch.zeros_like(scale)) * gscore
            t_x = gts[:, 0] * w - gi
            t_y = gts[:, 1] * h - gj
            t_w = torch.log(torch.clamp(g_wh[:, 0] / an_all[a, 0], min=1e-9))
            t_h = torch.log(torch.clamp(g_wh[:, 1] / an_all[a, 1], min=1e-9))
            p_tx = torch.sigmoid(tx[bi, k, gj, gi])
            p_ty = torch.sigmoid(ty[bi, k, gj, gi])
            loss = loss + torch.sum(sw * ((p_tx - t_x) ** 2
                                          + (p_ty - t_y) ** 2))
            loss = loss + torch.sum(sw * ((tw[bi, k, gj, gi] - t_w) ** 2
                                          + (th[bi, k, gj, gi] - t_h) ** 2))
            logp = torch.log_softmax(tcls[bi, k][:, gj, gi].T, -1)
            onehot = (lbls[:, None] == torch.arange(class_num, device=dev)
                      ).to(logp.dtype)
            if use_label_smooth:
                delta = 1.0 / class_num
                onehot = onehot * (1 - delta) + delta / class_num
            loss = loss - torch.sum(sw[:, None] * onehot * logp)
            cell = k * h * w + gj * w + gi
            obj_target = obj_target.scatter_reduce(
                0, cell, sel.to(obj_target.dtype), "amax")
        # a cell is a positive exactly where its target is 1
        obj_target = obj_target.reshape(m, h, w)
        obj_pos = obj_target > 0
        obj_loss = -(obj_target * torch.nn.functional.logsigmoid(tobj[bi])
                     + torch.where(obj_pos | ignore,
                                   torch.zeros_like(obj_target),
                                   torch.nn.functional.logsigmoid(
                                       -tobj[bi])))
        out.append(loss + obj_loss.sum())
    return torch.stack(out)


def box_decoder_and_assign(prior_box, prior_box_var, target_box, box_score,
                           box_clip_val: float = 4.135) -> tuple:
    """Per-class deltas ``[N, C * 4]`` decoded (pixel boxes, log-sizes
    clipped at ``box_clip_val``), and each box's decode at its best class:
    ``(decoded [N, C * 4], assigned [N, 4])``."""
    n, c = box_score.shape
    deltas = target_box.reshape(n, c, 4)
    pw = prior_box[:, 2] - prior_box[:, 0] + 1.0
    ph = prior_box[:, 3] - prior_box[:, 1] + 1.0
    pcx, pcy = prior_box[:, 0] + 0.5 * pw, prior_box[:, 1] + 0.5 * ph
    var = prior_box_var if prior_box_var is not None \
        else torch.ones(4, device=target_box.device)
    dx, dy = deltas[..., 0] * var[0], deltas[..., 1] * var[1]
    dw = torch.clamp(deltas[..., 2] * var[2], -box_clip_val, box_clip_val)
    dh = torch.clamp(deltas[..., 3] * var[3], -box_clip_val, box_clip_val)
    cx, cy = pcx[:, None] + dx * pw[:, None], pcy[:, None] + dy * ph[:, None]
    w, h = torch.exp(dw) * pw[:, None], torch.exp(dh) * ph[:, None]
    decoded = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2 - 1,
                           cy + h / 2 - 1], -1)
    best = box_score.argmax(1)
    assigned = decoded[torch.arange(n, device=decoded.device), best]
    return decoded.reshape(n, c * 4), assigned


def polygon_box_transform(x: torch.Tensor) -> torch.Tensor:
    """EAST geometry: the 4x-subsampled cell coordinate minus each
    offset channel (even channels x, odd y)."""
    b, c, h, w = x.shape
    gy, gx = torch.meshgrid(torch.arange(h, dtype=x.dtype,
                                         device=x.device) * 4,
                            torch.arange(w, dtype=x.dtype,
                                         device=x.device) * 4,
                            indexing="ij")
    return torch.stack([gx, gy] * (c // 2))[None] - x


def _matched_box_encode(boxes, matched_gt, off: float = 0.0,
                        weights=None) -> torch.Tensor:
    """Centre-size encode of each box's matched ground truth (row i
    encodes ``(boxes[i], matched_gt[i])``)."""
    bw = torch.clamp(boxes[:, 2] - boxes[:, 0] + off, min=1e-9)
    bh = torch.clamp(boxes[:, 3] - boxes[:, 1] + off, min=1e-9)
    bcx, bcy = boxes[:, 0] + 0.5 * bw, boxes[:, 1] + 0.5 * bh
    gw = matched_gt[:, 2] - matched_gt[:, 0] + off
    gh = matched_gt[:, 3] - matched_gt[:, 1] + off
    gcx, gcy = matched_gt[:, 0] + 0.5 * gw, matched_gt[:, 1] + 0.5 * gh
    enc = torch.stack([(gcx - bcx) / bw, (gcy - bcy) / bh,
                       torch.log(torch.clamp(gw / bw, min=1e-9)),
                       torch.log(torch.clamp(gh / bh, min=1e-9))], 1)
    if weights is not None:
        enc = enc / torch.as_tensor(weights, dtype=enc.dtype,
                                    device=enc.device)
    return enc


def _matched_box_decode(boxes, deltas, off: float = 0.0) -> torch.Tensor:
    bw = boxes[:, 2] - boxes[:, 0] + off
    bh = boxes[:, 3] - boxes[:, 1] + off
    bcx, bcy = boxes[:, 0] + 0.5 * bw, boxes[:, 1] + 0.5 * bh
    cx, cy = deltas[:, 0] * bw + bcx, deltas[:, 1] * bh + bcy
    w = torch.exp(torch.clamp(deltas[:, 2], -10.0, 10.0)) * bw
    h = torch.exp(torch.clamp(deltas[:, 3], -10.0, 10.0)) * bh
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w - off,
                        cy + 0.5 * h - off], 1)


def _match_to_gt(gt_boxes, boxes, pos_thresh, box_normalized: bool,
                 valid_boxes=None) -> tuple:
    """Each box's best ground truth, every valid ground truth claiming its
    best eligible box: ``(best_iou [N], best_gt [N], fg [N], valid_gt
    [G])``."""
    valid_gt = (gt_boxes[:, 2] > gt_boxes[:, 0]) & \
        (gt_boxes[:, 3] > gt_boxes[:, 1])
    iou = iou_similarity(gt_boxes, boxes, box_normalized=box_normalized)
    iou = torch.where(valid_gt[:, None], iou, torch.full_like(iou, -1.0))
    if valid_boxes is not None:
        iou = torch.where(valid_boxes[None, :], iou,
                          torch.full_like(iou, -1.0))
    best_iou = iou.max(0).values
    best_gt, fg = _claim_best(iou, valid_gt, iou.argmax(0),
                              best_iou >= pos_thresh)
    return best_iou, best_gt, fg, valid_gt


def _rank_sample(mask: torch.Tensor, limit, use_random: bool,
                 gen) -> torch.Tensor:
    """At most ``limit`` of ``mask``'s entries kept, by rank of a uniform
    draw from ``gen`` (``use_random``), else in index order."""
    n = mask.shape[0]
    if use_random:
        rand = torch.rand(n, generator=gen, device=mask.device)
    else:
        rand = torch.linspace(0.0, 1.0, n, device=mask.device)
    key = torch.where(mask, rand, torch.full_like(rand, 2.0))
    rank = torch.argsort(torch.argsort(key, stable=True), stable=True)
    return mask & (rank < limit)


def _generator(key, device) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    if key is not None:
        return torch.Generator(device=device).manual_seed(int(key))
    from ..core import random as _random
    return _random.draw("random", device, lambda g: g)


def rpn_target_assign(anchors, gt_boxes, is_crowd=None, im_info=None,
                      rpn_batch_size_per_im: int = 256,
                      rpn_straddle_thresh: float = 0.0,
                      rpn_fg_fraction: float = 0.5,
                      rpn_positive_overlap: float = 0.7,
                      rpn_negative_overlap: float = 0.3,
                      use_random: bool = True,
                      box_normalized: bool = True, key=None) -> tuple:
    """RPN targets of one image: ``(loc_target [A, 4], label [A])``, label
    1 foreground, 0 background, -1 ignored; anchors straddling the image
    of ``im_info`` (h, w) ignored; at most ``rpn_batch_size_per_im``
    sampled with the foreground capped at ``rpn_fg_fraction``."""
    off = 0.0 if box_normalized else 1.0
    inside = None
    if im_info is not None:
        h, w = im_info[0], im_info[1]
        t = rpn_straddle_thresh
        inside = ((anchors[:, 0] >= -t) & (anchors[:, 1] >= -t)
                  & (anchors[:, 2] < w + t) & (anchors[:, 3] < h + t))
    best_iou, best_gt, fg, _ = _match_to_gt(
        gt_boxes, anchors, rpn_positive_overlap, box_normalized,
        valid_boxes=inside)
    bg = (best_iou < rpn_negative_overlap) & ~fg
    if inside is not None:
        fg, bg = fg & inside, bg & inside
    if is_crowd is not None:
        fg = fg & ~torch.as_tensor(is_crowd, device=fg.device)[best_gt]
    gen = _generator(key, anchors.device) if use_random else None
    fg_keep = _rank_sample(fg, int(rpn_batch_size_per_im * rpn_fg_fraction),
                           use_random, gen)
    bg_keep = _rank_sample(bg, rpn_batch_size_per_im - fg_keep.sum(),
                           use_random, gen)
    label = torch.where(fg_keep, 1, torch.where(bg_keep, 0, -1))
    return _matched_box_encode(anchors, gt_boxes[best_gt], off), label


def retinanet_target_assign(anchors, gt_boxes, gt_labels, im_info=None,
                            positive_overlap: float = 0.5,
                            negative_overlap: float = 0.4,
                            box_normalized: bool = True) -> tuple:
    """RetinaNet targets of one image: ``(loc_target [A, 4], cls_target
    [A]`` in {-1 ignore, 0 background, 1..C}, ``fg_num)``."""
    off = 0.0 if box_normalized else 1.0
    inside = None
    if im_info is not None:
        h, w = im_info[0], im_info[1]
        inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
                  & (anchors[:, 2] < w) & (anchors[:, 3] < h))
    best_iou, best_gt, fg, _ = _match_to_gt(
        gt_boxes, anchors, positive_overlap, box_normalized,
        valid_boxes=inside)
    bg = (best_iou < negative_overlap) & ~fg
    if inside is not None:
        fg, bg = fg & inside, bg & inside
    labels = torch.as_tensor(gt_labels, device=anchors.device).long()
    cls = torch.where(fg, labels[best_gt], torch.where(bg, 0, -1))
    return (_matched_box_encode(anchors, gt_boxes[best_gt], off), cls,
            fg.sum())


def sigmoid_focal_loss(logits: torch.Tensor, labels, fg_num,
                       gamma: float = 2.0,
                       alpha: float = 0.25) -> torch.Tensor:
    """Focal loss of ``logits [A, C]`` against ``labels [A]`` in {-1
    ignore, 0 background, 1..C}, over ``fg_num``."""
    c = logits.shape[1]
    lbl = torch.as_tensor(labels, device=logits.device).long()
    t = ((lbl - 1)[:, None] == torch.arange(c, device=logits.device)
         ).to(logits.dtype)
    p = torch.sigmoid(logits)
    sp = torch.nn.functional.softplus
    ce = t * sp(-logits) + (1 - t) * sp(logits)
    pt = torch.where(t > 0, p, 1 - p)
    w = torch.where(t > 0, alpha, 1 - alpha) * (1 - pt) ** gamma
    loss = torch.where((lbl >= 0)[:, None], w * ce, torch.zeros_like(ce))
    return loss.sum() / torch.clamp(torch.as_tensor(
        fg_num, device=logits.device), min=1)


def retinanet_detection_output(bboxes, scores, anchors, im_info=None,
                               score_threshold: float = 0.05,
                               nms_top_k: int = 1000, keep_top_k: int = 100,
                               nms_threshold: float = 0.3,
                               box_normalized: bool = True) -> tuple:
    """Deltas ``[A, 4]`` decoded against the anchors, clipped to
    ``im_info`` (h, w) when given, then :func:`multiclass_nms` of the
    sigmoid ``scores [A, C]``."""
    decoded = _matched_box_decode(anchors, bboxes,
                                  0.0 if box_normalized else 1.0)
    if im_info is not None:
        decoded = box_clip(decoded, (im_info[0], im_info[1]))
    return multiclass_nms(decoded, scores.T, score_threshold=score_threshold,
                          nms_threshold=nms_threshold, nms_top_k=nms_top_k,
                          keep_top_k=keep_top_k, background_label=-1)


def generate_proposal_labels(rois, gt_boxes, gt_labels,
                             batch_size_per_im: int = 128,
                             fg_fraction: float = 0.25,
                             fg_thresh: float = 0.5,
                             bg_thresh_hi: float = 0.5,
                             bg_thresh_lo: float = 0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             num_classes: int = 81,
                             use_random: bool = True,
                             box_normalized: bool = True, key=None) -> tuple:
    """Fast R-CNN sampling of one image over the ROIs and the ground
    truths joined: ``(cand [R, 4], label [R]`` in {-1 dropped, 0
    background, 1..}, ``bbox_targets [R, 4 C], bbox_inside_weights [R,
    4 C])``."""
    off = 0.0 if box_normalized else 1.0
    cand = torch.cat([rois, gt_boxes], 0)
    r = cand.shape[0]
    best_iou, best_gt, _, _ = _match_to_gt(gt_boxes, cand, fg_thresh,
                                           box_normalized)
    fg = best_iou >= fg_thresh
    bi0 = torch.clamp(best_iou, min=0.0)
    bg = (bi0 < bg_thresh_hi) & (bi0 >= bg_thresh_lo) & ~fg
    valid_cand = (cand[:, 2] > cand[:, 0]) & (cand[:, 3] > cand[:, 1])
    fg, bg = fg & valid_cand, bg & valid_cand
    gen = _generator(key, cand.device) if use_random else None
    fg_keep = _rank_sample(fg, int(batch_size_per_im * fg_fraction),
                           use_random, gen)
    bg_keep = _rank_sample(bg, batch_size_per_im - fg_keep.sum(),
                           use_random, gen)
    labels = torch.as_tensor(gt_labels, device=cand.device).long()
    label = torch.where(fg_keep, labels[best_gt],
                        torch.where(bg_keep, 0, -1))
    tgt = _matched_box_encode(cand, gt_boxes[best_gt], off,
                              weights=bbox_reg_weights)
    slot = ((label[:, None] == torch.arange(num_classes, device=cand.device))
            & (label > 0)[:, None]).to(cand.dtype)
    expanded = (slot[:, :, None] * tgt[:, None, :]).reshape(
        r, 4 * num_classes)
    return cand, label, expanded, slot.repeat_interleave(4, 1)


def generate_mask_labels(rois, roi_labels, gt_segms_mask, gt_boxes,
                         resolution: int = 14) -> tuple:
    """Mask R-CNN targets: each ROI's best ground truth's mask ``[G, H,
    W]`` sampled at the ROI's ``resolution`` squared cell centres
    (truncated to pixels) and thresholded at 0.5; ``(mask_target [R,
    res, res], mask_weight [R])``, weight 1 for foreground ROIs."""
    masks = torch.as_tensor(gt_segms_mask)
    valid_gt = (gt_boxes[:, 2] > gt_boxes[:, 0]) & \
        (gt_boxes[:, 3] > gt_boxes[:, 1])
    iou = iou_similarity(gt_boxes, rois)
    iou = torch.where(valid_gt[:, None], iou, torch.full_like(iou, -1.0))
    best_gt = iou.argmax(0)
    h, w = masks.shape[1:]
    frac = (torch.arange(resolution, device=rois.device) + 0.5) / resolution
    ys = rois[:, 1:2] + (rois[:, 3:4] - rois[:, 1:2]) * frac
    xs = rois[:, 0:1] + (rois[:, 2:3] - rois[:, 0:1]) * frac
    yi = torch.clamp(ys.to(torch.int32), 0, h - 1).long()
    xi = torch.clamp(xs.to(torch.int32), 0, w - 1).long()
    m = masks.to(torch.float32)[best_gt[:, None, None], yi[:, :, None],
                                xi[:, None, :]]
    weight = (torch.as_tensor(roi_labels, device=rois.device) > 0).to(
        torch.float32)
    return (m > 0.5).to(torch.float32), weight
