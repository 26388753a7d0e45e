"""The fluid ``layers`` namespace of the PyTorch package.

Counterpart of ``paddle_tpu.layers``; for now its ``detection_output``
alone (``models.SSDLite.predict`` runs it). The rest of the JAX shim is
still to port (``ROADMAP.md`` A17).
"""

from __future__ import annotations

import torch

from ..ops import detection as _det

__all__ = ["detection_output"]


def detection_output(loc: torch.Tensor, scores: torch.Tensor,
                     prior_box: torch.Tensor, prior_box_var=None,
                     background_label: int = 0, nms_threshold: float = 0.3,
                     nms_top_k: int = 400, keep_top_k: int = 200,
                     score_threshold: float = 0.01,
                     nms_eta: float = 1.0) -> list:
    """The SSD inference head: each prior's offsets ``loc [B, P, 4]``
    decoded against it (centre-size, ``prior_box_var`` scaling them),
    then ``multiclass_nms`` of ``scores [B, P, C]``. Returns one ``(out
    [keep_top_k, 6], valid)`` per image, as the JAX layer; the images'
    NMS loops run as one batched loop."""
    pw = prior_box[:, 2] - prior_box[:, 0]
    ph = prior_box[:, 3] - prior_box[:, 1]
    pcx = prior_box[:, 0] + 0.5 * pw
    pcy = prior_box[:, 1] + 0.5 * ph
    var = prior_box_var if prior_box_var is not None \
        else torch.ones(4, dtype=loc.dtype, device=loc.device)
    d = loc * var
    cx = d[..., 0] * pw + pcx
    cy = d[..., 1] * ph + pcy
    w = torch.exp(d[..., 2]) * pw
    h = torch.exp(d[..., 3]) * ph
    dec = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    out, valid = _det._multiclass_nms(
        dec.to(torch.float32), scores.transpose(1, 2), score_threshold,
        nms_threshold, keep_top_k, nms_top_k, background_label)
    return [(out[i], valid[i]) for i in range(out.shape[0])]
