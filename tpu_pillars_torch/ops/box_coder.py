"""Box residual encode/decode vs anchors — port of
``tpu_pillars/ops/box_coder.py`` (PointPillars/SECOND parameterization).

Residuals are normalized by the anchor BEV diagonal d = sqrt(w_a^2 + l_a^2):
    tx = (x - x_a) / d        tw = log(w / w_a)
    ty = (y - y_a) / d        tl = log(l / l_a)
    tz = (z - z_a) / h_a      th = log(h / h_a)
    tt = yaw - yaw_a
"""

from __future__ import annotations

import torch


def encode_boxes(boxes, anchors):
    """boxes, anchors: (..., 7) [x,y,z,w,l,h,yaw] -> residuals (..., 7)."""
    x, y, z, w, l, h, t = boxes.unbind(-1)
    xa, ya, za, wa, la, ha, ta = anchors.unbind(-1)
    d = torch.sqrt(wa * wa + la * la)
    return torch.stack([(x - xa) / d, (y - ya) / d, (z - za) / ha,
                        torch.log(w / wa), torch.log(l / la),
                        torch.log(h / ha), t - ta], dim=-1)


def decode_boxes(deltas, anchors):
    """Inverse of :func:`encode_boxes`. (..., 7) -> (..., 7)."""
    tx, ty, tz, tw, tl, th, tt = deltas.unbind(-1)
    xa, ya, za, wa, la, ha, ta = anchors.unbind(-1)
    d = torch.sqrt(wa * wa + la * la)
    return torch.stack([tx * d + xa, ty * d + ya, tz * ha + za,
                        torch.exp(tw) * wa, torch.exp(tl) * la,
                        torch.exp(th) * ha, tt + ta], dim=-1)
