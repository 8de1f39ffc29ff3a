"""Float64 rotated BEV IoU by Sutherland-Hodgman clipping, numpy — copy of
the IoU part of ``tpu_pillars/reference_cpu/postprocess.py``
(``_clip_poly``, ``_poly_area``, ``rotated_iou_bev_np``). Evaluation scores
with it (``evaluation/map_eval.py``) and the weighted-box-fusion merge of
``evaluation/tta.py`` clusters with it.
"""

from __future__ import annotations

import numpy as np

from tpu_pillars_torch.geometry.boxes import box_corners_bev


# ---------- rotated IoU via Sutherland–Hodgman clipping (float64) ----------

def _clip_poly(subject: np.ndarray, clipper: np.ndarray) -> np.ndarray:
    """Clip polygon `subject` (k, 2) by convex CCW `clipper` (m, 2)."""
    out = subject
    m = len(clipper)
    for i in range(m):
        if len(out) == 0:
            break
        a, b = clipper[i], clipper[(i + 1) % m]
        ex, ey = b[0] - a[0], b[1] - a[1]
        inp = out
        side = ex * (inp[:, 1] - a[1]) - ey * (inp[:, 0] - a[0])
        inside = side >= -1e-12
        pieces = []
        k = len(inp)
        for j in range(k):
            cur, nxt = inp[j], inp[(j + 1) % k]
            if inside[j]:
                pieces.append(cur)
            if inside[j] != inside[(j + 1) % k]:
                r = nxt - cur
                s = b - a
                denom = r[0] * s[1] - r[1] * s[0]
                t = ((a[0] - cur[0]) * s[1] - (a[1] - cur[1]) * s[0]) / denom
                pieces.append(cur + t * r)
        out = np.array(pieces) if pieces else np.zeros((0, 2))
    return out


def _poly_area(poly: np.ndarray) -> float:
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def rotated_iou_bev_np(boxes1, boxes2):
    """Exact rotated BEV IoU, float64 S-H clipping. (N, 7), (M, 7) -> (N, M)."""
    boxes1 = np.asarray(boxes1, dtype=np.float64)
    boxes2 = np.asarray(boxes2, dtype=np.float64)
    c1 = box_corners_bev(boxes1)
    c2 = box_corners_bev(boxes2)
    out = np.zeros((len(boxes1), len(boxes2)))
    for i in range(len(boxes1)):
        for j in range(len(boxes2)):
            inter = _poly_area(_clip_poly(c1[i], c2[j]))
            a1 = boxes1[i, 3] * boxes1[i, 4]
            a2 = boxes2[j, 3] * boxes2[j, 4]
            inter = min(inter, a1, a2)
            out[i, j] = inter / max(a1 + a2 - inter, 1e-12)
    return out
