"""Numpy postprocess of the CPU reference — copy of
``tpu_pillars/reference_cpu/postprocess.py``: decode, score filter and
greedy rotated NMS, the reference's host-side tier and the oracle of the
port's device postprocess; and the float64 rotated BEV IoU by
Sutherland-Hodgman clipping that the evaluation scores with
(``evaluation/map_eval.py``) and the weighted-box-fusion merge of
``evaluation/tta.py`` clusters with.

Shared postprocess spec (both pipelines implement exactly this):
  1. Each anchor scores ONLY its own class: s_a = sigmoid(logits[a, cls_a]).
  2. Anchors below their class's score_threshold are dropped.
  3. The top `pre_nms_top_k` survivors by score enter NMS.
  4. Box deltas decode against anchors; the 2-way direction head flips yaw by
     pi when sign(yaw_pred) disagrees with the predicted direction class
     (SECOND convention: dir class = [yaw > 0]); yaw wraps to [-pi, pi).
  5. Greedy class-aware rotated BEV NMS at `nms_iou_threshold`, at most
     `max_detections` survivors.
"""

from __future__ import annotations

import numpy as np

from tpu_pillars_torch.config import PillarsConfig
from tpu_pillars_torch.geometry.boxes import box_corners_bev


def decode_boxes_np(deltas, anchors):
    """NumPy mirror of ops.box_coder.decode_boxes."""
    deltas = np.asarray(deltas, dtype=np.float32)
    anchors = np.asarray(anchors, dtype=np.float32)
    xa, ya, za = anchors[..., 0], anchors[..., 1], anchors[..., 2]
    wa, la, ha, ta = anchors[..., 3], anchors[..., 4], anchors[..., 5], anchors[..., 6]
    d = np.sqrt(wa * wa + la * la)
    out = np.empty_like(deltas)
    out[..., 0] = deltas[..., 0] * d + xa
    out[..., 1] = deltas[..., 1] * d + ya
    out[..., 2] = deltas[..., 2] * ha + za
    out[..., 3] = np.exp(deltas[..., 3]) * wa
    out[..., 4] = np.exp(deltas[..., 4]) * la
    out[..., 5] = np.exp(deltas[..., 5]) * ha
    out[..., 6] = deltas[..., 6] + ta
    return out


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


def rotated_nms_np(boxes, scores, iou_threshold: float, max_out: int):
    """Greedy rotated BEV NMS. boxes (n, 7), scores (n,) -> kept indices
    (descending score order, at most max_out)."""
    order = np.argsort(-scores, kind="stable")
    boxes = np.asarray(boxes)
    kept: list[int] = []
    for i in order:
        ok = True
        for j in kept:
            if rotated_iou_bev_np(boxes[i : i + 1], boxes[j : j + 1])[0, 0] > iou_threshold:
                ok = False
                break
        if ok:
            kept.append(int(i))
            if len(kept) >= max_out:
                break
    return np.array(kept, dtype=np.int64)


def wrap_angle(a):
    """Wrap to [-pi, pi)."""
    return (a + np.pi) % (2 * np.pi) - np.pi


def postprocess_np(cls_logits, box_deltas, dir_logits, anchors, anchor_cls,
                   config: PillarsConfig):
    """Full host postprocess per the shared spec.

    Returns (boxes (n, 7), scores (n,), class_ids (n,)) with n <= max_detections.
    """
    cls_logits = np.asarray(cls_logits, dtype=np.float32)
    A = cls_logits.shape[0]
    own = cls_logits[np.arange(A), anchor_cls]
    scores = 1.0 / (1.0 + np.exp(-own))

    thresholds = np.array([c.score_threshold for c in config.classes],
                          dtype=np.float32)[anchor_cls]
    candidate = scores >= thresholds
    if not candidate.any():
        return (np.zeros((0, 7), np.float32), np.zeros((0,), np.float32),
                np.zeros((0,), np.int64))

    cand_idx = np.nonzero(candidate)[0]
    top = cand_idx[np.argsort(-scores[cand_idx], kind="stable")][: config.pre_nms_top_k]

    boxes = decode_boxes_np(box_deltas[top], anchors[top])
    dir_cls = np.argmax(np.asarray(dir_logits)[top], axis=-1)
    flip = (boxes[:, 6] > 0).astype(np.int64) != dir_cls
    boxes[:, 6] = wrap_angle(boxes[:, 6] + np.where(flip, np.pi, 0.0))

    # class-aware NMS: shift each class to its own far-apart BEV region
    cls_of = np.asarray(anchor_cls)[top]
    shifted = boxes.copy()
    span = (config.x_max - config.x_min) + (config.y_max - config.y_min)
    shifted[:, 0] += cls_of * 4.0 * span
    keep = rotated_nms_np(shifted, scores[top], config.nms_iou_threshold,
                          config.max_detections)
    sel = top[keep]
    return boxes[keep], scores[sel], cls_of[keep].astype(np.int64)
