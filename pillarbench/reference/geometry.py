"""Anchors, box decoding and BEV corners in numpy: the detector's
published conventions (PointPillars / SECOND box coding), written out for
the reference."""

from __future__ import annotations

import numpy as np


def make_anchors(cfg):
    """(anchors (A, 7) f32 [x, y, z, w, l, h, yaw], classes (A,) int64),
    flattened (row, col, class * yaws + yaw) at the head's stride."""
    H, W = cfg.feature_h, cfg.feature_w
    sx, sy = cfg.voxel_x * cfg.head_stride, cfg.voxel_y * cfg.head_stride
    xs = cfg.x_min + (np.arange(W) + 0.5) * sx
    ys = cfg.y_min + (np.arange(H) + 0.5) * sy
    a_loc = cfg.anchors_per_loc
    tpl = np.zeros((a_loc, 5), np.float32)
    cls = np.zeros((a_loc,), np.int64)
    for ci, spec in enumerate(cfg.classes):
        for yi, yaw in enumerate(cfg.anchor_yaws):
            a = ci * len(cfg.anchor_yaws) + yi
            tpl[a] = [spec.width, spec.length, spec.height, spec.z_center, yaw]
            cls[a] = ci
    gx = np.broadcast_to(xs[None, :, None], (H, W, a_loc))
    gy = np.broadcast_to(ys[:, None, None], (H, W, a_loc))
    t = np.broadcast_to(tpl[None, None], (H, W, a_loc, 5))
    anchors = np.stack([gx, gy, t[..., 3], t[..., 0], t[..., 1], t[..., 2],
                        t[..., 4]], axis=-1).reshape(-1, 7).astype(np.float32)
    return anchors, np.broadcast_to(cls, (H, W, a_loc)).reshape(-1).copy()


def decode_boxes(deltas, anchors):
    """Residuals against anchors -> boxes, f32 (x, y by the anchor's BEV
    diagonal, z by its height, sizes by log ratio, yaw by difference)."""
    deltas = np.asarray(deltas, np.float32)
    anchors = np.asarray(anchors, np.float32)
    xa, ya, za = anchors[..., 0], anchors[..., 1], anchors[..., 2]
    wa, la, ha, ta = (anchors[..., 3], anchors[..., 4], anchors[..., 5],
                      anchors[..., 6])
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


def wrap_angle(a):
    """Wrap to [-pi, pi)."""
    return (a + np.pi) % (2 * np.pi) - np.pi


def box_corners_bev(boxes) -> np.ndarray:
    """(N, >=7) -> (N, 4, 2) BEV corners in float64, counter-clockwise from
    the front-left (local (+l/2, +w/2))."""
    boxes = np.asarray(boxes, np.float64)
    x, y = boxes[:, 0], boxes[:, 1]
    w, l, yaw = boxes[:, 3], boxes[:, 4], boxes[:, 6]
    lx = np.stack([l / 2, -l / 2, -l / 2, l / 2], axis=-1)
    ly = np.stack([w / 2, w / 2, -w / 2, -w / 2], axis=-1)
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    return np.stack([x[:, None] + c * lx - s * ly,
                     y[:, None] + s * lx + c * ly], axis=-1)


def _clip_poly(subject, clipper):
    """Sutherland-Hodgman: clip polygon ``subject`` by the convex CCW
    ``clipper``."""
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


def _poly_area(poly) -> float:
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def iou_bev_pair(box_a, box_b, corners_a, corners_b) -> float:
    """Exact rotated BEV IoU of two boxes, float64 polygon clipping."""
    inter = _poly_area(_clip_poly(corners_a, corners_b))
    a1 = float(box_a[3]) * float(box_a[4])
    a2 = float(box_b[3]) * float(box_b[4])
    inter = min(inter, a1, a2)
    return inter / max(a1 + a2 - inter, 1e-12)
